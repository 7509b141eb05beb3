"""Official HotpotQA evaluation metrics.

Re-implementation of mdr/qa/hotpot_evaluate_v1.py (itself the official
HotpotQA eval script): answer EM/F1 with the standard normalization
(lowercase, strip punctuation/articles/whitespace), supporting-fact EM/F1
over (title, sent_idx) pairs, and joint metrics (products of precisions/
recalls, hotpot_evaluate_v1.py:88-131).

A copy of the JAX package's ``eval/hotpot_metrics.py``.
"""

from __future__ import annotations

import collections
import re
import string
from typing import Dict, Iterable, List, Tuple


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def f1_score(prediction: str, ground_truth: str) -> Tuple[float, float, float]:
    """Returns (f1, precision, recall) on normalized token bags.

    yes/no/noanswer predictions only match exactly (hotpot_evaluate_v1.py:35-40).
    """
    norm_pred = normalize_answer(prediction)
    norm_gold = normalize_answer(ground_truth)
    zero = (0.0, 0.0, 0.0)
    special = ("yes", "no", "noanswer")
    if norm_pred in special or norm_gold in special:
        if norm_pred != norm_gold:
            return zero
    pred_toks = norm_pred.split()
    gold_toks = norm_gold.split()
    common = collections.Counter(pred_toks) & collections.Counter(gold_toks)
    num_same = sum(common.values())
    if num_same == 0:
        return zero
    precision = num_same / len(pred_toks)
    recall = num_same / len(gold_toks)
    f1 = 2 * precision * recall / (precision + recall)
    return f1, precision, recall


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def update_answer(metrics: Dict, prediction: str, gold: str) -> Tuple[float, float, float]:
    em = float(exact_match_score(prediction, gold))
    f1, prec, recall = f1_score(prediction, gold)
    metrics["em"] += em
    metrics["f1"] += f1
    metrics["prec"] += prec
    metrics["recall"] += recall
    return em, prec, recall


def update_sp(metrics: Dict, prediction: Iterable[Tuple[str, int]],
              gold: Iterable[Tuple[str, int]]) -> Tuple[float, float, float]:
    """Supporting-fact metrics over (title, sentence_idx) pairs
    (hotpot_evaluate_v1.py:66-86)."""
    cur_sp_pred = set(map(tuple, prediction))
    gold_sp_pred = set(map(tuple, gold))
    tp, fp, fn = 0, 0, 0
    for e in cur_sp_pred:
        if e in gold_sp_pred:
            tp += 1
        else:
            fp += 1
    for e in gold_sp_pred:
        if e not in cur_sp_pred:
            fn += 1
    # official script: empty prediction / empty gold yield 0.0, not 1.0
    # (hotpot_evaluate_v1.py:78-79)
    prec = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 0.0 if prec + recall == 0 else 2 * prec * recall / (prec + recall)
    em = 1.0 if fp + fn == 0 else 0.0
    metrics["sp_em"] += em
    metrics["sp_f1"] += f1
    metrics["sp_prec"] += prec
    metrics["sp_recall"] += recall
    return em, prec, recall


def joint_metrics(metrics: Dict, ans_em, ans_prec, ans_recall,
                  sp_em, sp_prec, sp_recall):
    """Joint EM/F1 = products (hotpot_evaluate_v1.py:112-126)."""
    joint_prec = ans_prec * sp_prec
    joint_recall = ans_recall * sp_recall
    if joint_prec + joint_recall > 0:
        joint_f1 = 2 * joint_prec * joint_recall / (joint_prec + joint_recall)
    else:
        joint_f1 = 0.0
    joint_em = ans_em * sp_em
    metrics["joint_em"] += joint_em
    metrics["joint_f1"] += joint_f1
    metrics["joint_prec"] += joint_prec
    metrics["joint_recall"] += joint_recall


def new_metrics() -> Dict[str, float]:
    return {k: 0.0 for k in
            ["em", "f1", "prec", "recall",
             "sp_em", "sp_f1", "sp_prec", "sp_recall",
             "joint_em", "joint_f1", "joint_prec", "joint_recall"]}
