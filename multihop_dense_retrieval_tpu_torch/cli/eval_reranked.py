"""CLI: offline evaluation of saved reader predictions.

Equivalent of scripts/eval/eval_reranked.py: scores a predictions JSONL
(as written by cli/end2end.py --save-path: {"_id", "pred_answer", "pred_sp"})
against gold annotations, reporting answer EM/F1, SP EM/F1, joint EM/F1
overall and per question type.

The port of the JAX package's ``cli/eval_reranked.py`` (host only).

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.eval_reranked \
      predictions.jsonl gold.jsonl
"""

import argparse
import collections
import json

import numpy as np

from ..eval.hotpot_metrics import (update_answer, update_sp,
                                   joint_metrics, new_metrics)
from . import common

SP_KEYS = ("sp_em", "sp_f1", "sp_prec", "sp_recall",
           "joint_em", "joint_f1", "joint_prec", "joint_recall")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("predictions", help="JSONL: _id, pred_answer[, pred_sp]")
    p.add_argument("gold", help="JSONL: _id, answer[, sp_gold/sp, type]")
    args = p.parse_args(argv)
    logger = common.setup_logging()

    with open(args.predictions) as f:
        preds = {r["_id"]: r for r in (json.loads(l) for l in f
                                       if l.strip())}
    with open(args.gold) as f:
        golds = [json.loads(l) for l in f if l.strip()]

    by_type = collections.defaultdict(list)
    for g in golds:
        qid = g["_id"]
        if qid not in preds:
            continue
        pr = preds[qid]
        gold_ans = g.get("answer", [])
        if isinstance(gold_ans, str):
            # raw gold files store a bare string; [0] would silently score
            # every prediction against its first CHARACTER
            gold_ans = [gold_ans]
        gold_ans = gold_ans[0] if gold_ans else ""
        m = new_metrics()
        em, prec, rec = update_answer(m, pr.get("pred_answer", ""), gold_ans)
        gold_sp = g.get("sp_gold")
        if gold_sp is None and "sp" in g and g["sp"] and \
                isinstance(g["sp"][0], dict):
            gold_sp = [[s["title"], i] for s in g["sp"]
                       for i in s.get("sp_sent_ids", [])]
        # rows WITHOUT sentence-level sp gold are excluded from the
        # sp/joint averages instead of contributing zeros that read as
        # "the reader predicted no supporting facts"
        m["_has_sp"] = gold_sp is not None
        if gold_sp is not None:
            sp_em, sp_prec, sp_rec = update_sp(
                m, pr.get("pred_sp", []), gold_sp)
            joint_metrics(m, em, prec, rec, sp_em, sp_prec, sp_rec)
        by_type[g.get("type", "all")].append(m)

    if not by_type:
        raise ValueError(
            f"no gold _id appears in {args.predictions} — wrong file "
            "pair, disjoint split, or mismatched id types?")

    def agg(items):
        out = {k: float(np.mean([m[k] for m in items]))
               for k in items[0] if k not in SP_KEYS and k != "_has_sp"}
        with_sp = [m for m in items if m["_has_sp"]]
        if with_sp:
            out.update({k: float(np.mean([m[k] for m in with_sp]))
                        for k in SP_KEYS})
            out["n_sp_annotated"] = len(with_sp)
        return out

    out = {"overall": agg([m for items in by_type.values() for m in items])}
    for t, items in by_type.items():
        out[t] = agg(items)
        out[t]["n"] = len(items)
    for scope, vals in out.items():
        logger.info("[%s] %s", scope,
                    {k: round(v, 4) for k, v in vals.items()
                     if k in ("em", "f1", "sp_em", "sp_f1", "joint_em",
                              "joint_f1", "n")})
    print(json.dumps(out["overall"]))
    return out


if __name__ == "__main__":
    main()
