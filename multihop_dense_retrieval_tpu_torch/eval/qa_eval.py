"""Reader prediction + HotpotQA scoring with the λ rank/span combination.

The port of the JAX package's ``eval/qa_eval.py``: per-question chains are
scored by the predict step (train/qa.py), answers decoded from offset
maps, chains re-ranked by λ·rank_score + (1-λ)·span_score with λ swept on
dev (or fixed 0.8 for serving).  Batches are length-sorted and cut to
their longest row rounded up to a multiple of 64, and the two-stage read
(rank_filter) keeps the top-m chains per question, as in the JAX package.
The steps take the collated numpy inputs and return tensors; results come
back to the host once per batch.

``predict``'s steps are spans of ``utils/profiling.py``: ``read`` (the
call), ``read_featurize`` (each item, ``data/qa_dataset.py``),
``read_collate`` (a batch's collate and width trim), ``read_step`` (the
step's copies in and launches), ``read_fetch`` (its results to the host),
``read_decode`` (answers and supporting facts) and ``read_rank`` (chain EM
and the λ sweep).  With a recorder on, each batch counts
``read.tokens_real`` (its real rows' tokens) and ``read.tokens_run``
(batch × width, pad rows included).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.qa_dataset import QADataset, qa_collate, decode_answer
from ..utils.profiling import count, recording, span
from .hotpot_metrics import (update_answer, update_sp,
                             joint_metrics, new_metrics)


def _row_len_proxy(row: Dict) -> int:
    """Cheap (character-level) length estimate for length-sorted batching."""
    n = len(row.get("question", ""))
    for p in row.get("passages", []):
        for s in p.get("sents", [p.get("text", "")]):
            n += len(s)
    return n


def _truncate_width(ni: Dict, w: int):
    """Drop token columns past `w` on every width-dependent net input
    (shared by the batch width-bucketing and the rank pass)."""
    if w < ni["input_ids"].shape[1]:
        for k in ("input_ids", "attention_mask", "token_type_ids",
                  "paragraph_mask"):
            if k in ni:
                ni[k] = ni[k][:, :w]


def _batches(dataset: QADataset, batch_size: int, *,
             length_sort: bool = False, width_multiple: int = 0):
    idxs = list(range(len(dataset)))
    if length_sort:
        # homogeneous-length batches: with width bucketing below, short
        # chains stop paying for the 512-token static pad
        idxs.sort(key=lambda i: _row_len_proxy(dataset.data[i]))
    for s in range(0, len(idxs), batch_size):
        chunk = idxs[s:s + batch_size]
        pad = batch_size - len(chunk)
        samples = [dataset[i] for i in chunk + chunk[-1:] * pad]
        with span("read_collate"):
            batch = qa_collate(samples)
            ni = batch["net_inputs"]
            if width_multiple:
                max_len = int(ni["attention_mask"].sum(1).max())
                _truncate_width(ni, max(width_multiple,
                                        -(-max_len // width_multiple)
                                        * width_multiple))
        if recording():
            mask = ni["attention_mask"]
            count("read.tokens_real", int(mask[:len(chunk)].sum()))
            count("read.tokens_run", mask.size)
        yield batch, len(chunk)


class _Subset:
    """Index-mapped view of a QADataset (two-stage read keep-list): exposes
    the same .data / __getitem__ surface `_batches` consumes.  `cache`
    holds samples already featurized by rank_filter so the kept rows are
    not tokenized/offset-mapped a second time."""

    def __init__(self, parent, indices: List[int],
                 cache: Optional[Dict[int, Dict]] = None):
        self._parent = parent
        self._indices = indices
        self._cache = cache or {}
        self.data = [parent.data[i] for i in indices]

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i: int):
        j = self._indices[i]
        hit = self._cache.get(j)
        return hit if hit is not None else self._parent[j]


def _host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    with span("read_fetch"):
        return {k: v.cpu().numpy() for k, v in out.items()}


def rank_filter(rank_step: Callable, dataset: QADataset, *,
                batch_size: int = 16, topm: int = 5,
                rank_width: Optional[int] = 128,
                width_multiple: int = 64):
    """Stage 1 of the two-stage read: score EVERY chain with the rank head
    at a narrow width, keep the top-m rows per question.  Gold-labeled rows
    compete like any other — the filter is a serving-path accelerator, not
    an oracle.

    The pass is LENGTH-BUCKETED like the full read (batches are length-
    sorted; each batch's width is its max true length rounded up to
    ``width_multiple``), so a chain whose batch width covers it is scored
    WITHOUT truncation — equal to ranking it at full width up to ~1-ulp
    float-rounding of width-dependent reduction orders (pads are masked
    out of attention).  ``rank_width`` caps the batch width: with the cap,
    the set of truncated chains is identical to the old fixed-width pass
    (only chains longer than the cap) at strictly lower cost; with
    ``rank_width=None`` no chain is ever truncated and the kept set equals
    a full-width rank pass's — fidelity-neutral by construction.

    Returns (kept dataset indices, {index: featurized sample} for the kept
    rows) — the samples were already built for the rank pass; memory stays
    bounded at topm per question via the streaming heaps."""
    import heapq

    best = collections.defaultdict(list)   # qid -> min-heap of (score, i)
    cache: Dict[int, Dict] = {}
    idxs = sorted(range(len(dataset)),
                  key=lambda i: _row_len_proxy(dataset.data[i]))
    for s in range(0, len(idxs), batch_size):
        chunk = idxs[s:s + batch_size]
        pad = batch_size - len(chunk)
        samples = [dataset[i] for i in chunk]
        batch = qa_collate(samples + samples[-1:] * pad)
        ni = batch["net_inputs"]
        max_len = int(ni["attention_mask"].sum(1).max())
        w = max(width_multiple, -(-max_len // width_multiple) * width_multiple)
        if rank_width:
            w = min(w, rank_width)
        _truncate_width(ni, w)
        ranks = rank_step(ni).cpu().numpy()
        for j, i in enumerate(chunk):
            heap = best[dataset.data[i]["qid"]]
            heapq.heappush(heap, (float(ranks[j]), i))
            cache[i] = samples[j]
            if len(heap) > topm:
                _, drop = heapq.heappop(heap)
                del cache[drop]
    keep = sorted(i for heap in best.values() for _, i in heap)
    return keep, cache


def predict(predict_step: Callable, dataset: QADataset, *,
            batch_size: int = 16, sp_pred: bool = True,
            lambdas: Optional[List[float]] = None,
            length_sort: bool = True, width_multiple: int = 64,
            rank_step: Optional[Callable] = None, rank_topm: int = 0,
            rank_width: Optional[int] = 128) -> Dict:
    """Returns {"chain_em", "best": {...}, "per_lambda": {...}, "answers": ...}.

    length_sort + width_multiple: chains are batched by length and each
    batch's width is the batch max rounded up — exact results (pads are
    masked out of attention; ELECTRA positions are width-independent), and
    short chains stop paying for the 512 pad.

    rank_topm > 0 (with rank_step from train/qa.py::make_qa_rank_step)
    enables the TWO-STAGE read: all chains pay only a narrow rank-head pass,
    and the full-width span/sp pass runs on the top-m chains per question.
    The reference reads every chain fully (scripts/train_qa.py:380-481);
    this trades an approximate pre-rank for most of the reader FLOPs —
    validated by rank-score correlation + chain-EM neutrality tests.
    The rank pass is length-bucketed (see rank_filter): rank_width caps the
    per-batch width (None = never truncate — exact w.r.t. a full-width
    rank pass).
    """
    with span("read"):
        if rank_topm and rank_step is not None:
            keep, cache = rank_filter(rank_step, dataset,
                                      batch_size=batch_size, topm=rank_topm,
                                      rank_width=rank_width)
            dataset = _Subset(dataset, keep, cache)
        chains = _Chains()
        for batch, n_real in _batches(dataset, batch_size,
                                      length_sort=length_sort,
                                      width_multiple=width_multiple):
            with span("read_step"):
                out = predict_step(batch["net_inputs"])
            out = _host(out)
            with span("read_decode"):
                chains.decode(batch, out, n_real, sp_pred)
        with span("read_rank"):
            return chains.rank(lambdas, sp_pred)


class _Chains:
    """Per question: each chain's label and rank score, its decoded
    answer, span score and supporting facts, and the gold answer and
    facts."""

    def __init__(self):
        self.id2result = collections.defaultdict(list)
        self.id2answer = collections.defaultdict(list)
        self.id2gold, self.id2goldsp = {}, {}

    def decode(self, batch: Dict, out: Dict[str, np.ndarray], n_real: int,
               sp_pred: bool) -> None:
        id2result, id2answer = self.id2result, self.id2answer
        id2gold, id2goldsp = self.id2gold, self.id2goldsp
        for i in range(n_real):
            qid = batch["qid"][i]
            label = int(batch["net_inputs"]["label"][i])
            rank = float(out["rank_score"][i])
            id2result[qid].append((label, rank))
            id2gold[qid] = batch["gold_answer"][i]
            id2goldsp[qid] = batch["sp_gold"][i]

            off = batch["para_offset"][i]
            start = int(out["start_pos"][i]) - off
            end = int(out["end_pos"][i]) - off
            pred_str = decode_answer(batch["wp_tokens"][i],
                                     batch["doc_tokens"][i],
                                     batch["tok_to_orig_index"][i], start, end)
            # positions 0/1 of the context are the literal words yes/no
            if start == 0:
                pred_str = "yes"
            elif start == 1:
                pred_str = "no"

            pred_sp = []
            if sp_pred and "sp_prob" in out:
                probs = out["sp_prob"][i]
                passages = batch["passages"][i]
                si = 0
                for passage in passages:
                    for local_idx in range(len(passage.get("sents", []))):
                        if si < len(probs) and probs[si] >= 0.5:
                            pred_sp.append([passage["title"], local_idx])
                        si += 1
            id2answer[qid].append({
                "pred_str": pred_str.strip(),
                "rank_score": rank,
                "span_score": float(out["span_score"][i]),
                "pred_sp": pred_sp,
            })

    def rank(self, lambdas: Optional[List[float]], sp_pred: bool) -> Dict:
        id2result, id2answer = self.id2result, self.id2answer
        id2gold, id2goldsp = self.id2gold, self.id2goldsp
        # chain ranking EM (train_qa.py:305-310)
        chain_acc = []
        for qid, res in id2result.items():
            res.sort(key=lambda x: x[1], reverse=True)
            chain_acc.append(res[0][0] == 1)
        chain_em = float(np.mean(chain_acc)) if chain_acc else 0.0

        lambdas = lambdas or [i / 10 for i in range(11)]
        per_lambda, sweep = {}, []
        for lam in lambdas:
            m = new_metrics()
            n = len(id2result)
            answers, sps = {}, {}
            for qid in id2result:
                cands = sorted(id2answer[qid],
                               key=lambda x: lam * x["rank_score"]
                               + (1 - lam) * x["span_score"], reverse=True)
                top = cands[0]
                answers[qid], sps[qid] = top["pred_str"], top["pred_sp"]
                gold = id2gold[qid][0] if id2gold[qid] else ""
                em, prec, rec = update_answer(m, top["pred_str"], gold)
                sp_em, sp_prec, sp_rec = update_sp(m, top["pred_sp"],
                                                   id2goldsp[qid])
                joint_metrics(m, em, prec, rec, sp_em, sp_prec, sp_rec)
            stats = {k: v / max(n, 1) for k, v in m.items()}
            stats["lambda"] = lam
            per_lambda[lam] = stats
            sweep.append((stats, answers, sps))
        # select by joint F1 when sp scores exist (train_qa.py:350-361
        # --final-metric joint_f1).  Without an sp head — OR when the eval
        # rows simply carry no sp gold, which also pins joint_f1 at 0 for
        # every lambda — fall back to answer F1 instead of silently keeping
        # lambdas[0].  The chosen metric is reported so callers (best-ckpt
        # selection in cli/train_qa.py) track the same signal.
        metric = ("joint_f1" if sp_pred
                  and any(s["joint_f1"] > 0 for s, _, _ in sweep) else "f1")
        stats, answers, sps = max(sweep, key=lambda t: t[0][metric])
        best = dict(stats, selection_metric=metric, answers=answers, sp=sps)
        return {"chain_em": chain_em, "best": best, "per_lambda": per_lambda,
                "n_questions": len(id2result)}
