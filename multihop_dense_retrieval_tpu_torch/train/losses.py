"""Contrastive losses and in-batch eval for retriever training (the JAX
package's ``train/losses.py``): plain functions over the encoder-output
dict, with all score math in fp32.

Score construction, for batch size B:

  all_ctx       = concat([c1; c2])                          (2B, h)
  hop-1 scores  = q     · all_ctxᵀ                          (B, 2B)
                  with column B+i masked to NEG_INF for row i (its own c2
                  is not a valid hop-1 target)
  hop-2 scores  = q_sp1 · all_ctxᵀ                          (B, 2B), unmasked
  both get per-sample hard-negative columns [q·neg1, q·neg2] appended,
  and, in the momentum stage, q·queueᵀ (the queue carries no gradient)
  targets: hop-1 → i (own c1), hop-2 → B+i (own c2)
  loss = CE(hop1) + CE(hop2)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

NEG_INF = -1e30

Outputs = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  reduction: str = "mean") -> torch.Tensor:
    """CE over rows of ``logits`` (fp32)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[:, None])[:, 0]
    nll = logz - gold
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def _mhop_scores(outputs: Outputs, queue: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """(scores_1, scores_2, target_1, target_2)."""
    q = outputs["q"].float()
    q_sp1 = outputs["q_sp1"].float()
    c1 = outputs["c1"].float()
    c2 = outputs["c2"].float()
    neg1 = outputs["neg_1"].float()
    neg2 = outputs["neg_2"].float()

    B = q.shape[0]
    all_ctx = torch.cat([c1, c2], dim=0)                      # (2B, h)
    neg_ctx = torch.stack([neg1, neg2], dim=1)                # (B, 2, h)

    s1 = q @ all_ctx.t()                                      # (B, 2B)
    s2 = q_sp1 @ all_ctx.t()
    ns1 = torch.einsum("bh,bnh->bn", q, neg_ctx)              # (B, 2)
    ns2 = torch.einsum("bh,bnh->bn", q_sp1, neg_ctx)

    # a question's own c2 is not a hop-1 target
    eye = torch.eye(B, dtype=torch.bool, device=q.device)
    mask1 = torch.cat([torch.zeros_like(eye), eye], dim=1)
    s1 = s1.masked_fill(mask1, NEG_INF)

    s1 = torch.cat([s1, ns1], dim=1)
    s2 = torch.cat([s2, ns2], dim=1)

    if queue is not None:
        qf = queue.detach().float()
        s1 = torch.cat([s1, q @ qf.t()], dim=1)
        s2 = torch.cat([s2, q_sp1 @ qf.t()], dim=1)

    t1 = torch.arange(B, device=q.device)
    return s1, s2, t1, t1 + B


def mhop_loss(outputs: Outputs, queue: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Contrastive 2-hop loss; ``queue`` is the (K, h) memory bank of the
    momentum stage (None in stage 1)."""
    s1, s2, t1, t2 = _mhop_scores(outputs, queue)
    return cross_entropy(s1, t1) + cross_entropy(s2, t2)


def _reciprocal_ranks(scores: torch.Tensor, targets: torch.Tensor
                      ) -> torch.Tensor:
    """1 / (rank of the target under a descending sort)."""
    gold = scores.gather(-1, targets.long()[:, None])
    rank = (scores > gold).sum(-1) + 1
    return 1.0 / rank.float()


def mhop_eval(outputs: Outputs) -> Dict[str, torch.Tensor]:
    """In-batch reciprocal ranks per hop."""
    s1, s2, t1, t2 = _mhop_scores(outputs)
    return {"rrs_1": _reciprocal_ranks(s1, t1),
            "rrs_2": _reciprocal_ranks(s2, t2)}


def unified_loss(outputs: Outputs, stop_targets: torch.Tensor
                 ) -> torch.Tensor:
    """Variable-hop loss: sum-reduced CE for both hops plus the stop
    classifier's CE; hop 2 counts only for multi-hop samples
    (``stop_targets == 1`` means a second hop exists)."""
    s1, s2, t1, t2 = _mhop_scores(outputs)
    stop = stop_targets.reshape(-1)
    retrieve = (cross_entropy(s1, t1, reduction="sum")
                + (cross_entropy(s2, t2, reduction="none")
                   * stop.float()).sum())
    stop_loss = cross_entropy(outputs["stop_logits"], stop, reduction="sum")
    return retrieve + stop_loss


def unified_eval(outputs: Outputs, stop_targets: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Per-sample reciprocal ranks, stop accuracy and the multi-hop mask,
    so that the host can bucket the ranks."""
    s1, s2, t1, t2 = _mhop_scores(outputs)
    stop = stop_targets.reshape(-1)
    stop_pred = torch.argmax(outputs["stop_logits"].float(), dim=1)
    return {
        "rrs_1": _reciprocal_ranks(s1, t1),
        "rrs_2": _reciprocal_ranks(s2, t2),
        "stop_acc": (stop_pred == stop.long()).float(),
        "is_mhop": stop.bool(),
    }


def single_loss(outputs: Outputs, queue_c: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Single-hop DPR loss: scores = q · [c; neg]ᵀ with target i;
    ``queue_c`` (K, h) appends memory-bank negatives re-encoded from the
    token queue."""
    q = outputs["q"].float()
    c = outputs["c"].float()
    neg = outputs["neg"].float()
    cols = [q @ c.t(), q @ neg.t()]
    if queue_c is not None:
        cols.append(q @ queue_c.float().t())
    scores = torch.cat(cols, dim=1)                           # (B, 2B [+K])
    targets = torch.arange(q.shape[0], device=q.device)
    return cross_entropy(scores, targets)


def single_eval(outputs: Outputs) -> Dict[str, torch.Tensor]:
    q = outputs["q"].float()
    c = outputs["c"].float()
    neg = outputs["neg"].float()
    scores = torch.cat([q @ c.t(), q @ neg.t()], dim=1)
    targets = torch.arange(q.shape[0], device=q.device)
    return {"rrs": _reciprocal_ranks(scores, targets)}


def nq_mhop_loss(outputs: Outputs, queue: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Error-recovery objective of the NQ variants: the question and the
    recovery query ``q_neg1`` (question ⊕ a wrong passage) must both rank
    the gold passage first against in-batch and dense negatives;
    ``queue`` (K, h) appends memory-bank negatives."""
    q = outputs["q"].float()
    q_neg1 = outputs["q_neg1"].float()
    ctx = [outputs["c"].float().t(), outputs["neg"].float().t()]
    for k in ("dense_neg1", "dense_neg2"):
        if k in outputs:
            ctx.append(outputs[k].float().t())
    if queue is not None:
        ctx.append(queue.float().t())
    ctx = torch.cat(ctx, dim=1)                               # (h, >=2B [+K])
    targets = torch.arange(q.shape[0], device=q.device)
    return (cross_entropy(q @ ctx, targets)
            + cross_entropy(q_neg1 @ ctx, targets))


def enqueue(queue: torch.Tensor, ptr: Union[int, torch.Tensor],
            embeddings: torch.Tensor):
    """Memory-bank update, in place: the rows land at ``ptr`` and wrap
    around the queue's end (the reference truncates there instead).  A
    batch larger than the whole queue keeps its LAST K rows, so that no
    slot is written twice.  Returns (queue, new ptr)."""
    k = queue.shape[0]
    if embeddings.shape[0] > k:
        embeddings = embeddings[-k:]
    n = embeddings.shape[0]
    idx = (ptr + torch.arange(n, device=queue.device)) % k
    queue[idx] = embeddings.detach().to(queue.dtype)
    return queue, (ptr + n) % k


def _tensors(x):
    if isinstance(x, nn.Module):
        return list(x.parameters())
    if isinstance(x, dict):
        return list(x.values())
    return list(x)


@torch.no_grad()
def momentum_update(params_q, params_k, m: float):
    """EMA key-encoder update, in place on ``params_k``: pk·m + pq·(1−m).
    Modules, state dicts or lists of tensors.  The reference never calls
    it while training (stage 2 trains against a frozen key encoder); the
    trainer runs it only with ``enable_ema``."""
    for pk, pq in zip(_tensors(params_k), _tensors(params_q)):
        pk.copy_(pk * m + pq.to(pk.dtype) * (1.0 - m))
    return params_k
