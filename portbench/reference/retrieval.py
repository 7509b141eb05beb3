"""Plain reference of retrieval: exact inner-product search over the index
as stored (int8 rows times their float32 scales), the q ⊕ p pair input
as the Hugging Face RoBERTa tokenizer builds it, and 2-hop chains.

Written from the definitions, not from the program: the scores are float32
products of the reference's query with the dequantized rows, taken in
blocks of rows so that they fit; ties go to the lower row.  It imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

BLOCK = 1 << 18


def longest_first(la: torch.Tensor, lb: torch.Tensor, budget: int):
    """Lengths kept by longest-first pair truncation: one token at a time
    off the longer side, off the second side on a tie."""
    la, lb = la.long(), lb.long()
    fits = la + lb <= budget
    half_hi, half_lo = (budget + 1) // 2, budget // 2
    a_long = (la > lb) & (budget - lb >= lb)
    b_long = (lb >= la) & (budget - la >= la)
    ka = torch.where(fits, la, torch.where(a_long, budget - lb, torch.where(
        b_long, la, torch.full_like(la, half_hi))))
    kb = torch.where(fits, lb, torch.where(a_long, lb, torch.where(
        b_long, budget - la, torch.full_like(lb, half_lo))))
    return ka, kb


def pair_inputs(a_ids, a_lens, b_ids, b_lens, width: int, spec: Dict):
    """``<s> a </s> </s> b </s>`` rows padded to ``width``, with their
    masks (RoBERTa's pair layout; ``spec`` gives cls, sep and pad ids).
    ``b_ids`` may be the 16-bit token store (read as unsigned)."""
    ka, kb = longest_first(a_lens, b_lens, width - 4)
    ka, kb = ka[:, None], kb[:, None]
    n, dev = a_ids.shape[0], a_ids.device
    j = torch.arange(width, device=dev)[None, :].expand(n, width)
    a_pos = (j - 1).clamp(0, a_ids.shape[1] - 1)
    b_pos = (j - ka - 3).clamp(0, b_ids.shape[1] - 1)
    a_tok = torch.gather(a_ids.long(), 1, a_pos)
    b_tok = torch.gather(b_ids.long() & 0xFFFF, 1, b_pos)
    b_end = ka + 3 + kb
    ids = torch.full((n, width), spec["pad_id"], dtype=torch.int64,
                     device=dev)
    ids = torch.where(j == b_end, spec["sep_id"], ids)
    ids = torch.where((j >= ka + 3) & (j < b_end), b_tok, ids)
    ids = torch.where((j == ka + 1) | (j == ka + 2), spec["sep_id"], ids)
    ids = torch.where((j >= 1) & (j <= ka), a_tok, ids)
    ids = torch.where(j == 0, spec["cls_id"], ids)
    return ids, (j <= b_end).to(torch.int64)


def exact_topk(queries: torch.Tensor, rows: torch.Tensor,
               scales: torch.Tensor, n_docs: int, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (B, k), row ids (B, k)) of the exact top-k of float32
    ``queries`` against ``rows`` x ``scales`` over the first ``n_docs``
    rows; ties to the lower row."""
    q = queries.float()
    best_v = torch.full((q.shape[0], 0), float("-inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.long, device=q.device)
    for s in range(0, n_docs, BLOCK):
        e = min(s + BLOCK, n_docs)
        sc = (q @ rows[s:e].float().t()) * scales[s:e].float()[None, :]
        # the block's k best, in row order, then a stable merge: among
        # equal scores the earlier block and the lower row come first
        top = torch.sort(sc.topk(min(k, e - s), dim=1).indices, dim=1).values
        v = torch.cat([best_v, torch.gather(sc, 1, top)], 1)
        i = torch.cat([best_i, top + s], 1)
        order = torch.sort(v, dim=1, descending=True, stable=True).indices
        order = order[:, :k]
        best_v, best_i = torch.gather(v, 1, order), torch.gather(i, 1, order)
    return best_v, best_i
