"""The seeded corpus of the retrieval cells, made on the device in slices.

No index file is written: the arrays are those ``DenseIndex.load`` would
give for an int8 index with a PCA prefilter, made here and handed to the
program.

  * Rows are drawn as ``z @ factor.T`` (``z`` standard normal), matching
    the uncentered second moment of the seeded encoder's own CLS vectors
    (measured by the reference encoder), so that the int8 quantizer and
    the PCA prefilter see a realistic spectrum.  The rotation is the
    moment's top-R eigenvectors.
  * Rows are quantized per row to int8 (scale max|x| / 127, floor 1e-10,
    round half to even); the projection of each stored (dequantized) row
    on the rotation is kept in bf16, and the four certificate bounds of
    each candidate chunk (residual norm, bf16 rounding norm, projection
    norm, row norm) are its rows' maxima, float64 per row, then float32,
    then one float32 step up.
  * Planted rows: with random weights the CLS vectors are nearly parallel,
    so every question would hit the same few rows.  Each pooled question
    gets a hop-1 row along its query vector and a hop-2 row along its
    q ⊕ p vector, 1.05x as long as the longest random row: its own row
    scores above every random row (Cauchy-Schwarz), so hits spread over
    the corpus.  A planted row lies in the span of the encoder's vectors,
    which the PCA rotation captures, as a trained index's rows do.
  * The token store is 16-bit (ids above 32767 kept as their int16 bit
    patterns), with passage lengths lognormal and clipped; the planted
    rows' lengths are one multiset for every seed (``fixed_lengths``), as
    are the questions', so that every seed sends the same hop-2 widths.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..reference.encoder import exact_fp32

SLICE_MAX = 1 << 19


def slice_rows(n_pad: int, unit: int = 4096) -> int:
    """The largest multiple of ``unit`` dividing ``n_pad`` that is at most
    ``SLICE_MAX`` (``unit`` itself at least)."""
    blocks = n_pad // unit
    best = 1
    for d in range(1, blocks + 1):
        if blocks % d == 0 and d * unit <= SLICE_MAX:
            best = d
    return best * unit


def lognormal_lengths(gen, n: int, spec: Dict, device) -> torch.Tensor:
    """int32 lengths exp(N(log median, sigma)) clipped to [lo, hi]."""
    z = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    x = torch.exp(np.log(spec["median"]) + spec["sigma"] * z)
    return x.clamp(spec["lo"], spec["hi"]).to(torch.int32)


def fixed_lengths(gen, n: int, spec: Dict) -> torch.Tensor:
    """``n`` lognormal lengths drawn from a fixed seed, in an order drawn
    from ``gen``: the same multiset whatever the run's seed."""
    lens = lognormal_lengths(torch.Generator().manual_seed(0), n, spec,
                             "cpu")
    perm = torch.randperm(n, generator=gen, device=gen.device).cpu()
    return lens[perm]


def moment_factor(encode, vocab: int, gen, device, n: int = 256,
                  width: int = 32, r: int = 128):
    """(factor (D, D), rotation (D, r)) from ``n`` encodes of random
    ``width``-token rows: rows drawn as z @ factor.T have the vectors'
    uncentered second moment, with a ridge of 1% of its mean eigenvalue."""
    ids = torch.randint(4, vocab - 1, (n, width), generator=gen,
                        device=device)
    mask = torch.ones_like(ids)
    with torch.no_grad(), exact_fp32():
        s = torch.cat([encode(ids[i:i + 64], mask[i:i + 64])
                       for i in range(0, n, 64)]).double()
    m = s.t() @ s / n
    d = m.shape[0]
    m += torch.eye(d, dtype=m.dtype, device=m.device) * (
        torch.trace(m) / d * 0.01)
    lam, u = torch.linalg.eigh(m)
    lam, u = lam.flip(0).clamp(min=1e-9), u.flip(1)
    factor = (u * lam.sqrt()).float()
    rot = u[:, :r].contiguous().float()
    return factor, rot


def token_store(gen, n_pad: int, width: int, vocab: int, lens: Dict,
                device):
    """(ids (n_pad, width) int16 bit patterns, lengths (n_pad,) int32)."""
    ids = torch.empty((n_pad, width), dtype=torch.int16, device=device)
    step = slice_rows(n_pad)
    for s in range(0, n_pad, step):
        e = min(s + step, n_pad)
        ids[s:e] = torch.randint(4, vocab - 1, (e - s, width), generator=gen,
                                 device=device, dtype=torch.int32
                                 ).to(torch.int16)
    return ids, lognormal_lengths(gen, n_pad, lens, device)


def quantize(x: torch.Tensor):
    """Per-row symmetric int8 of float32 rows: (int8, scales)."""
    scale = torch.clamp(x.abs().amax(1) / 127.0, min=1e-10)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def plant(vecs: torch.Tensor, longest: float) -> torch.Tensor:
    """Planted rows for float32 ``vecs``: each along its vector, 1.05
    ``longest`` long."""
    v = vecs.double()
    return (v / v.norm(dim=1, keepdim=True) * (1.05 * longest)).float()


def make_index(gen, factor, rot, n_pad: int, n_docs: int, cand_rows: int,
               planted_ids: torch.Tensor, planted_vecs: torch.Tensor,
               device) -> Dict:
    """The int8 index with its PCA prefilter: ``vectors`` (n_pad, D) int8,
    ``scales`` (n_pad,), ``pca_proj`` (n_pad, R) bf16, ``pca_rot`` (D, R),
    ``pca_bounds`` (4, n_pad / cand_rows), and ``longest`` (the longest
    random row).  Rows ``planted_ids`` hold ``plant(planted_vecs)``; rows
    from ``n_docs`` on are zero padding."""
    d, r = factor.shape[0], rot.shape[1]
    step = slice_rows(n_pad)
    vectors = torch.empty((n_pad, d), dtype=torch.int8, device=device)
    scales = torch.empty((n_pad,), dtype=torch.float32, device=device)
    longest = torch.zeros((), device=device)
    with exact_fp32():
        for s in range(0, n_pad, step):
            e = min(s + step, n_pad)
            x = torch.randn((e - s, d), generator=gen, device=device) \
                @ factor.t()
            if e > n_docs:
                x[max(n_docs - s, 0):] = 0.0
            longest = torch.maximum(longest, x.norm(dim=1).max())
            vectors[s:e], scales[s:e] = quantize(x)
            del x
    q, sc = quantize(plant(planted_vecs, float(longest)))
    vectors[planted_ids] = q
    scales[planted_ids] = sc

    proj = torch.empty((n_pad, r), dtype=torch.bfloat16, device=device)
    per_row = torch.empty((4, n_pad), dtype=torch.float32, device=device)
    rot64 = rot.double()
    for s in range(0, n_pad, step):
        e = min(s + step, n_pad)
        x = vectors[s:e].double() * scales[s:e].double()[:, None]
        p = x @ rot64
        p32 = p.float()
        proj[s:e] = p32.to(torch.bfloat16)
        p_store = p32.to(torch.bfloat16).double()
        per_row[0, s:e] = torch.sqrt(torch.clamp(
            (x * x).sum(1) - (p * p).sum(1), min=0.0)).float()
        per_row[1, s:e] = (p - p_store).norm(dim=1).float()
        per_row[2, s:e] = p_store.norm(dim=1).float()
        per_row[3, s:e] = x.norm(dim=1).float()
        del x, p
    bounds = per_row.view(4, n_pad // cand_rows, cand_rows).amax(2)
    bounds = torch.nextafter(bounds, torch.full_like(bounds, float("inf")))
    return {"vectors": vectors, "scales": scales, "pca_proj": proj,
            "pca_rot": rot, "pca_bounds": bounds, "longest": float(longest)}


def distinct_rows(gen, n: int, n_docs: int, device) -> torch.Tensor:
    """``n`` distinct row ids below ``n_docs``, drawn from ``gen``."""
    out = torch.empty(0, dtype=torch.long, device=device)
    while out.numel() < n:
        cand = torch.randint(0, n_docs, (2 * n,), generator=gen,
                             device=device)
        out = torch.cat([out, cand])
        keep = torch.zeros(out.numel(), dtype=torch.bool, device=device)
        _, first = np.unique(out.cpu().numpy(), return_index=True)
        keep[torch.from_numpy(np.sort(first)).to(device)] = True
        out = out[keep]
    return out[:n]
