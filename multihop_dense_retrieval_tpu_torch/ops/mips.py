"""Exact maximum-inner-product search (MIPS) over a device-resident index.

The PyTorch counterpart of the JAX package's ``ops/mips.py``.  Four
hand-written CUDA kernels (``csrc/``) carry the serving path; each has a
plain PyTorch version here with the same arithmetic, and a wrapper that
launches the kernel for a CUDA tensor and takes the plain version only for
a tensor on the CPU (a CUDA tensor the kernel does not take raises):

  1. ``mips_scan_int8``  — int8 scan + fused top-k      (csrc/mips_scan.cu)
  2. ``mips_scan``       — bf16/fp32 scan + fused top-k  (csrc/mips_scan.cu)
  3. ``pca_chunk_max``   — PCA phase 1, chunk maxima     (csrc/pca_prefilter.cu)
  4. ``pca_rescan_int8`` — PCA phase 2, int8 rescan      (csrc/pca_prefilter.cu)

``LAUNCHES`` counts kernel launches per wrapper.  Every JAX ``top_k`` or
``argsort`` mirrored here goes through ``topk_lower_index`` (a stable
descending sort), so ties go to the lower index as in ``lax.top_k``.

int8 scores are exact in the plain versions too: an int8 x int8 dot over
D <= 1040 terms is an integer below 2^24, so fp32 products and sums of it
carry no rounding whatever their order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -3.0e38

LAUNCHES = {"mips_scan_int8": 0, "mips_scan": 0, "pca_chunk_max": 0,
            "pca_rescan_int8": 0}

_PLAIN_CHUNK = 65536  # rows per step of the plain scans (bounds memory)


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def topk_lower_index(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _on_cuda(*tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on mixed devices: {devs}")
    return devs == {"cuda"}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# --------------------------------------------------------------------------
# quantization
# --------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8: (int8 values, fp32 scales); round half to
    even, scale floor 1e-10 (the JAX package's quantize_rows)."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-10)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


# --------------------------------------------------------------------------
# kernels 1 and 2: scan + fused top-k
# --------------------------------------------------------------------------


def _scan_topk_plain(score_fn, n: int, b: int, k: int, n_valid: int,
                     device) -> tuple:
    """Running top-k over row chunks; the running list (starting as k
    (NEG_INF, 0) fillers) precedes each chunk, so ties go to the lower row
    and a query with fewer than k valid rows keeps fillers."""
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    ids = torch.zeros((b, k), dtype=torch.int64, device=device)
    for s in range(0, n, _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, n)
        sc = score_fn(s, e)
        col = torch.arange(s, e, device=device)
        sc = torch.where(col[None, :] < n_valid, sc, NEG_INF)
        cv, ci = topk_lower_index(sc, min(k, e - s))
        allv = torch.cat([vals, cv], dim=1)
        alli = torch.cat([ids, ci + s], dim=1)
        vals, pos = topk_lower_index(allv, k)
        ids = torch.gather(alli, 1, pos)
    return vals, ids.to(torch.int32)


def mips_scan_int8_plain(q_int8, q_scale, index, d_scale, k: int,
                         n_valid: Optional[int] = None):
    """Plain version of kernel 1: scores float(raw) * q_scale * d_scale."""
    n = index.shape[0]
    nv = n if n_valid is None else n_valid
    qf = q_int8.float()

    def score(s, e):
        raw = qf @ index[s:e].float().t()
        return raw * q_scale.float()[:, None] * d_scale[s:e].float()[None, :]

    return _scan_topk_plain(score, n, q_int8.shape[0], k, nv, index.device)


def mips_scan_plain(queries, index, k: int, n_valid: Optional[int] = None):
    """Plain version of kernel 2: queries cast to the index dtype, fp32
    accumulation."""
    n = index.shape[0]
    nv = n if n_valid is None else n_valid
    qf = queries.to(index.dtype).float()
    return _scan_topk_plain(lambda s, e: qf @ index[s:e].float().t(), n,
                            queries.shape[0], k, nv, index.device)


def _kmax(k: int) -> int:
    for km in (1, 2, 4, 8):
        if k <= km:
            return km
    raise NotImplementedError(f"k={k}: the scan kernel keeps at most 8")


def _launch_scan(dtype_code, q, q_scale, index, d_scale, k, n_valid):
    from . import _build

    b, d = q.shape
    n = index.shape[0]
    w = d * index.element_size() // 4
    _require(d * index.element_size() % 64 == 0,
             f"row bytes {d * index.element_size()} must be a multiple of 64")
    for t in (q, index, q_scale, d_scale):
        _require(t is None or t.is_contiguous(), "inputs must be contiguous")
    lib = _build.load("mips_scan")
    _require(lib.mips_scan_smem_bytes(w) <= 232448,
             f"D={d} needs more shared memory than a block has")
    kmax = _kmax(k)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    q_tiles = -(-b // 64)
    rows_per_split = max(128, -(-n // max(1, (4 * sms) // q_tiles)))
    rows_per_split = -(-rows_per_split // 128) * 128
    n_splits = -(-n // rows_per_split)
    part_v = torch.empty((b, n_splits, kmax), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((b, n_splits, kmax), dtype=torch.int32,
                         device=q.device)
    out_v = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    _build.check(lib.mips_scan_topk(
        q.data_ptr(), None if q_scale is None else q_scale.data_ptr(),
        index.data_ptr(), None if d_scale is None else d_scale.data_ptr(),
        dtype_code, b, n, n if n_valid is None else n_valid, w, n_splits,
        rows_per_split, k, kmax, part_v.data_ptr(), part_i.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), _stream()), "mips_scan_topk")
    return out_v, out_i


def mips_scan_int8(q_int8, q_scale, index, d_scale, k: int,
                   n_valid: Optional[int] = None):
    """Kernel 1: exact int8 MIPS top-k (k < 8).  (B, k) fp32 scores and
    int32 row ids, bit-equal to the JAX package's int8 tiers."""
    if not _on_cuda(q_int8, q_scale, index, d_scale):
        return mips_scan_int8_plain(q_int8, q_scale, index, d_scale, k, n_valid)
    _require(q_int8.dtype == index.dtype == torch.int8, "int8 inputs expected")
    _require(q_scale.dtype == d_scale.dtype == torch.float32,
             "fp32 scales expected")
    out = _launch_scan(0, q_int8, q_scale, index, d_scale, k, n_valid)
    LAUNCHES["mips_scan_int8"] += 1
    return out


def mips_scan(queries, index, k: int, n_valid: Optional[int] = None):
    """Kernel 2: exact bf16/fp32 MIPS top-k (k < 8), fp32 accumulation."""
    if not _on_cuda(queries, index):
        return mips_scan_plain(queries, index, k, n_valid)
    codes = {torch.bfloat16: 1, torch.float32: 2}
    _require(index.dtype in codes, f"unsupported index dtype {index.dtype}")
    q = queries.to(index.dtype).contiguous()
    out = _launch_scan(codes[index.dtype], q, None, index, None, k, n_valid)
    LAUNCHES["mips_scan"] += 1
    return out


def mips_topk(index, queries, k: int, *, n_valid: Optional[int] = None,
              doc_scales=None):
    """Single-device exact top-k.  On CUDA the scan kernels serve k < 8;
    k >= 8 is where the JAX dispatcher takes its two-phase kernels, which
    are not ported yet, so it raises."""
    if index.dtype == torch.int8:
        _require(doc_scales is not None, "int8 index requires doc_scales")
    if index.is_cuda and k >= 8:
        raise NotImplementedError(
            "k >= 8 needs the two-phase chunk-max kernels, not ported yet")
    if index.dtype == torch.int8:
        q_int8, q_scale = quantize_rows(queries)
        return mips_scan_int8(q_int8, q_scale, index, doc_scales, k, n_valid)
    return mips_scan(queries, index, k, n_valid)


# --------------------------------------------------------------------------
# PCA-prefiltered search with exactness certificates
# --------------------------------------------------------------------------


def pca_chunk_max_plain(qp, proj, cand_rows: int, n_valid: Optional[int] = None):
    """Plain version of kernel 3: (B, N/cand_rows) maxima of qp . proj^T
    over each chunk's valid rows (fp32 sums of bf16 products)."""
    n = proj.shape[0]
    nv = n if n_valid is None else n_valid
    qf = qp.float()
    outs = []
    step = max(cand_rows, (_PLAIN_CHUNK // cand_rows) * cand_rows)
    for s in range(0, n, step):
        e = min(s + step, n)
        sc = qf @ proj[s:e].float().t()
        col = torch.arange(s, e, device=proj.device)
        sc = torch.where(col[None, :] < nv, sc, NEG_INF)
        outs.append(sc.view(sc.shape[0], -1, cand_rows).amax(dim=2))
    return torch.cat(outs, dim=1)


def pca_chunk_max(qp, proj, cand_rows: int, n_valid: Optional[int] = None):
    """Kernel 3: PCA phase 1 chunk maxima, (B, num_cand) fp32."""
    if not _on_cuda(qp, proj):
        return pca_chunk_max_plain(qp, proj, cand_rows, n_valid)
    from . import _build

    b, r = qp.shape
    n = proj.shape[0]
    _require(qp.dtype == proj.dtype == torch.bfloat16, "bf16 inputs expected")
    _require(r % 32 == 0, f"projection width {r} must be a multiple of 32")
    _require(cand_rows % 128 == 0 and n % cand_rows == 0,
             "cand_rows must be a multiple of 128 dividing the row count")
    qp, proj = qp.contiguous(), proj.contiguous()
    num_cand = n // cand_rows
    sms = torch.cuda.get_device_properties(qp.device).multi_processor_count
    q_tiles = -(-b // 64)
    per_block = max(1, num_cand * q_tiles // (8 * sms))
    out = torch.empty((b, num_cand), dtype=torch.float32, device=qp.device)
    lib = _build.load("pca_prefilter")
    _build.check(lib.pca_chunk_max(
        qp.data_ptr(), proj.data_ptr(), b, n, n if n_valid is None else n_valid,
        r // 2, cand_rows, per_block, out.data_ptr(), _stream()),
        "pca_chunk_max")
    LAUNCHES["pca_chunk_max"] += 1
    return out


def pca_rescan_plain(chunk_ids, q_used, index, d_scale, cand_rows: int,
                     n_valid: Optional[int] = None):
    """Plain version of kernel 4 (and of the not-yet-ported float rescan):
    (B, kc*cand_rows) scores of each query against its selected chunks.
    int8: float(raw) * d_scale[row] (the query scale is the caller's);
    float: queries cast to the index dtype, fp32 accumulation."""
    b, kc = chunk_ids.shape
    nv = index.shape[0] if n_valid is None else n_valid
    offs = torch.arange(cand_rows, device=index.device)
    qf = q_used.to(index.dtype).float() if index.dtype != torch.int8 \
        else q_used.float()
    outs = []
    for j in range(kc):
        rows = chunk_ids[:, j].long()[:, None] * cand_rows + offs[None, :]
        x = index[rows.reshape(-1)].float().view(b, cand_rows, -1)
        sc = torch.bmm(x, qf[:, :, None])[:, :, 0]
        if index.dtype == torch.int8:
            sc = sc * d_scale[rows].float()
        outs.append(torch.where(rows < nv, sc, NEG_INF))
    return torch.cat(outs, dim=1)


def pca_rescan_int8(chunk_ids, q_int8, index, d_scale, cand_rows: int,
                    n_valid: Optional[int] = None):
    """Kernel 4: int8 rescan of each query's selected chunks."""
    if not _on_cuda(chunk_ids, q_int8, index, d_scale):
        return pca_rescan_plain(chunk_ids, q_int8, index, d_scale, cand_rows,
                                n_valid)
    from . import _build

    b, kc = chunk_ids.shape
    d = index.shape[1]
    _require(q_int8.dtype == index.dtype == torch.int8, "int8 inputs expected")
    _require(d % 4 == 0 and d <= 1024, f"D={d}: need D % 4 == 0, D <= 1024")
    ids = chunk_ids.to(torch.int32).contiguous()
    q_int8, d_scale = q_int8.contiguous(), d_scale.float().contiguous()
    out = torch.empty((b, kc * cand_rows), dtype=torch.float32,
                      device=index.device)
    lib = _build.load("pca_prefilter")
    _build.check(lib.pca_rescan_int8(
        ids.data_ptr(), q_int8.data_ptr(), index.data_ptr(), d_scale.data_ptr(),
        b, kc, d // 4, cand_rows, index.shape[0] if n_valid is None else n_valid,
        out.data_ptr(), _stream()), "pca_rescan_int8")
    LAUNCHES["pca_rescan_int8"] += 1
    return out


def mips_topk_pca(index, proj, rot, bounds, queries, k: int,
                  k_chunks: int = 8, cand_rows: int = 512,
                  n_valid: Optional[int] = None, doc_scales=None):
    """PCA-prefiltered top-k with per-query exactness certificates (the JAX
    package's mips_topk_pca).  Returns (vals (B, k), row ids (B, k) int32,
    certified (B,) bool): a certified query's result equals the exact
    top-k of the stored index."""
    n = index.shape[0]
    num_cand = n // cand_rows
    _require(n % cand_rows == 0, f"rows {n} not a multiple of {cand_rows}")
    if num_cand <= k_chunks:
        raise ValueError("k_chunks must be < number of candidate chunks")
    is_int8 = index.dtype == torch.int8
    if index.is_cuda and not is_int8:
        raise NotImplementedError(
            "PCA over a non-int8 index needs the float rescan kernel, not "
            "ported yet")

    # query-side projections and exact error norms
    q32 = queries.float()
    q_proj = q32 @ rot
    qp_store = q_proj.to(proj.dtype)
    qperp = torch.sqrt(torch.clamp(
        (q32 * q32).sum(1) - (q_proj * q_proj).sum(1), min=0.0))
    qpnorm = torch.sqrt((q_proj * q_proj).sum(1))
    qperr = torch.linalg.norm(q_proj - qp_store.float(), dim=1)
    if is_int8:
        _require(doc_scales is not None, "int8 index requires doc_scales")
        q_used, q_scales = quantize_rows(queries)
        q_deq = q_used.float() * q_scales[:, None]
        qerr = torch.linalg.norm(q32 - q_deq, dim=1)
    else:
        q_used = queries.to(index.dtype)
        qerr = torch.linalg.norm(q32 - q_used.float(), dim=1)

    maxp = pca_chunk_max(qp_store, proj, cand_rows, n_valid)   # (B, num_cand)
    ub = (maxp
          + qperp[:, None] * bounds[0][None, :]
          + qpnorm[:, None] * bounds[1][None, :]
          + qperr[:, None] * bounds[2][None, :]
          + qerr[:, None] * bounds[3][None, :])
    ub_vals, ub_ids = topk_lower_index(ub, k_chunks + 1)
    chunk_ids = ub_ids[:, :k_chunks].to(torch.int32)
    ub_next = ub_vals[:, k_chunks]

    if is_int8:
        scores = pca_rescan_int8(chunk_ids, q_used, index, doc_scales,
                                 cand_rows, n_valid)
        scores = scores * q_scales[:, None]
    else:
        scores = pca_rescan_plain(chunk_ids, q_used, index, None, cand_rows,
                                  n_valid)
    row_ids = (chunk_ids.long()[:, :, None] * cand_rows
               + torch.arange(cand_rows, device=index.device)[None, None, :]
               ).reshape(chunk_ids.shape[0], -1)
    vals, pos = topk_lower_index(scores, k)
    certified = vals[:, k - 1] >= ub_next
    ids = torch.gather(row_ids, 1, pos).to(torch.int32)
    return vals, ids, certified


def merge_multivector(vals, rows, k: int, m: int):
    """Collapse a (B, k*m) row-level top-k over a multi-vector index (rows
    grouped per passage, doc = row // m) into a (B, k) doc-level top-k."""
    if m <= 1:
        return vals, rows
    km = vals.shape[1]
    docs = rows // m
    same = docs[:, :, None] == docs[:, None, :]
    earlier = torch.tril(torch.ones((km, km), dtype=torch.bool,
                                    device=vals.device), -1)
    dup = (same & earlier[None]).any(dim=-1)
    vals = torch.where(dup, NEG_INF, vals)
    top_vals, pos = topk_lower_index(vals, k)
    return top_vals, torch.gather(docs, 1, pos)


# --------------------------------------------------------------------------
# host-side PCA build (numpy, build time)
# --------------------------------------------------------------------------


def bf16_round(x) -> np.ndarray:
    """float32 → bfloat16 → float32 with round-to-nearest-even (what
    ``jnp.bfloat16`` and ``Tensor.to(torch.bfloat16)`` do; float64 input
    rounds to float32 first, as a JAX conversion does)."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def train_pca_rotation(sample, r: int):
    """(D, r) fp32 rotation: top-r eigenvectors of the uncentered second
    moment of a corpus sample."""
    x = np.asarray(sample, np.float64)
    _, v = np.linalg.eigh(x.T @ x)
    return np.ascontiguousarray(v[:, ::-1][:, :r]).astype(np.float32)


def build_pca_prefilter(emb, rot, *, cand_rows: int = 512,
                        n_pad: Optional[int] = None, scales=None,
                        store_dtype: str = "bfloat16"):
    """Projection + certificate bounds for ``mips_topk_pca`` (the JAX
    package's build_pca_prefilter, same arithmetic).  Returns (proj
    (n_pad, R) fp32 — store as bf16 —, bounds (4, n_pad/cand_rows) fp32
    rows [resid, delta, pnorm, xnorm]) over the rows as stored."""
    n, d = emb.shape
    n_pad = n if n_pad is None else n_pad
    assert n_pad % cand_rows == 0 and n <= n_pad
    r = rot.shape[1]
    num_cand = n_pad // cand_rows
    proj = np.zeros((n_pad, r), np.float32)
    per_row = np.zeros((4, n_pad), np.float32)
    for s in range(0, n, 65536):
        e = min(s + 65536, n)
        x = np.asarray(emb[s:e], np.float64)
        if scales is not None:
            sc = np.asarray(scales[s:e], np.float32).reshape(-1, 1)
            qi = np.clip(np.round(emb[s:e].astype(np.float32) / sc),
                         -127, 127)
            x = qi.astype(np.float64) * sc.astype(np.float64)
        elif store_dtype == "bfloat16":
            x = bf16_round(emb[s:e]).astype(np.float64)
        p = x @ np.asarray(rot, np.float64)
        proj[s:e] = p
        p_store = bf16_round(p).astype(np.float64)
        per_row[0, s:e] = np.sqrt(np.maximum(
            (x * x).sum(1) - (p * p).sum(1), 0.0))
        per_row[1, s:e] = np.linalg.norm(p - p_store, axis=1)
        per_row[2, s:e] = np.linalg.norm(p_store, axis=1)
        per_row[3, s:e] = np.linalg.norm(x, axis=1)
    bounds = per_row.reshape(4, num_cand, cand_rows).max(axis=2)
    bounds = np.nextafter(bounds, np.float32(np.inf)).astype(np.float32)
    return proj, bounds
