"""Exact maximum-inner-product search (MIPS) over a device-resident index.

The PyTorch counterpart of the JAX package's ``ops/mips.py``.  Seven
hand-written CUDA kernels (``csrc/``) carry the search paths; each has a
plain PyTorch version here with the same arithmetic, and a wrapper that
launches the kernel for a CUDA tensor and takes the plain version only for
a tensor on the CPU (a CUDA tensor the kernel does not take raises):

  1. ``mips_scan_int8``  — int8 scan + fused top-k       (csrc/mips_scan_i8.cu,
                           on the int8 tensor cores; csrc/mips_scan.cu for
                           widths off a multiple of 128)
  2. ``mips_scan``       — bf16/fp32 scan + fused top-k   (csrc/mips_scan_mma.cu
                           for bf16, on the tensor cores; csrc/mips_scan.cu
                           for fp32)
  3. ``pca_chunk_max``   — PCA phase 1, chunk maxima      (csrc/chunk_max_mma.cu,
                           on the tensor cores; csrc/two_phase.cu for
                           widths off a multiple of 64)
  4. ``pca_rescan_int8`` — phase 2, int8 rescan           (csrc/rescan_mma.cu,
                           on the int8 tensor cores; csrc/two_phase.cu for
                           widths off a multiple of 128)
  5. ``rescan``          — phase 2, bf16/fp32 rescan      (csrc/rescan_mma.cu
                           for bf16, on the tensor cores; csrc/two_phase.cu
                           for fp32 and widths off a multiple of 64)
  6. ``chunk_max``       — two-phase phase 1, bf16/fp32   (csrc/chunk_max_mma.cu
                           for bf16, on the tensor cores; csrc/two_phase.cu
                           for fp32)
  7. ``chunk_max_int8``  — two-phase phase 1, int8        (csrc/chunk_max_i8.cu,
                           on the int8 tensor cores; csrc/two_phase.cu for
                           widths off a multiple of 128)

Kernels 1-2 serve ``mips_topk`` for small k, kernels 6-7 then 4-5 its
exact two-phase search for large k (``mips_topk_two_phase``), and kernels
3 then 4-5 the PCA-prefiltered search (``mips_topk_pca``).
``sharded_mips_topk`` and ``sharded_mips_topk_pca`` run these once per
shard of an index split by rows over a mesh (``core/mesh.py``) and merge
the shards' candidates.

``LAUNCHES`` counts kernel launches per wrapper (kernel 8, the fused
attention of ``fused_attention.py``, and kernels 9-11, the encoder's
elementwise chains of ``encoder_fused.py``, count here too).  Every JAX
``top_k`` or ``argsort`` mirrored here goes through ``topk_lower_index``
(a stable descending sort), so ties go to the lower index as in
``lax.top_k``.

int8 scores are exact in the plain versions too: an int8 x int8 dot over
D <= 1040 terms is an integer below 2^24, so fp32 products and sums of it
carry no rounding whatever their order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.mesh import INDEX_AXIS, Sharded, all_gather_columns, on_device

NEG_INF = -3.0e38

LAUNCHES = {"mips_scan_int8": 0, "mips_scan": 0, "pca_chunk_max": 0,
            "pca_rescan_int8": 0, "rescan": 0, "chunk_max": 0,
            "chunk_max_int8": 0, "fused_attention": 0, "bias_gelu": 0,
            "masked_softmax": 0, "add_layer_norm": 0}

# The JAX dispatcher's chunk rule, kept as the port's default so that the
# chunk choice, the covering chunks and the tie order match the JAX
# package (a TPU VMEM rule, to be re-decided by measurement on the GPU).
VMEM_BUDGET = 12 * 1024 * 1024

_FLOAT_CODES = {torch.bfloat16: 1, torch.float32: 2}   # the kernels' dtypes

_PLAIN_CHUNK = 65536  # rows per step of the plain scans (bounds memory)

SMEM_LIMIT = 232448   # dynamic shared memory a block may use on an H100


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def topk_lower_index(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    even, scale floor 1e-10 (the JAX package's quantize_rows as it runs
    inside its jitted searches, where XLA turns ``max / 127`` into
    ``max * float32(1/127)``: one ulp off the quotient on ~4% of rows)."""
    x = x.float()
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp(x.abs().amax(dim=1, keepdim=True) * inv127, min=1e-10)
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


# the tensor-core templates of kernels 2, 3 and 6 (csrc/mips_scan_mma.cu,
# csrc/chunk_max_mma.cu): index rows a tile, bf16 columns a pipeline stage,
# stages, and the widest query tile of the chunk maxima
_MMA_ROWS, _MMA_KS, _MMA_STAGES, _MMA_QMAX = 128, 64, 4, 256

# kernel 2's tensor-core template (csrc/mips_scan_mma.cu) and kernel 1's
# (csrc/mips_scan_i8.cu): the widest query tile for each top-k list length
# (the lists cost 4 * NW * KMAX registers a thread beside the 16 * NW
# accumulators of a 32 * NW-query tile)
_SCAN_QMAX = {1: 192, 2: 192, 4: 128, 8: 64}

# the int8 tensor-core templates of kernels 1 and 7 (csrc/mips_scan_i8.cu,
# csrc/chunk_max_i8.cu): int8 columns (bytes) a stage.  Their shared-memory
# rows are the bf16 templates' 144 bytes, and a resident query tile's rows
# are d + 16 bytes.
_I8_KS = 128


def _query_tiles(b: int, qmax: int) -> tuple:
    """(query tile, tiles): as few tiles of at most ``qmax`` queries as
    cover b, each the same multiple of 32, padded with fewer than 32 zero
    rows a tile."""
    q_tiles = -(-b // qmax)
    q_tile = -(-(-(-b // q_tiles)) // 32) * 32
    return q_tile, -(-b // q_tile)


def _i8_smem(q_tile: int, d: int, resident: bool, maxima: bool) -> int:
    """Dynamic shared memory of the int8 tensor-core templates: the ring of
    4 stages of 144-byte rows (128 index rows, plus the query slices when
    the query tile is streamed), a slot of 128 fp32 row scales per stage,
    the resident query tile ([q_tile][d + 16] bytes) and, for the chunk
    maxima, the two row warps' maxima (the scan's lists reuse the ring)."""
    ring = _MMA_STAGES * (_MMA_ROWS + (0 if resident else q_tile)) \
        * (_I8_KS + 16)
    return (ring + _MMA_STAGES * _MMA_ROWS * 4
            + (q_tile * (d + 16) if resident else 0)
            + (2 * q_tile * 4 if maxima else 0))


def _splits(n: int, want: int) -> tuple:
    """(rows per split, splits) for at most `want` splits of n rows, each a
    whole number of 128-row tiles, the longest as short as `want` splits
    allow (so rounding may leave a few of the `want` unused)."""
    rows = -(-max(128, -(-n // max(1, want))) // 128) * 128
    return rows, -(-n // rows)


def scan_plan(b: int, n: int, d: int, dtype, k: int, sms: int = 132) -> dict:
    """Route and launch plan of the scan kernels 1 and 2.  bf16 rows of a
    width that is a multiple of 64 (kernel 2) and int8 rows of a width that
    is a multiple of 128 (kernel 1) take a tensor-core template: query
    tiles as wide as ``_SCAN_QMAX`` allows for the list length ``kmax`` (a
    multiple of 32, zero rows past B), and a grid of row splits x query
    tiles that is one wave at one block an SM (``_splits``).  bf16:
    ``smem`` = 4 stages of (128 index rows + the query tile) x 72 bf16
    plus the two row warps' lists.  int8: the query tile stays resident in
    shared memory, the widest tile narrowed in steps of 32 until it fits
    beside the ring (128 queries at D = 1024), and ``smem`` is
    ``_i8_smem``'s.  fp32 rows (a tensor-core product of fp32 would be
    TF32), narrower bf16 rows and narrower int8 rows take the SIMT
    template: 64-query tiles, 4 blocks an SM, the shared memory of
    csrc/tile_dot.cuh's ``tile_smem_bytes``.  The C entry points of the
    tensor-core templates check the plan against their own count."""
    kmax = _kmax(k)
    int8_mma = dtype == torch.int8 and d % _I8_KS == 0
    if not int8_mma and (dtype != torch.bfloat16 or d % _MMA_KS):
        q_tiles = -(-b // 64)
        rows, splits = _splits(n, (4 * sms) // q_tiles)
        return dict(route="simt", kmax=kmax, block=256, q_tile=64,
                    q_pad=64 * q_tiles, rows_per_split=rows, splits=splits,
                    grid=(q_tiles, splits, 1),
                    smem=4 * (64 * (d * dtype.itemsize // 4 + 4) + 128 * 20))
    qmax = _SCAN_QMAX[kmax]
    while (int8_mma and qmax > 32
           and _i8_smem(qmax, d, True, False) > SMEM_LIMIT):
        qmax -= 32
    q_tile, q_tiles = _query_tiles(b, qmax)
    rows, splits = _splits(n, sms // q_tiles)
    plan = dict(route="mma", kmax=kmax, block=256, q_tile=q_tile,
                q_pad=q_tile * q_tiles, rows_per_split=rows, splits=splits,
                grid=(splits, q_tiles, 1))
    if int8_mma:
        return dict(plan, smem=_i8_smem(q_tile, d, True, False))
    return dict(plan, smem=_MMA_STAGES * (_MMA_ROWS + q_tile) * (_MMA_KS + 8)
                * 2 + 2 * q_tile * kmax * 8)


def _aligned(*tensors) -> None:
    for t in tensors:
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "inputs must be contiguous and 16-byte aligned")


def _launch_scan(dtype_code, q, q_scale, index, d_scale, k, n_valid):
    from . import _build

    b, d = q.shape
    n = index.shape[0]
    w = d * index.element_size() // 4
    plan = scan_plan(b, n, d, index.dtype, k, _sms(q.device))
    nv = n if n_valid is None else n_valid
    out_v = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    part_v = torch.empty((b, plan["splits"], plan["kmax"]),
                         dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, plan["splits"], plan["kmax"]), dtype=torch.int32,
                         device=q.device)
    for t in (q_scale, d_scale):
        _require(t is None or t.is_contiguous(), "inputs must be contiguous")
    if plan["route"] == "mma" and dtype_code == 0:
        _aligned(q, index)
        _require(plan["smem"] <= SMEM_LIMIT,
                 f"D={d} needs more shared memory than a block has")
        lib = _build.load("mips_scan_i8")
        _build.check(lib.mips_scan_i8(
            q.data_ptr(), q_scale.data_ptr(), index.data_ptr(),
            d_scale.data_ptr(), b, n, nv, d, k, plan["kmax"], plan["q_tile"],
            plan["rows_per_split"], plan["splits"], plan["smem"],
            part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), _stream()), "mips_scan_i8")
        return out_v, out_i
    if plan["route"] == "mma":
        _aligned(q, index)
        lib = _build.load("mips_scan_mma")
        _build.check(lib.mips_scan_mma(
            q.data_ptr(), index.data_ptr(), b, n, nv, d, k, plan["kmax"],
            plan["q_tile"], plan["rows_per_split"], plan["splits"],
            plan["smem"], part_v.data_ptr(), part_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), _stream()), "mips_scan_mma")
        return out_v, out_i
    _require(d * index.element_size() % 64 == 0,
             f"row bytes {d * index.element_size()} must be a multiple of 64")
    for t in (q, index):
        _require(t.is_contiguous(), "inputs must be contiguous")
    _require(plan["smem"] <= SMEM_LIMIT,
             f"D={d} needs more shared memory than a block has")
    lib = _build.load("mips_scan")
    _build.check(lib.mips_scan_topk(
        q.data_ptr(), None if q_scale is None else q_scale.data_ptr(),
        index.data_ptr(), None if d_scale is None else d_scale.data_ptr(),
        dtype_code, b, n, nv, w, plan["splits"], plan["rows_per_split"], k,
        plan["kmax"], part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), _stream()), "mips_scan_topk")
    return out_v, out_i


def mips_scan_int8(q_int8, q_scale, index, d_scale, k: int,
                   n_valid: Optional[int] = None):
    """Kernel 1: exact int8 MIPS top-k (k <= 8).  (B, k) fp32 scores and
    int32 row ids, bit-equal to the JAX package's int8 tiers.  Routed as
    ``scan_plan`` says: widths a multiple of 128 on the int8 tensor cores,
    the rest on SIMT."""
    if not _on_cuda(q_int8, q_scale, index, d_scale):
        return mips_scan_int8_plain(q_int8, q_scale, index, d_scale, k, n_valid)
    _require(q_int8.dtype == index.dtype == torch.int8, "int8 inputs expected")
    _require(q_scale.dtype == d_scale.dtype == torch.float32,
             "fp32 scales expected")
    out = _launch_scan(0, q_int8, q_scale, index, d_scale, k, n_valid)
    LAUNCHES["mips_scan_int8"] += 1
    return out


def mips_scan(queries, index, k: int, n_valid: Optional[int] = None):
    """Kernel 2: exact bf16/fp32 MIPS top-k (k <= 8), fp32 accumulation.
    Routed as ``scan_plan`` says: bf16 (widths a multiple of 64) on the
    tensor cores, whose scores are the kept rows rescored in fp32; the
    rest on SIMT."""
    if not _on_cuda(queries, index):
        return mips_scan_plain(queries, index, k, n_valid)
    _require(index.dtype in _FLOAT_CODES,
             f"unsupported index dtype {index.dtype}")
    q = queries.to(index.dtype).contiguous()
    out = _launch_scan(_FLOAT_CODES[index.dtype], q, None, index, None, k,
                       n_valid)
    LAUNCHES["mips_scan"] += 1
    return out


# --------------------------------------------------------------------------
# two-phase exact search: chunk maxima (kernels 6, 7), then a rescan of
# each query's top chunks (kernels 4, 5)
# --------------------------------------------------------------------------
#
# Why it is exact: a chunk holding one of the query's top-k rows has a max
# at least the k-th value, and every chunk ranked above it by max holds a
# row at least that large, so the k chunks with the largest maxima hold
# all top-k rows (the JAX package's section comment, mips.py:479-484).


def chunk_max_plain(q, rows, chunk_rows: int, n_valid: Optional[int] = None,
                    d_scale=None):
    """Plain version of kernels 3, 6 and 7: (B, N/chunk_rows) maxima over
    each chunk's valid rows (NEG_INF for a chunk with none).  Float rows:
    ``q`` cast to the rows' dtype, fp32 sums.  int8 rows (``d_scale``
    given): float(raw) * d_scale[row], no query scale."""
    n = rows.shape[0]
    nv = n if n_valid is None else n_valid
    qf = q.float() if rows.dtype == torch.int8 else q.to(rows.dtype).float()
    outs = []
    step = max(chunk_rows, (_PLAIN_CHUNK // chunk_rows) * chunk_rows)
    for s in range(0, n, step):
        e = min(s + step, n)
        sc = qf @ rows[s:e].float().t()
        if d_scale is not None:
            sc = sc * d_scale[s:e].float()[None, :]
        col = torch.arange(s, e, device=rows.device)
        sc = torch.where(col[None, :] < nv, sc, NEG_INF)
        outs.append(sc.view(sc.shape[0], -1, chunk_rows).amax(dim=2))
    return torch.cat(outs, dim=1)


def simt_chunk_max_plan(b: int, n: int, row_bytes: int, chunk_rows: int,
                        sms: int = 132) -> dict:
    """Launch plan of the SIMT chunk-max template (csrc/two_phase.cu; kernels
    3, 6 and 7 over the rows no tensor-core template takes: fp32, and bf16
    or int8 widths off their stage): 64-query tiles (queries padded
    with zero rows to a multiple of 64), ``per_block`` chunks a block, and
    the shared memory of csrc/tile_dot.cuh's ``tile_smem_bytes``."""
    num_chunks = n // chunk_rows
    q_tiles = -(-b // 64)
    per_block = max(1, num_chunks * q_tiles // (8 * sms))
    words = row_bytes // 4
    return dict(route="simt", block=256, q_tile=64, q_pad=64 * q_tiles,
                per_block=per_block,
                grid=(q_tiles, -(-num_chunks // per_block), 1),
                smem=4 * (64 * (words + 4) + 128 * 20))


def chunk_max_plan(b: int, n: int, d: int, chunk_rows: int, dtype,
                   sms: int = 132) -> dict:
    """Route and launch plan of kernels 3, 6 and 7.  bf16 rows of a width
    that is a multiple of 64 (kernels 3, 6) and int8 rows of a width that
    is a multiple of 128 (kernel 7) take a tensor-core template, with all
    queries of a query tile (at most 256, a multiple of 32, zero rows past
    B) as the mma's N side.  Where the query tile fits beside the ring
    (``q_resident``) the resident template keeps it in shared memory and
    walks ``per_block`` consecutive chunks a block, about one block an SM;
    otherwise (kernel 6 at D=768, B > 96) one block a chunk streams the
    query tile with the index rows.  bf16 ``smem``: 4 stages of 128 index
    rows x 72 bf16 (+ the query tile's slices when streamed), the resident
    tile x (d + 8) bf16, and the row-warp maxima; int8: ``_i8_smem``'s.
    fp32 rows (a tensor-core product of fp32 would be TF32) and narrower
    bf16 or int8 rows take the SIMT template.  The C entry points check
    ``q_tile`` and ``smem`` against their own count."""
    int8_mma = dtype == torch.int8 and d % _I8_KS == 0
    if not int8_mma and (dtype != torch.bfloat16 or d % _MMA_KS):
        return simt_chunk_max_plan(b, n, d * dtype.itemsize, chunk_rows, sms)
    q_tile, q_tiles = _query_tiles(b, _MMA_QMAX)
    num_chunks = n // chunk_rows
    if int8_mma:
        resident = _i8_smem(q_tile, d, True, True) <= SMEM_LIMIT
        smem = _i8_smem(q_tile, d, resident, True)
    else:
        ring = _MMA_STAGES * _MMA_ROWS * (_MMA_KS + 8) * 2
        smem = ring + q_tile * (d + 8) * 2 + 2 * q_tile * 4
        resident = smem <= SMEM_LIMIT
        if not resident:
            smem = (ring + _MMA_STAGES * q_tile * (_MMA_KS + 8) * 2
                    + 2 * q_tile * 4)
    per_block = -(-num_chunks // max(1, sms // q_tiles)) if resident else 1
    return dict(route="mma", block=256, q_tile=q_tile, q_pad=q_tile * q_tiles,
                per_block=per_block, q_resident=resident,
                grid=(-(-num_chunks // per_block), q_tiles, 1), smem=smem)


def _check_chunks(n: int, chunk_rows: int) -> None:
    _require(chunk_rows % 128 == 0 and n % chunk_rows == 0,
             f"chunk_rows {chunk_rows} must be a multiple of 128 dividing "
             f"the row count {n}")


def _launch_chunk_max(code, q, rows, d_scale, chunk_rows, n_valid):
    from . import _build

    b, d = q.shape
    n = rows.shape[0]
    row_bytes = d * rows.element_size()
    _require(row_bytes % 64 == 0, f"row bytes {row_bytes} must be a "
             "multiple of 64")
    _check_chunks(n, chunk_rows)
    for t in (q, rows, d_scale):
        _require(t is None or t.is_contiguous(), "inputs must be contiguous")
    plan = simt_chunk_max_plan(b, n, row_bytes, chunk_rows, _sms(q.device))
    out = torch.empty((b, n // chunk_rows), dtype=torch.float32,
                      device=q.device)
    lib = _build.load("two_phase")
    _build.check(lib.chunk_max(
        code, q.data_ptr(), rows.data_ptr(),
        None if d_scale is None else d_scale.data_ptr(), b, n,
        n if n_valid is None else n_valid, row_bytes // 4, chunk_rows,
        plan["per_block"], out.data_ptr(), _stream()), "chunk_max")
    return out


def _launch_chunk_max_mma(q, rows, d_scale, chunk_rows, n_valid, plan):
    from . import _build

    b, d = q.shape
    n = rows.shape[0]
    _check_chunks(n, chunk_rows)
    _aligned(q, rows)
    out = torch.empty((b, n // chunk_rows), dtype=torch.float32,
                      device=q.device)
    nv = n if n_valid is None else n_valid
    if rows.dtype == torch.int8:
        _require(d_scale.is_contiguous(), "inputs must be contiguous")
        lib = _build.load("chunk_max_i8")
        _build.check(lib.chunk_max_i8(
            q.data_ptr(), rows.data_ptr(), d_scale.data_ptr(), b, n, nv, d,
            chunk_rows, plan["q_tile"], plan["smem"], plan["per_block"],
            int(plan["q_resident"]), out.data_ptr(), _stream()),
            "chunk_max_i8")
        return out
    lib = _build.load("chunk_max_mma")
    _build.check(lib.chunk_max_mma(
        q.data_ptr(), rows.data_ptr(), b, n, nv, d, chunk_rows,
        plan["q_tile"], plan["smem"], plan["per_block"],
        int(plan["q_resident"]), out.data_ptr(), _stream()), "chunk_max_mma")
    return out


def _routed_chunk_max(q, rows, chunk_rows, n_valid, d_scale=None):
    """Kernels 3, 6 and 7 (``d_scale`` with int8 rows), on the template
    that ``chunk_max_plan`` picks."""
    plan = chunk_max_plan(q.shape[0], *rows.shape, chunk_rows, rows.dtype,
                          _sms(q.device))
    if plan["route"] == "mma":
        return _launch_chunk_max_mma(q, rows, d_scale, chunk_rows, n_valid,
                                     plan)
    code = 0 if rows.dtype == torch.int8 else _FLOAT_CODES[rows.dtype]
    return _launch_chunk_max(code, q, rows, d_scale, chunk_rows, n_valid)


def chunk_max(q, index, chunk_rows: int, n_valid: Optional[int] = None):
    """Kernel 6: two-phase phase 1 over a bf16/fp32 index, (B, N/chunk_rows)
    fp32 maxima; ``q`` is cast to the index dtype.  Routed as
    ``chunk_max_plan`` says: bf16 (widths a multiple of 64) on the tensor
    cores, the rest on SIMT."""
    if not _on_cuda(q, index):
        return chunk_max_plain(q, index, chunk_rows, n_valid)
    _require(index.dtype in _FLOAT_CODES,
             f"unsupported index dtype {index.dtype}")
    out = _routed_chunk_max(q.to(index.dtype).contiguous(), index, chunk_rows,
                            n_valid)
    LAUNCHES["chunk_max"] += 1
    return out


def chunk_max_int8(q_int8, index, d_scale, chunk_rows: int,
                   n_valid: Optional[int] = None):
    """Kernel 7: two-phase phase 1 over an int8 index, maxima of
    float(raw) * d_scale[row], bit-equal to the JAX kernel.  Routed as
    ``chunk_max_plan`` says: widths a multiple of 128 on the int8 tensor
    cores, the rest on SIMT."""
    if not _on_cuda(q_int8, index, d_scale):
        return chunk_max_plain(q_int8, index, chunk_rows, n_valid, d_scale)
    _require(q_int8.dtype == index.dtype == torch.int8, "int8 inputs expected")
    _require(d_scale.dtype == torch.float32, "fp32 scales expected")
    out = _routed_chunk_max(q_int8, index, chunk_rows, n_valid, d_scale)
    LAUNCHES["chunk_max_int8"] += 1
    return out


def rescan_plain(chunk_ids, q_used, index, d_scale, cand_rows: int,
                 n_valid: Optional[int] = None):
    """Plain version of kernels 4 and 5: (B, kc*cand_rows) scores of each
    query against its selected chunks.  int8: float(raw) * d_scale[row]
    (the query scale is the caller's); float: queries cast to the index
    dtype, fp32 accumulation."""
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


# the rescan's tensor-core template (csrc/rescan_mma.cu): the most blocks that
# share the query tiles of one chunk's row range
_RESCAN_GROUPS = 4


def _rescan_smem(q_tile: int, row_bytes: int, int8: bool) -> int:
    """Dynamic shared memory of the rescan's tensor-core template: the ring
    of 4 stages of 128 rows x 144 bytes, a slot of 128 fp32 row scales per
    stage (int8), the gathered query tile ([q_tile][row_bytes + 16] bytes),
    the tile's slot ids and 64 bytes of the warps' match counts."""
    return (_MMA_STAGES * _MMA_ROWS * (_I8_KS + 16)
            + (_MMA_STAGES * _MMA_ROWS * 4 if int8 else 0)
            + q_tile * (row_bytes + 16) + q_tile * 4 + 64)


def rescan_plan(b: int, kc: int, n: int, cand_rows: int, d: int, dtype,
                sms: int = 132) -> dict:
    """Route and launch plan of the rescan kernels 4 and 5.  int8 rows of a
    width that is a multiple of 128 (kernel 4) and bf16 rows of a width
    that is a multiple of 64 (kernel 5) take the chunk-major tensor-core
    template: ``grid`` = (N / cand_rows chunks, ``splits`` x ``groups``),
    block (c, s + splits * g) scoring rows s * ``rows_per_split`` .. of
    chunk c against the g-th, (g + groups)-th, ... query tile of
    ``q_tile`` slots among those that selected c.
      * ``q_tile``: the b * kc slots fall on m = b * kc / min(chunks,
        b * kc) a chunk on average; the tile is the multiple of 32 that
        covers m and three standard deviations more (m + 3 sqrt(m) + 1),
        narrowed until it fits beside the ring.  A wider tile than the
        chunks need leaves the card fewer blocks (one an SM from 114 KB of
        shared memory).
      * ``groups``: a chunk that every query selected holds b slots, ceil(b
        / q_tile) tiles, each a pass over its rows; up to 4 blocks share
        them, so that such a chunk does not run long after the others.
      * ``rows_per_split``: where such a chunk still leaves a block more
        than one pass, or where the chunks are fewer than half the SMs
        (then about one block an SM), a chunk's rows are split
        (``_splits``), in ranges of at most 512 rows in the first case.
    ``smem`` is ``_rescan_smem``'s.  fp32 rows (a tensor-core product of
    fp32 would be TF32) and other widths take the SIMT template of
    csrc/two_phase.cu: one block per (query, selected chunk).  The C entry
    point of the tensor-core template checks the plan against its own
    count."""
    row_bytes = d * dtype.itemsize
    int8 = dtype == torch.int8
    if not ((int8 and d % _I8_KS == 0)
            or (dtype == torch.bfloat16 and d % _MMA_KS == 0)):
        return dict(route="simt", block=256, grid=(kc, b, 1), smem=0)
    num_chunks = n // cand_rows
    chunks = max(1, min(num_chunks, b * kc))
    m = b * kc / chunks
    q_tile = min(_MMA_QMAX, -(-int(m + 3 * m ** 0.5 + 1) // 32) * 32)
    while q_tile > 32 and _rescan_smem(q_tile, row_bytes, int8) > SMEM_LIMIT:
        q_tile -= 32
    passes = -(-b // q_tile)
    groups = min(passes, _RESCAN_GROUPS)
    want = -(-sms // chunks) if 2 * chunks < sms else 1
    if passes > groups:
        want = max(want, -(-cand_rows // 512))
    rows, splits = _splits(cand_rows, want)
    return dict(route="mma", block=256, q_tile=q_tile, rows_per_split=rows,
                splits=splits, groups=groups,
                grid=(num_chunks, splits * groups, 1),
                smem=_rescan_smem(q_tile, row_bytes, int8))


def _launch_rescan(code, chunk_ids, q, index, d_scale, cand_rows, n_valid):
    from . import _build

    b, kc = chunk_ids.shape
    n, d = index.shape
    _require(tuple(q.shape) == (b, d), f"queries {tuple(q.shape)} do not "
             f"match ({b}, {d})")
    row_bytes = d * index.element_size()
    ids = chunk_ids.to(torch.int32).contiguous()
    if ids.data_ptr() % 16:
        ids = ids.clone()
    for t in (q, index, d_scale):
        _require(t is None or t.is_contiguous(), "inputs must be contiguous")
    plan = rescan_plan(b, kc, n, cand_rows, d, index.dtype, _sms(index.device))
    out = torch.empty((b, kc * cand_rows), dtype=torch.float32,
                      device=index.device)
    nv = n if n_valid is None else n_valid
    if plan["route"] == "mma":
        _check_chunks(n, cand_rows)
        _aligned(q, index)
        _require(plan["smem"] <= SMEM_LIMIT,
                 f"D={d} needs more shared memory than a block has")
        lib = _build.load("rescan_mma")
        _build.check(lib.rescan_mma(
            code, ids.data_ptr(), q.data_ptr(), index.data_ptr(),
            None if d_scale is None else d_scale.data_ptr(), b, kc, n, nv, d,
            cand_rows, plan["q_tile"], plan["rows_per_split"],
            plan["splits"], plan["groups"], plan["smem"], out.data_ptr(),
            _stream()), "rescan_mma")
        return out
    _require(row_bytes % 4 == 0 and row_bytes <= 4096,
             f"row bytes {row_bytes}: need a multiple of 4, at most 4096")
    lib = _build.load("two_phase")
    _build.check(lib.rescan(
        code, ids.data_ptr(), q.data_ptr(), index.data_ptr(),
        None if d_scale is None else d_scale.data_ptr(), b, kc,
        row_bytes // 4, cand_rows, nv, out.data_ptr(), _stream()), "rescan")
    return out


def pca_rescan_int8(chunk_ids, q_int8, index, d_scale, cand_rows: int,
                    n_valid: Optional[int] = None):
    """Kernel 4: int8 rescan of each query's selected chunks, (B, kc *
    cand_rows) fp32 float(raw) * d_scale[row] (the caller multiplies by
    the query scale), bit-equal to the JAX kernel.  Routed as
    ``rescan_plan`` says: widths a multiple of 128 on the int8 tensor
    cores, the rest on SIMT."""
    if not _on_cuda(chunk_ids, q_int8, index, d_scale):
        return rescan_plain(chunk_ids, q_int8, index, d_scale, cand_rows,
                            n_valid)
    _require(q_int8.dtype == index.dtype == torch.int8, "int8 inputs expected")
    out = _launch_rescan(0, chunk_ids, q_int8, index,
                         d_scale.float().contiguous(), cand_rows, n_valid)
    LAUNCHES["pca_rescan_int8"] += 1
    return out


def rescan(chunk_ids, q, index, cand_rows: int, n_valid: Optional[int] = None):
    """Kernel 5: bf16/fp32 rescan of each query's selected chunks; ``q`` is
    cast to the index dtype, products accumulate in fp32.  Routed as
    ``rescan_plan`` says: bf16 (widths a multiple of 64) on the tensor
    cores, the rest on SIMT."""
    if not _on_cuda(chunk_ids, q, index):
        return rescan_plain(chunk_ids, q, index, None, cand_rows, n_valid)
    _require(index.dtype in _FLOAT_CODES,
             f"unsupported index dtype {index.dtype}")
    out = _launch_rescan(_FLOAT_CODES[index.dtype], chunk_ids,
                         q.to(index.dtype).contiguous(), index, None,
                         cand_rows, n_valid)
    LAUNCHES["rescan"] += 1
    return out


def mips_topk_two_phase(index, queries, k: int, chunk_rows: int = 2048,
                        n_valid: Optional[int] = None, doc_scales=None):
    """Exact top-k via chunk maxima + a rescan of each query's top
    ``min(k, num_chunks)`` chunks (the JAX package's mips_topk_two_phase,
    step for step).  bf16/fp32 and int8 (+doc_scales) indexes; any batch.
    Returns (vals (B, k) fp32, row ids (B, k) int32); ties in the final
    top-k go to the lower position in chunk-rank order, as ``lax.top_k``
    gives, so int8 results are bit-equal to the JAX function's."""
    n = index.shape[0]
    b = queries.shape[0]
    if n % chunk_rows:
        raise ValueError(f"index rows {n} not a multiple of chunk {chunk_rows}")
    num_chunks = n // chunk_rows
    k_chunks = min(k, num_chunks)
    is_int8 = index.dtype == torch.int8
    if is_int8:
        _require(doc_scales is not None, "int8 index requires doc_scales")
        q_used, q_scales = quantize_rows(queries)
        maxima = chunk_max_int8(q_used, index, doc_scales, chunk_rows, n_valid)
    else:
        q_used = queries.to(index.dtype)
        maxima = chunk_max(q_used, index, chunk_rows, n_valid)
    chunk_ids = topk_lower_index(maxima, k_chunks)[1].to(torch.int32)
    if is_int8:
        scores = pca_rescan_int8(chunk_ids, q_used, index, doc_scales,
                                 chunk_rows, n_valid) * q_scales[:, None]
    else:
        scores = rescan(chunk_ids, q_used, index, chunk_rows, n_valid)
    row_ids = (chunk_ids.long()[:, :, None] * chunk_rows
               + torch.arange(chunk_rows, device=index.device)[None, None, :]
               ).reshape(b, k_chunks * chunk_rows)
    vals, pos = topk_lower_index(scores, k)
    return vals, torch.gather(row_ids, 1, pos).to(torch.int32)


def auto_chunk_rows(b: int, d: int, itemsize: int = 2,
                    max_chunk: int = 8192) -> int:
    """The JAX package's chunk rule: the largest power-of-two chunk whose
    double-buffered tile + score matrix + merge temporaries fit in
    ``VMEM_BUDGET`` for a (b, d) query block; 0 when even the floor chunk
    of 512 does not."""
    chunk = max_chunk
    while chunk > 512:
        need = 2 * chunk * d * itemsize + 3 * b * chunk * 4
        if need <= VMEM_BUDGET:
            return chunk
        chunk //= 2
    need = 2 * chunk * d * itemsize + 3 * b * chunk * 4
    return chunk if need <= VMEM_BUDGET else 0


def two_phase_chunk(n: int, b: int, d: int, itemsize: int, k: int,
                    chunk_rows: int = 4096) -> int:
    """The route ``mips_topk`` takes: the chunk of the two-phase search, or
    0 for the scan kernels.  The JAX dispatcher's rule (mips.py:1041-1091):
    chunk = min(chunk_rows, auto_chunk_rows(b, d, itemsize)), two-phase iff
    k >= 8, b % 8 == 0, k <= chunk and n % chunk == 0.  Two cases differ,
    because they are TPU rules:
      * k > 8 with b % 8 != 0: JAX takes its single-pass kernel, but the
        port's scan keeps at most 8, and CUDA has no 8-row block rule, so
        the port takes the two-phase search.  The answer is the same exact
        top-k set; only the choice among exactly tied rows can differ.
      * auto_chunk_rows == 0, where JAX's VMEM rule sends the call to its
        XLA tier: the port uses the floor chunk of 512.
    (The JAX int8 rule for chunks below 1024 is a Mosaic constraint with no
    counterpart here.)"""
    chunk = min(chunk_rows, auto_chunk_rows(b, d, itemsize) or 512)
    if k >= 8 and (b % 8 == 0 or k > 8) and k <= chunk and n % chunk == 0:
        return chunk
    return 0


def mips_topk(index, queries, k: int, *, chunk_rows: int = 4096,
              n_valid: Optional[int] = None, doc_scales=None):
    """Single-device exact top-k; pass ``doc_scales`` with an int8 index.
    Routes as ``two_phase_chunk`` says: the two-phase search (kernels 6-7,
    4-5) or the scan kernels 1-2.  Returns (vals (B, k), row ids (B, k))."""
    is_int8 = index.dtype == torch.int8
    if is_int8:
        _require(doc_scales is not None, "int8 index requires doc_scales")
    chunk = two_phase_chunk(index.shape[0], queries.shape[0], index.shape[1],
                            index.element_size(), k, chunk_rows)
    if chunk:
        return mips_topk_two_phase(index, queries, k, chunk_rows=chunk,
                                   n_valid=n_valid, doc_scales=doc_scales)
    if index.is_cuda and k > 8:
        raise NotImplementedError(
            f"k={k} over {index.shape[0]} rows: the scan kernels keep at most "
            f"8, and the two-phase search needs the row count to be a "
            f"multiple of its chunk (min({chunk_rows}, the VMEM rule))")
    if is_int8:
        q_int8, q_scale = quantize_rows(queries)
        return mips_scan_int8(q_int8, q_scale, index, doc_scales, k, n_valid)
    return mips_scan(queries, index, k, n_valid)


# --------------------------------------------------------------------------
# PCA-prefiltered search with exactness certificates
# --------------------------------------------------------------------------


def pca_chunk_max(qp, proj, cand_rows: int, n_valid: Optional[int] = None):
    """Kernel 3: PCA phase 1 chunk maxima, (B, num_cand) fp32.  Routed as
    ``chunk_max_plan`` says: widths a multiple of 64 on the tensor cores,
    the other multiples of 32 on SIMT."""
    if not _on_cuda(qp, proj):
        return chunk_max_plain(qp, proj, cand_rows, n_valid)
    _require(qp.dtype == proj.dtype == torch.bfloat16, "bf16 inputs expected")
    _require(qp.shape[1] % 32 == 0,
             f"projection width {qp.shape[1]} must be a multiple of 32")
    out = _routed_chunk_max(qp.contiguous(), proj.contiguous(), cand_rows,
                            n_valid)
    LAUNCHES["pca_chunk_max"] += 1
    return out


def mips_topk_pca(index, proj, rot, bounds, queries, k: int,
                  k_chunks: int = 8, cand_rows: int = 512,
                  n_valid: Optional[int] = None, doc_scales=None):
    """PCA-prefiltered top-k with per-query exactness certificates (the JAX
    package's mips_topk_pca).  Returns (vals (B, k), row ids (B, k) int32,
    certified (B,) bool): a certified query's result equals the exact
    top-k of the stored index.  Phase 1 is kernel 3, phase 2 kernel 4
    (int8 index) or 5 (bf16/fp32)."""
    n = index.shape[0]
    num_cand = n // cand_rows
    _require(n % cand_rows == 0, f"rows {n} not a multiple of {cand_rows}")
    if num_cand <= k_chunks:
        raise ValueError("k_chunks must be < number of candidate chunks")
    is_int8 = index.dtype == torch.int8

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
    if maxp.is_cuda:
        # kernel 3's tensor-core sums may sit below the true maxima by up to
        # the fp32 summation bound R·2^-22·Σ|qp_j·p_j| <= R·2^-22·|qp|·|p|:
        # without it a near tie across the boundary certified a wrong row
        # (tests/test_torch_kernels_cuda.py::
        # test_pca_certificate_holds_at_kernel_3_near_ties).  The CPU
        # twin keeps the JAX package's bound.
        ub = ub + (qp_store.shape[1] * 2.0 ** -22) * torch.linalg.norm(
            qp_store.float(), dim=1)[:, None] * bounds[2][None, :]
    ub_vals, ub_ids = topk_lower_index(ub, k_chunks + 1)
    chunk_ids = ub_ids[:, :k_chunks].to(torch.int32)
    ub_next = ub_vals[:, k_chunks]

    if is_int8:
        scores = pca_rescan_int8(chunk_ids, q_used, index, doc_scales,
                                 cand_rows, n_valid)
        scores = scores * q_scales[:, None]
    else:
        scores = rescan(chunk_ids, q_used, index, cand_rows, n_valid)
    row_ids = (chunk_ids.long()[:, :, None] * cand_rows
               + torch.arange(cand_rows, device=index.device)[None, None, :]
               ).reshape(chunk_ids.shape[0], -1)
    vals, pos = topk_lower_index(scores, k)
    certified = vals[:, k - 1] >= ub_next
    ids = torch.gather(row_ids, 1, pos).to(torch.int32)
    return vals, ids, certified


# --------------------------------------------------------------------------
# row-sharded search over a mesh's index axis
# --------------------------------------------------------------------------
#
# Each shard runs the single-device search over its own rows on its own
# device (kernels 1-7 once per shard); local ids become global; the (B, k)
# candidates of every shard, concatenated in shard order (what JAX's tiled
# all_gather gives, and over torch.distributed in rank order across
# processes), go through one more top-k, so ties go to the lower shard,
# then the lower local rank, as with lax.top_k.


def _blocks(x, mesh, axis: int = 0) -> list:
    if x is None:
        return [None] * mesh.shape[INDEX_AXIS]
    return (x if isinstance(x, Sharded) else Sharded.split(x, mesh, axis)
            ).blocks


def _shard_rows(n: int, mesh) -> int:
    shards = mesh.shape[INDEX_AXIS]
    if n % shards:
        raise ValueError(f"{n} index rows do not split into {shards} shards")
    return n // shards


def _local_valid(n_valid: Optional[int], s: int, shard_rows: int,
                 n: int) -> Optional[int]:
    """Valid rows of shard s: padding is contiguous at the global tail, so
    shard s holds clip(n_valid - s * shard_rows, 0, shard_rows); a shard
    may be all padding (0).  Padding is masked before the local top-k:
    zero pad rows score 0 and would evict valid negative-score rows."""
    if n_valid is None or n_valid >= n:
        return None
    return min(max(n_valid - s * shard_rows, 0), shard_rows)


def _merge_shards(mesh, parts, k: int, device):
    """parts: (vals, global ids[, certificates]) of this process's shards
    in shard order → the merged (vals, ids[, AND of certificates])."""
    vals = torch.cat([p[0].to(device) for p in parts], dim=1)
    ids = torch.cat([p[1].to(device) for p in parts], dim=1)
    certs = (torch.stack([p[2].to(device) for p in parts], dim=1)
             if len(parts[0]) > 2 else None)
    if mesh.spans_processes:
        vals, ids = all_gather_columns(vals), all_gather_columns(ids)
        if certs is not None:
            certs = all_gather_columns(certs.to(torch.int32)) > 0
    top, pos = topk_lower_index(vals, k)
    out = (top, torch.gather(ids, 1, pos))
    return out if certs is None else out + (certs.all(dim=1),)


def sharded_mips_topk(index, queries, k: int, mesh, *,
                      chunk_rows: int = 4096, n_valid: Optional[int] = None,
                      doc_scales=None):
    """Exact MIPS over an index row-sharded on the mesh's ``index`` axis
    (the JAX package's sharded_mips_topk): shard s runs ``mips_topk`` on
    rows [s * shard_rows, (s + 1) * shard_rows) on its device.  ``index``
    and ``doc_scales`` are global tensors (split here) or
    ``core.mesh.Sharded`` blocks.  Returns (vals (B, k), global row ids
    (B, k) int32) on the queries' device."""
    n = index.shape[0]
    shard_rows = _shard_rows(n, mesh)
    blocks, scales = _blocks(index, mesh), _blocks(doc_scales, mesh)
    parts = []
    for s, dev in mesh.local_shards():
        with on_device(dev):
            v, i = mips_topk(blocks[s], queries.to(dev), k,
                             chunk_rows=chunk_rows, doc_scales=scales[s],
                             n_valid=_local_valid(n_valid, s, shard_rows, n))
        parts.append((v, i + s * shard_rows))
    return _merge_shards(mesh, parts, k, queries.device)


def sharded_mips_topk_pca(index, proj, rot, bounds, queries, k: int, mesh, *,
                          k_chunks: int = 8, cand_rows: int = 512,
                          n_valid: Optional[int] = None, doc_scales=None):
    """Row-sharded PCA-prefiltered search (the JAX package's
    sharded_mips_topk_pca): shard s runs ``mips_topk_pca`` over its rows,
    projections and bounds (split along their chunk axis) with the
    rotation replicated, rescanning ``min(k_chunks, local chunks - 1)``
    chunks.  The merged top-k equals the global exact top-k whenever every
    shard's local top-k was exact, so the certificate is the AND over
    shards.  Returns (vals, global row ids, certified (B,) bool)."""
    n = index.shape[0]
    shard_rows = _shard_rows(n, mesh)
    if shard_rows % cand_rows:
        raise ValueError("cand_rows must divide the per-shard row count")
    local_chunks = shard_rows // cand_rows
    if local_chunks < 2:
        raise ValueError(
            f"each shard holds {local_chunks} candidate chunk(s); the "
            "prefilter needs >= 2 per shard (use fewer shards, smaller "
            "cand_rows, or the plain sharded_mips_topk)")
    kc = min(k_chunks, local_chunks - 1)
    blocks, scales = _blocks(index, mesh), _blocks(doc_scales, mesh)
    projs, bnds = _blocks(proj, mesh), _blocks(bounds, mesh, axis=1)
    parts = []
    for s, dev in mesh.local_shards():
        with on_device(dev):
            v, i, c = mips_topk_pca(
                blocks[s], projs[s], rot.to(dev), bnds[s], queries.to(dev), k,
                k_chunks=kc, cand_rows=cand_rows, doc_scales=scales[s],
                n_valid=_local_valid(n_valid, s, shard_rows, n))
        parts.append((v, i + s * shard_rows, c))
    return _merge_shards(mesh, parts, k, queries.device)


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
