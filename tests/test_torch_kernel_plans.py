"""Launch plans of kernels 1-8, on the CPU.

Each wrapper decides its template (tensor cores, one warp a row, or SIMT),
grid, padding and dynamic shared memory in a plain Python function
(``mips.scan_plan``, ``mips.chunk_max_plan``, ``mips.rescan_plan``,
``fused_attention.attention_plan``), and the C
entry point refuses a plan that disagrees with its own count.  These tests
walk every shape the wrappers accept, so that a plan the card would refuse
(too much shared memory, a grid dimension too large, a misaligned stage)
shows here and not at a launch.  They also read the tile constants out of
the CUDA sources, and drive each wrapper against a stand-in library to
show that it hands the entry point its plan.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu_torch.ops import _build, mips

# the module, not the function the package exports under the same name
fa = importlib.import_module(
    "multihop_dense_retrieval_tpu_torch.ops.fused_attention")

SMEM_LIMIT = 232448        # dynamic shared memory a block may use (H100)
GRID_YZ = 65535            # the largest grid y and z dimensions
CSRC = Path(_build.CSRC)


def _constexpr(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, (source, name, found)
    return int(found[0])


@pytest.mark.parametrize("source,name,value", [
    ("mips_scan_mma.cu", "MT", mips._MMA_ROWS),
    ("mips_scan_mma.cu", "KS", mips._MMA_KS),
    ("mips_scan_mma.cu", "STAGES", mips._MMA_STAGES),
    ("mips_scan_mma.cu", "QN_K2", mips._SCAN_QMAX[2]),
    ("mips_scan_mma.cu", "QN_K4", mips._SCAN_QMAX[4]),
    ("mips_scan_mma.cu", "QN_K8", mips._SCAN_QMAX[8]),
    ("chunk_max_mma.cu", "MT", mips._MMA_ROWS),
    ("chunk_max_mma.cu", "KS", mips._MMA_KS),
    ("chunk_max_mma.cu", "STAGES", mips._MMA_STAGES),
    ("i8_stage.cuh", "MT", mips._MMA_ROWS),
    ("i8_stage.cuh", "KS", mips._I8_KS),
    ("i8_stage.cuh", "STAGES", mips._MMA_STAGES),
    ("mips_scan_i8.cu", "QN_K2", mips._SCAN_QMAX[2]),
    ("mips_scan_i8.cu", "QN_K4", mips._SCAN_QMAX[4]),
    ("mips_scan_i8.cu", "QN_K8", mips._SCAN_QMAX[8]),
    ("rescan_mma.cu", "MAX_QN", mips._MMA_QMAX),
    ("fused_attention.cu", "KSTRIP", fa._KSTRIP),
    ("fused_attention.cu", "ROW_WARPS", fa._ROW_WARPS),
])
def test_plan_constants_match_the_cuda_sources(source, name, value):
    assert _constexpr(source, name) == value


# ---- kernel 8 ---------------------------------------------------------------


def _expected_route(wq, d, dtype):
    if dtype == torch.bfloat16 and wq == 1:
        return "row"
    if dtype == torch.bfloat16 and d >= 16:
        return "mma"
    return "simt"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_attention_plan_fits_every_width(d, dtype):
    """W from 1 to 514, Wq in (W, 1), at roberta-base's 768 width (or
    one head for d = 8 .. 128 alone): the route follows the fixed rule,
    shared memory fits a block, key pads are multiples of 16 that only
    add pad keys, query tiles cover Wq, and the grid fits."""
    b = 256
    max_strips = _constexpr("fused_attention.cu", "MAX_STRIPS")
    for nh in (max(1, 768 // d), 1):
        for w in range(1, fa.MAX_WIDTH + 1):
            for wq in sorted({w, 1}):
                plan = fa.attention_plan(b, wq, w, nh, d, dtype)
                route = plan["route"]
                assert route == _expected_route(wq, d, dtype), (w, wq)
                assert 0 < plan["smem"] <= SMEM_LIMIT, (w, wq, plan)
                assert max(plan["grid"][1:]) <= GRID_YZ
                if route == "mma":
                    kp, rows = plan["key_pad"], 16 * plan["warps"]
                    assert kp % 16 == 0 and w <= kp < w + 16
                    assert -(-kp // fa._KSTRIP) <= max_strips
                    assert plan["warps"] == (8 if w > 64 else 4)
                    assert plan["q_pad"] % rows == 0
                    assert w <= plan["q_pad"] < w + rows
                    assert plan["grid"] == (plan["q_pad"] // rows, nh, b)
                    # every cp.async destination region starts on 16 bytes
                    assert (2 * (d + 8)) % 16 == 0
                    assert (2 * kp * (d + 8)) % 16 == 0
                elif route == "row":
                    assert plan["grid"][0] * fa._ROW_WARPS >= b * nh
                    assert (plan["grid"][0] - 1) * fa._ROW_WARPS < b * nh
                    assert plan["smem"] >= 4 * fa._ROW_WARPS * w
                else:
                    assert plan["q_pad"] % 32 == 0
                    assert wq <= plan["q_pad"] < wq + 32
                    assert plan["grid"] == (b, nh, plan["q_pad"] // 32)


@pytest.mark.parametrize("wq,w,d,dtype,route", [
    (300, 300, 64, torch.bfloat16, "mma"),     # the corpus square
    (350, 350, 64, torch.bfloat16, "mma"),     # the widest hop-2 bucket
    (40, 40, 64, torch.bfloat16, "mma"),       # hop 1
    (1, 300, 64, torch.bfloat16, "row"),       # the cls_only layer
    (1, 1, 64, torch.bfloat16, "row"),
    (128, 128, 64, torch.float32, "simt"),     # fp32: tensor cores are TF32
    (1, 300, 64, torch.float32, "simt"),
    (40, 40, 8, torch.bfloat16, "simt"),       # d = 8 below the k16 step
    (1, 40, 8, torch.bfloat16, "row"),
])
def test_attention_routes(wq, w, d, dtype, route):
    assert fa.attention_plan(192, wq, w, 768 // d, d, dtype)["route"] == route


def test_attention_mma_plan_at_the_widest_shapes():
    """The largest tensor-core block, d = 128 at W = 514 (k_h whole and two
    v strips in rows of 136 bf16, and the biases of nine 64-key strips),
    and the corpus shape's three 8-warp blocks an SM at d = 64, W = 300."""
    wide = fa.attention_plan(1, 514, 514, 6, 128, torch.bfloat16)
    assert wide["smem"] == 2 * (528 + 128) * 136 + 4 * 9 * 64 == 180736
    corpus = fa.attention_plan(256, 300, 300, 12, 64, torch.bfloat16)
    assert corpus["smem"] == 63488 and 3 * corpus["smem"] <= SMEM_LIMIT
    assert corpus["warps"] == 8 and corpus["grid"] == (3, 12, 256)


# ---- kernels 1 and 2 ------------------------------------------------------------

# the int8 templates' shared memory, counted here apart from the plan: the
# ring of 144-byte rows, 4 slots of 128 fp32 row scales, and the resident
# query tile in rows of d + 16 bytes
I8_RING = 4 * 128 * 144
I8_SCALES = 4 * 128 * 4


def _i8_resident_smem(q_tile, d):
    return I8_RING + I8_SCALES + q_tile * (d + 16)


def _i8_streamed_smem(q_tile):
    return 4 * (128 + q_tile) * 144 + I8_SCALES


def _check_splits(plan, n, want):
    """The splits cover the n rows in whole 128-row tiles, none empty, the
    longest as short as `want` splits allow, and at most `want` of them."""
    rows, splits = plan["rows_per_split"], plan["splits"]
    assert rows % 128 == 0 and splits * rows >= n > (splits - 1) * rows
    tiles = -(-n // 128)
    assert rows == 128 * -(-tiles // max(1, want))
    assert splits <= max(1, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
@pytest.mark.parametrize("d", [64, 128, 768, 1024])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_scan_plan_fits_every_batch(k, d, dtype):
    """B from 1 to 512 over 1M rows: bf16 rows and int8 rows of a width
    that is a multiple of 128 take the tensor-core plan (query tiles of 32
    up to the widest for the list length, as few tiles as that allows,
    each padded by fewer than 32 zero rows; one wave of blocks at one block
    an SM; int8 keeps the query tile resident, narrowed in steps of 32
    until it fits beside the ring, and its lists fit the ring they reuse);
    fp32 rows and int8 rows
    of 64 take the SIMT plan (64-query tiles, about 4 blocks an SM).
    Shared memory fits a block, except the SIMT plan at fp32 D = 1024,
    which the wrapper refuses."""
    n, sms = 1 << 20, 132
    kmax = mips._kmax(k)
    for b in range(1, 513):
        plan = mips.scan_plan(b, n, d, dtype, k, sms)
        assert plan["kmax"] == kmax
        assert plan["grid"][0] < 2 ** 31 and plan["grid"][1] <= GRID_YZ
        if dtype == torch.float32 or (dtype == torch.int8 and d % 128):
            assert plan["route"] == "simt" and plan["q_tile"] == 64
            tiles = -(-b // 64)
            assert plan["grid"] == (tiles, plan["splits"], 1)
            _check_splits(plan, n, 4 * sms // tiles)
            words = d * dtype.itemsize // 4
            assert plan["smem"] == 4 * (64 * (words + 4) + 128 * 20)
            assert (plan["smem"] <= SMEM_LIMIT) == (words < 1024)
            continue
        qmax = mips._SCAN_QMAX[kmax]
        while dtype == torch.int8 and _i8_resident_smem(qmax, d) > SMEM_LIMIT:
            qmax -= 32
        tiles = plan["grid"][1]
        assert plan["route"] == "mma"
        assert plan["q_tile"] % 32 == 0 and 32 <= plan["q_tile"] <= qmax
        assert tiles == -(-b // qmax)
        assert plan["q_pad"] == plan["q_tile"] * tiles
        assert b <= plan["q_pad"] < b + 32 * tiles
        assert plan["grid"] == (plan["splits"], tiles, 1)
        _check_splits(plan, n, sms // tiles)
        assert plan["splits"] * tiles <= sms
        q_tile = plan["q_tile"]
        if dtype == torch.int8:
            assert plan["smem"] == _i8_resident_smem(q_tile, d)
            assert 2 * q_tile * kmax * 8 <= I8_RING
        else:
            assert plan["smem"] == (4 * (128 + q_tile) * 72 * 2
                                    + 2 * q_tile * kmax * 8)
        assert plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("d,dtype,route", [
    (768, torch.bfloat16, "mma"), (64, torch.bfloat16, "mma"),
    (96, torch.bfloat16, "simt"), (32, torch.bfloat16, "simt"),
    (768, torch.float32, "simt"), (768, torch.int8, "mma"),
    (64, torch.int8, "simt"), (192, torch.int8, "simt")])
def test_scan_routes_by_dtype_and_width(d, dtype, route):
    """bf16 rows of a width that is not a multiple of the 64-column stage,
    fp32 rows (TF32 on the tensor cores) and int8 rows of a width that is
    not a multiple of the 128-byte stage stay on the SIMT template; D = 768
    int8 rows (kernel 1 on the serving path) take the tensor cores."""
    assert mips.scan_plan(100, 1 << 16, d, dtype, 2)["route"] == route


@pytest.mark.parametrize("k", [1, 2])
def test_int8_scan_plan_at_the_record_shape(k):
    """Kernel 1 at B = 192 over 1M x 768 int8 rows (leg a's hop 1 at k = 1,
    leg d's at k = 2): one 192-wide query tile kept resident (192 x 784
    bytes beside the 72 KiB ring and the 2 KiB of row scales), 131 splits
    of 63 tiles, one wave."""
    plan = mips.scan_plan(192, 1 << 20, 768, torch.int8, k)
    assert plan["route"] == "mma"
    assert plan["q_tile"] == 192 and plan["grid"] == (131, 1, 1)
    assert plan["rows_per_split"] == 63 * 128 and plan["kmax"] == k
    assert plan["smem"] == 73728 + 2048 + 150528 == 226304


@pytest.mark.parametrize("k", [1, 2])
def test_int8_scan_plan_narrows_the_query_tile_to_fit(k):
    """At D = 1024 a 192- or 160-wide query tile does not fit beside the
    ring (192 x 1040 bytes): the plan narrows it to 128, and B = 192 takes
    two tiles of 96 (the fewest tiles of at most 128)."""
    plan = mips.scan_plan(192, 1 << 20, 1024, torch.int8, k)
    assert _i8_resident_smem(160, 1024) > SMEM_LIMIT
    assert plan["route"] == "mma" and plan["q_tile"] == 96
    assert plan["grid"] == (66, 2, 1)
    assert plan["smem"] == 73728 + 2048 + 96 * 1040
    assert mips.scan_plan(128, 1 << 20, 1024, torch.int8, k)["q_tile"] == 128


def test_scan_plan_at_the_path_shapes():
    """The record shape (B = 192, N = 1M, k = 1): one 192-wide query tile,
    131 splits of 63 tiles; the FEVER CLI's hop 1 (B = 100 over 262,144
    rows, k = 2): one 128-wide tile, 128 splits of 16 tiles; k = 8 narrows
    the tile to 64."""
    rec = mips.scan_plan(192, 1 << 20, 768, torch.bfloat16, 1)
    assert rec["q_tile"] == 192 and rec["grid"] == (131, 1, 1)
    assert rec["rows_per_split"] == 63 * 128
    assert rec["smem"] == 4 * 320 * 144 + 2 * 192 * 8 == 187392
    fever = mips.scan_plan(100, 1 << 18, 768, torch.bfloat16, 2)
    assert fever["q_tile"] == 128 and fever["grid"] == (128, 1, 1)
    assert fever["kmax"] == 2 and fever["rows_per_split"] == 2048
    wide = mips.scan_plan(192, 1 << 20, 768, torch.bfloat16, 8)
    assert wide["q_tile"] == 64 and wide["grid"] == (44, 3, 1)


# ---- kernels 6 and 3 ----------------------------------------------------------


@pytest.mark.parametrize("chunk_rows", [512, 2048, 8192])
def test_chunk_max_plan_fits_every_batch(chunk_rows):
    """B from 1 to 512 over a bf16 index: the tensor-core plan takes query
    tiles of 32 to 256 (multiples of 32, so of the mma's 8), as few tiles
    as the 256 cap allows, each padded by fewer than 32 zero rows; shared
    memory fits.  fp32 rows take the SIMT plan (64-query tiles)."""
    n = 4 * chunk_rows
    for b in range(1, 513):
        plan = mips.chunk_max_plan(b, n, 768, chunk_rows, torch.bfloat16)
        tiles = plan["grid"][1]
        assert plan["route"] == "mma"
        assert plan["q_tile"] % 32 == 0 and 32 <= plan["q_tile"] <= 256
        assert tiles == -(-b // 256)
        assert plan["q_pad"] == plan["q_tile"] * tiles
        assert b <= plan["q_pad"] < b + 32 * tiles
        assert plan["grid"] == (n // chunk_rows, tiles, 1)
        assert plan["smem"] <= SMEM_LIMIT
        # the query tile stays resident where it fits beside the ring (at
        # D = 768 up to 96 queries)
        resident = 4 * 128 * 72 * 2 + plan["q_tile"] * 776 * 2 \
            + 2 * plan["q_tile"] * 4
        assert plan["q_resident"] == (resident <= SMEM_LIMIT)
        assert plan["q_resident"] == (plan["q_tile"] <= 96)
        if plan["q_resident"]:
            assert plan["smem"] == resident
        else:        # the streamed template: one block a chunk
            assert plan["per_block"] == 1
        for d in (64, 768):
            simt = mips.chunk_max_plan(b, n, d, chunk_rows, torch.float32)
            assert simt["route"] == "simt" and simt["q_tile"] == 64
            assert b <= simt["q_pad"] < b + 64
            assert simt["smem"] <= SMEM_LIMIT
            assert simt["grid"][0] == simt["q_pad"] // 64
            assert simt["grid"][1] * simt["per_block"] >= n // chunk_rows
        for d in (64, 128, 768, 1024):
            _check_int8_chunk_max_plan(b, n, d, chunk_rows)


def _check_int8_chunk_max_plan(b, n, d, chunk_rows, sms=132):
    """Kernel 7's plan: int8 rows of a width that is a multiple of 128 take
    the int8 tensor-core plan (query tiles as kernel 6's), the query tile
    resident where it fits beside the ring, scales and maxima, with
    consecutive chunks a block in one wave, and streamed otherwise, one
    block a chunk; narrower rows take the SIMT plan."""
    plan = mips.chunk_max_plan(b, n, d, chunk_rows, torch.int8, sms)
    num_chunks = n // chunk_rows
    if d % 128:
        assert plan["route"] == "simt" and plan["q_tile"] == 64
        assert plan["smem"] == 4 * (64 * (d // 4 + 4) + 128 * 20)
        return
    tiles, q_tile = plan["grid"][1], plan["q_tile"]
    assert plan["route"] == "mma"
    assert q_tile % 32 == 0 and 32 <= q_tile <= 256
    assert tiles == -(-b // 256) and plan["q_pad"] == q_tile * tiles
    assert b <= plan["q_pad"] < b + 32 * tiles
    maxima = 2 * q_tile * 4
    resident = _i8_resident_smem(q_tile, d) + maxima
    assert plan["q_resident"] == (resident <= SMEM_LIMIT)
    if plan["q_resident"]:
        assert plan["smem"] == resident
        per = plan["per_block"]
        assert per == -(-num_chunks // (sms // tiles))
        assert plan["grid"][0] * per >= num_chunks > (plan["grid"][0] - 1) * per
        assert plan["grid"][0] * tiles <= sms
    else:
        assert plan["smem"] == _i8_streamed_smem(q_tile) + maxima
        assert plan["per_block"] == 1
        assert plan["grid"] == (num_chunks, tiles, 1)
    assert plan["smem"] <= SMEM_LIMIT


def test_int8_chunk_max_plan_at_leg_d():
    """Kernel 7 at leg d's hop 2 (B = 384 over 1M x 768 int8 rows, 2048-row
    chunks): two 192-wide query tiles kept resident (ring, scales, the tile
    and the maxima in 227,840 bytes), 8 of the 512 chunks a block, 64 x 2
    blocks; at B = 256 the one 256-wide tile is streamed, a block a chunk."""
    plan = mips.chunk_max_plan(384, 1 << 20, 768, 2048, torch.int8)
    assert plan["route"] == "mma" and plan["q_resident"]
    assert plan["q_tile"] == 192 and plan["per_block"] == 8
    assert plan["grid"] == (64, 2, 1)
    assert plan["smem"] == 73728 + 2048 + 150528 + 1536 == 227840
    wide = mips.chunk_max_plan(256, 1 << 20, 768, 2048, torch.int8)
    assert not wide["q_resident"] and wide["grid"] == (512, 1, 1)


def test_chunk_max_plan_at_the_fever_shape():
    """B = 200 (hop 2 of batch 100 x beam 2): one 224-wide query tile, one
    block a 2048-row chunk of the 262,144-row index, the queries streamed;
    also over 1M rows (512 chunks, one a block)."""
    plan = mips.chunk_max_plan(200, 1 << 18, 768, 2048, torch.bfloat16)
    assert plan["q_tile"] == 224 and plan["grid"] == (128, 1, 1)
    assert plan["per_block"] == 1 and not plan["q_resident"]
    assert mips.chunk_max_plan(200, 1 << 20, 768, 2048, torch.bfloat16
                               )["grid"] == (512, 1, 1)
    assert plan["smem"] == 4 * (128 + 224) * 72 * 2 + 2 * 224 * 4
    # the widest query tile still fits a block
    assert mips.chunk_max_plan(256, 1 << 18, 768, 2048,
                               torch.bfloat16)["smem"] == 223232


@pytest.mark.parametrize("r", [64, 96, 128, 256])
def test_pca_chunk_max_plan_fits_every_batch(r):
    """Kernel 3 over a 1M-row projection in 512-row chunks, B from 1 to
    512: widths that are a multiple of 64 take the tensor-core plan with
    the query tile resident in shared memory (it fits up to R = 256 at the
    widest tile) and consecutive chunks a block, one wave at one block an
    SM, every chunk covered once; R = 96 takes the SIMT plan."""
    n, chunk, sms = 1 << 20, 512, 132
    for b in range(1, 513):
        plan = mips.chunk_max_plan(b, n, r, chunk, torch.bfloat16, sms)
        if r % 64:
            assert plan["route"] == "simt" and plan["q_tile"] == 64
            continue
        tiles = plan["grid"][1]
        assert plan["route"] == "mma" and plan["q_resident"]
        assert tiles == -(-b // 256)
        per = plan["per_block"]
        assert per == -(-(n // chunk) // (sms // tiles))
        assert plan["grid"][0] * per >= n // chunk > (plan["grid"][0] - 1) * per
        assert plan["grid"][0] * tiles <= sms
        assert plan["smem"] == (4 * 128 * 72 * 2 + plan["q_tile"] * (r + 8) * 2
                                + 2 * plan["q_tile"] * 4) <= SMEM_LIMIT


def test_pca_chunk_max_plan_at_the_path_shapes():
    """The record shape (B = 192, N = 1M, R = 128, 512-row chunks): 16
    chunks a block, 128 blocks, the 192 x 136 bf16 query tile resident;
    leg c2's hop 2 (B = 200 over 262,144 rows): a 224-wide tile, 4 chunks
    a block."""
    rec = mips.chunk_max_plan(192, 1 << 20, 128, 512, torch.bfloat16)
    assert rec["per_block"] == 16 and rec["grid"] == (128, 1, 1)
    assert rec["q_resident"] and rec["smem"] == 73728 + 52224 + 1536
    c2 = mips.chunk_max_plan(200, 1 << 18, 128, 512, torch.bfloat16)
    assert c2["q_tile"] == 224 and c2["per_block"] == 4
    assert c2["grid"] == (128, 1, 1)


@pytest.mark.parametrize("d,route", [(768, "mma"), (64, "mma"), (96, "simt"),
                                     (32, "simt")])
def test_chunk_max_routes_by_row_width(d, route):
    """bf16 rows whose width is not a multiple of the 64-column stage stay
    on the SIMT template (which takes rows of 64-byte multiples)."""
    plan = mips.chunk_max_plan(200, 8192, d, 2048, torch.bfloat16)
    assert plan["route"] == route
    if route == "simt":
        assert plan["smem"] == 4 * (64 * (d // 2 + 4) + 128 * 20)


def test_chunk_max_rejects_chunks_off_the_row_tile():
    with pytest.raises(ValueError, match="multiple of 128"):
        mips._check_chunks(4096, 192)
    with pytest.raises(ValueError, match="dividing"):
        mips._check_chunks(5000, 1024)


# ---- kernels 4 and 5 ---------------------------------------------------------


def _rescan_route(d, dtype):
    if dtype == torch.int8 and d % 128 == 0:
        return "mma"
    if dtype == torch.bfloat16 and d % 64 == 0:
        return "mma"
    return "simt"


def _check_rescan_plan(plan, b, kc, n, cand, d, dtype):
    assert plan["route"] == _rescan_route(d, dtype), (b, kc, cand, d, dtype)
    if plan["route"] == "simt":
        assert plan["grid"] == (kc, b, 1)
        return
    row_bytes = d * dtype.itemsize
    q_tile, rows, splits = plan["q_tile"], plan["rows_per_split"], \
        plan["splits"]
    assert q_tile % 32 == 0 and 32 <= q_tile <= 256
    assert plan["smem"] == mips._rescan_smem(q_tile, row_bytes,
                                             dtype == torch.int8)
    assert plan["smem"] <= SMEM_LIMIT, (b, kc, cand, d, dtype, plan)
    # a wider tile only where a narrower one would not cover b * kc slots
    assert q_tile == 32 or q_tile - 32 < b * kc
    assert rows % 128 == 0 and 128 <= rows <= -(-cand // 128) * 128
    assert splits * rows >= cand and (splits - 1) * rows < cand
    assert 1 <= plan["groups"] <= mips._RESCAN_GROUPS
    assert plan["grid"] == (n // cand, splits * plan["groups"], 1)
    assert plan["grid"][1] <= GRID_YZ
    # every chunk streams its 16-byte pieces through 128-byte k-slices
    assert row_bytes % mips._I8_KS == 0


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 768, 1024])
@pytest.mark.parametrize("cand", [128, 512, 2048])
def test_rescan_plan_fits_every_batch(cand, d, dtype):
    """B from 1 to 512, kc in (1, 8, 16, 20), over 16 chunks and over 1M
    rows: the route follows the width rule (int8 rows a multiple of 128
    bytes and bf16 rows of 64 elements on the tensor cores, fp32 and the
    rest on SIMT), shared memory fits a block, the row ranges cover a
    chunk with none empty, and the grid fits."""
    for n in (16 * cand, 1 << 20):
        for kc in (1, 8, 16, 20):
            for b in range(1, 513):
                plan = mips.rescan_plan(b, kc, n, cand, d, dtype)
                _check_rescan_plan(plan, b, kc, n, cand, d, dtype)


def _rescan_writes(ids, plan, cand):
    """How often the tensor-core template's schedule writes each (slot,
    row) of the (B * kc, cand) output: block (c, s + splits * g) ranks the
    slots that selected chunk c and takes their query tiles g, g + groups,
    ... over its row range, as csrc/rescan_mma.cu does."""
    flat = ids.reshape(-1)
    qn, rows = plan["q_tile"], plan["rows_per_split"]
    splits, groups = plan["splits"], plan["groups"]
    writes = np.zeros((flat.size, cand), np.int32)
    for c in range(plan["grid"][0]):
        slots = np.flatnonzero(flat == c)
        for y in range(plan["grid"][1]):
            s, g = y % splits, y // splits
            r0, r1 = s * rows, min(cand, (s + 1) * rows)
            for p0 in range(g * qn, slots.size, groups * qn):
                writes[slots[p0:p0 + qn], r0:r1] += 1
    return writes


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("b,kc,n,cand,layout", [
    (192, 8, 1 << 20, 512, "random"),      # leg a
    (192, 8, 1 << 20, 512, "planted"),     # leg a's planted chunk
    (384, 20, 1 << 20, 2048, "planted"),   # leg d
    (200, 20, 1 << 18, 2048, "random"),    # leg c1
    (200, 16, 1 << 18, 512, "random"),     # leg c2
    (512, 20, 1 << 15, 2048, "one"),       # every slot on one chunk
    (96, 16, 96 * 16 * 128, 128, "distinct"),
    (7, 8, 1 << 15, 2048, "random"),       # few chunks: rows split
    (1, 1, 1 << 12, 128, "random"),
    (256, 16, 1 << 15, 2048, "every"),     # leg l2: every query, every chunk
    (256, 8, 1 << 15, 4096, "every"),
    (256, 16, 1 << 15, 512, "random"),     # leg l2 --pca
    (256, 100, 1 << 18, 2048, "ranked"),   # leg l1: kc = 100 of 128 chunks
])
def test_rescan_schedule_covers_every_slot(b, kc, n, cand, layout, dtype):
    """Every (slot, row) of the output is written exactly once by the
    planned grid, whether the slots are spread at random, all distinct, all
    on one chunk (ids repeated within each row), one chunk is selected
    by every query beside random others (as the legs' planted rows make
    it), or every query selects every chunk (leg l's top 100)."""
    rng = np.random.RandomState(b + kc)
    chunks = n // cand
    if layout == "distinct":
        ids = rng.permutation(chunks)[:b * kc].reshape(b, kc)
    elif layout in ("every", "ranked"):
        # each query's own chunk order, as its top-kc chunk maxima give it
        ids = np.stack([rng.permutation(chunks)[:kc] for _ in range(b)])
    elif layout == "one":
        ids = np.full((b, kc), chunks // 2)
    else:
        ids = np.stack([rng.choice(chunks, kc, replace=False)
                        for _ in range(b)])
        if layout == "planted":
            ids[:, 0] = chunks // 3
    plan = mips.rescan_plan(b, kc, n, cand, 768, dtype)
    assert plan["route"] == "mma"
    assert (_rescan_writes(ids, plan, cand) == 1).all()


def test_rescan_plans_at_the_path_shapes():
    """The measured choices (NVIDIA H100 80GB HBM3, PERF.md): 32-slot
    query tiles on legs a, d and c2, where a chunk holds 1-15 slots on
    average, 64 on c1 (31); four blocks share the query tiles of a chunk
    that every query selects; leg d's 2048-row chunks split in 512-row
    ranges, as does a chunk of few chunks."""
    def plan(*a):
        p = mips.rescan_plan(*a)
        return p["q_tile"], p["rows_per_split"], p["splits"], p["groups"]
    assert plan(192, 8, 1 << 20, 512, 768, torch.int8) == (32, 512, 1, 4)
    assert plan(384, 20, 1 << 20, 2048, 768, torch.int8) == (32, 512, 4, 4)
    assert plan(200, 20, 1 << 18, 2048, 768, torch.bfloat16) == (64, 2048,
                                                                 1, 4)
    assert plan(200, 16, 1 << 18, 512, 768, torch.bfloat16) == (32, 512,
                                                                1, 4)
    assert plan(200, 8, 1 << 15, 2048, 768, torch.bfloat16) == (96, 256,
                                                                8, 3)


def test_plans_at_leg_l_top_100():
    """cli/eval_retrieval at its defaults (batch 256, top 100, D = 768).
    l2, e2's 32,768 int8 rows: the chunk rule (the JAX package's VMEM
    budget of 12 MiB for a 256-query block) gives 2048-row chunks, so
    kernel 7 streams the one 256-wide query tile through 16
    blocks and kernel 4 takes 192-slot tiles, two blocks sharing a chunk's
    two tiles, its rows in eight 256-row ranges (16 x 16 blocks); at 4096
    rows a chunk, 16 ranges.  l1, c's 262,144 bf16 rows: 128 chunks of
    2048, kernel 6 streamed a block a chunk, kernel 5 at kc = 100 in
    96-slot tiles (200 slots a chunk on average), three blocks a chunk.
    --pca (R = 128, 512-row candidates, kc = 16): kernel 3 keeps the
    256-wide tile resident (4 chunks a block over 512 chunks, one a block
    over 64), the rescans take 32-slot (bf16) and 96-slot (int8) tiles."""
    bf16, int8 = torch.bfloat16, torch.int8
    assert mips.two_phase_chunk(1 << 15, 256, 768, 1, 100, 4096) == 2048
    assert mips.two_phase_chunk(1 << 18, 256, 768, 2, 100, 4096) == 2048
    assert mips.auto_chunk_rows(256, 768, 1) == 2048
    # bf16 2048-row chunks fill the budget exactly; int8 4096-row ones
    # overflow it by the score matrix alone
    assert 2 * 2048 * 768 * 2 + 3 * 256 * 2048 * 4 == mips.VMEM_BUDGET
    assert 2 * 4096 * 768 + 3 * 256 * 4096 * 4 > mips.VMEM_BUDGET

    def plan(fn, *a, keys=("q_tile", "groups", "grid", "smem")):
        p = fn(*a)
        assert p["route"] == "mma" and p["smem"] <= SMEM_LIMIT
        return tuple(p[k] for k in keys)
    cm = ("q_tile", "per_block", "q_resident", "grid", "smem")
    assert plan(mips.chunk_max_plan, 256, 1 << 15, 768, 2048, int8,
                keys=cm) == (256, 1, False, (16, 1, 1), 225280)
    assert plan(mips.chunk_max_plan, 256, 1 << 15, 768, 4096, int8,
                keys=cm) == (256, 1, False, (8, 1, 1), 225280)
    assert plan(mips.rescan_plan, 256, 16, 1 << 15, 2048, 768, int8) == \
        (192, 2, (16, 16, 1), 227136)
    assert mips.rescan_plan(256, 16, 1 << 15, 2048, 768, int8)[
        "rows_per_split"] == 256
    assert plan(mips.rescan_plan, 256, 8, 1 << 15, 4096, 768, int8) == \
        (192, 2, (8, 32, 1), 227136)
    assert plan(mips.chunk_max_plan, 256, 1 << 18, 768, 2048, bf16,
                keys=cm) == (256, 1, False, (128, 1, 1), 223232)
    assert plan(mips.rescan_plan, 256, 100, 1 << 18, 2048, 768, bf16) == \
        (96, 3, (128, 3, 1), 223168)
    assert plan(mips.chunk_max_plan, 256, 1 << 18, 128, 512, bf16,
                keys=cm) == (256, 4, True, (128, 1, 1), 145408)
    assert plan(mips.chunk_max_plan, 256, 1 << 15, 128, 512, bf16,
                keys=cm) == (256, 1, True, (64, 1, 1), 145408)
    assert plan(mips.rescan_plan, 256, 16, 1 << 18, 512, 768, bf16) == \
        (32, 4, (512, 4, 1), 123584)
    assert plan(mips.rescan_plan, 256, 16, 1 << 15, 512, 768, int8) == \
        (96, 3, (64, 6, 1), 151488)


# ---- the wrappers hand their plan to the entry point --------------------------


class _Lib:
    """Stands in for a loaded kernel library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((fn, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, against a stand-in library
    (nothing is launched)."""
    lib = _Lib()
    for mod in (mips, fa):
        monkeypatch.setattr(mod, "_on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "_stream", lambda: 0)
    monkeypatch.setattr(mips, "_sms", lambda device: 132)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    mips.reset_launch_counts()
    yield lib
    mips.reset_launch_counts()


@pytest.mark.parametrize("wq,w,d,dtype", [
    (300, 300, 64, torch.bfloat16), (1, 300, 64, torch.bfloat16),
    (40, 40, 8, torch.bfloat16), (128, 128, 64, torch.float32),
])
def test_fused_attention_passes_its_plan(fake_card, wq, w, d, dtype):
    b, nh = 2, 768 // d
    q = torch.zeros(b, wq, 768, dtype=dtype)
    k = torch.zeros(b, w, 768, dtype=dtype)
    mask = torch.ones(b, w, dtype=torch.int32)
    fa.fused_attention(q, k, k.clone(), mask, nh)
    plan = fa.attention_plan(b, wq, w, nh, d, dtype)
    (fn, args), = fake_card.calls
    assert fn == "fused_attention"
    assert args[:2] == (fa._ROUTES[plan["route"]], plan["warps"])
    assert args[7:12] == (b, wq, w, nh, d) and args[13] == plan["smem"]
    assert mips.LAUNCHES["fused_attention"] == 1


def test_chunk_max_routes_bf16_to_the_tensor_cores(fake_card):
    q = torch.zeros(200, 768, dtype=torch.bfloat16)
    index = torch.zeros(8192, 768, dtype=torch.bfloat16)
    mips.chunk_max(q, index, 2048, 7000)
    plan = mips.chunk_max_plan(200, 8192, 768, 2048, torch.bfloat16)
    (fn, args), = fake_card.calls
    assert fn == "chunk_max_mma"
    assert args[2:9] == (200, 8192, 7000, 768, 2048, plan["q_tile"],
                         plan["smem"])
    assert mips.LAUNCHES["chunk_max"] == 1


def test_pca_chunk_max_routes_to_the_tensor_cores(fake_card):
    qp = torch.zeros(200, 128, dtype=torch.bfloat16)
    proj = torch.zeros(8192, 128, dtype=torch.bfloat16)
    mips.pca_chunk_max(qp, proj, 512, 8000)
    plan = mips.chunk_max_plan(200, 8192, 128, 512, torch.bfloat16)
    (fn, args), = fake_card.calls
    assert fn == "chunk_max_mma"
    assert args[2:11] == (200, 8192, 8000, 128, 512, plan["q_tile"],
                          plan["smem"], plan["per_block"], 1)
    assert mips.LAUNCHES["pca_chunk_max"] == 1


def test_pca_chunk_max_keeps_narrow_widths_on_simt(fake_card):
    qp = torch.zeros(3, 96, dtype=torch.bfloat16)
    mips.pca_chunk_max(qp, torch.zeros(1024, 96, dtype=torch.bfloat16), 512)
    (fn, args), = fake_card.calls
    assert fn == "chunk_max" and args[0] == 1
    assert mips.LAUNCHES["pca_chunk_max"] == 1


@pytest.mark.parametrize("k", [1, 2, 8])
def test_mips_scan_routes_bf16_to_the_tensor_cores(fake_card, k):
    q = torch.zeros(100, 768)
    index = torch.zeros(8192, 768, dtype=torch.bfloat16)
    out = mips.mips_scan(q, index, k, 8000)
    plan = mips.scan_plan(100, 8192, 768, torch.bfloat16, k)
    (fn, args), = fake_card.calls
    assert fn == "mips_scan_mma"
    assert args[2:12] == (100, 8192, 8000, 768, k, plan["kmax"],
                          plan["q_tile"], plan["rows_per_split"],
                          plan["splits"], plan["smem"])
    assert [tuple(t.shape) for t in out] == [(100, k), (100, k)]
    assert mips.LAUNCHES["mips_scan"] == 1


@pytest.mark.parametrize("b,k", [(192, 1), (192, 2), (100, 4), (70, 8)])
def test_mips_scan_int8_routes_to_the_int8_tensor_cores(fake_card, b, k):
    qi = torch.zeros(b, 768, dtype=torch.int8)
    qs = torch.ones(b)
    index = torch.zeros(8192, 768, dtype=torch.int8)
    out = mips.mips_scan_int8(qi, qs, index, torch.ones(8192), k, 8000)
    plan = mips.scan_plan(b, 8192, 768, torch.int8, k)
    (fn, args), = fake_card.calls
    assert fn == "mips_scan_i8"
    assert args[4:14] == (b, 8192, 8000, 768, k, plan["kmax"],
                          plan["q_tile"], plan["rows_per_split"],
                          plan["splits"], plan["smem"])
    assert [tuple(t.shape) for t in out] == [(b, k), (b, k)]
    assert mips.LAUNCHES["mips_scan_int8"] == 1


def test_mips_scan_int8_keeps_narrow_rows_on_simt(fake_card):
    qi = torch.zeros(5, 64, dtype=torch.int8)
    mips.mips_scan_int8(qi, torch.ones(5), torch.zeros(4096, 64,
                        dtype=torch.int8), torch.ones(4096), 3)
    plan = mips.scan_plan(5, 4096, 64, torch.int8, 3)
    (fn, args), = fake_card.calls
    assert fn == "mips_scan_topk" and args[4] == 0
    assert args[9:13] == (plan["splits"], plan["rows_per_split"], 3, 4)
    assert mips.LAUNCHES["mips_scan_int8"] == 1


@pytest.mark.parametrize("b,resident", [(384, 1), (256, 0)])
def test_chunk_max_int8_routes_to_the_int8_tensor_cores(fake_card, b,
                                                        resident):
    qi = torch.zeros(b, 768, dtype=torch.int8)
    index = torch.zeros(8192, 768, dtype=torch.int8)
    mips.chunk_max_int8(qi, index, torch.ones(8192), 2048, 7000)
    plan = mips.chunk_max_plan(b, 8192, 768, 2048, torch.int8)
    (fn, args), = fake_card.calls
    assert fn == "chunk_max_i8"
    assert args[3:12] == (b, 8192, 7000, 768, 2048, plan["q_tile"],
                          plan["smem"], plan["per_block"], resident)
    assert mips.LAUNCHES["chunk_max_int8"] == 1


def test_chunk_max_int8_keeps_narrow_rows_on_simt(fake_card):
    qi = torch.zeros(3, 64, dtype=torch.int8)
    mips.chunk_max_int8(qi, torch.zeros(4096, 64, dtype=torch.int8),
                        torch.ones(4096), 1024)
    (fn, args), = fake_card.calls
    assert fn == "chunk_max" and args[0] == 0
    assert mips.LAUNCHES["chunk_max_int8"] == 1


def test_int8_kernels_refuse_misaligned_rows(fake_card):
    """The int8 templates copy 16-byte pieces: rows that start off a
    16-byte boundary raise, and nothing is launched or counted."""
    flat = torch.zeros(4096 * 768 + 8, dtype=torch.int8)
    index = flat[8:].view(4096, 768)
    assert index.data_ptr() % 16 == 8
    qi = torch.zeros(4, 768, dtype=torch.int8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mips.mips_scan_int8(qi, torch.ones(4), index, torch.ones(4096), 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mips.chunk_max_int8(qi, index, torch.ones(4096), 2048)
    assert not fake_card.calls
    assert mips.LAUNCHES["mips_scan_int8"] == mips.LAUNCHES["chunk_max_int8"] == 0


@pytest.mark.parametrize("b,kc,cand", [(192, 8, 512), (384, 20, 2048)])
def test_pca_rescan_int8_routes_to_the_int8_tensor_cores(fake_card, b, kc,
                                                         cand):
    qi = torch.zeros(b, 768, dtype=torch.int8)
    index = torch.zeros(1 << 16, 768, dtype=torch.int8)
    ids = torch.zeros(b, kc, dtype=torch.int64)
    out = mips.pca_rescan_int8(ids, qi, index, torch.ones(1 << 16), cand,
                               60000)
    plan = mips.rescan_plan(b, kc, 1 << 16, cand, 768, torch.int8)
    (fn, args), = fake_card.calls
    assert fn == "rescan_mma" and args[0] == 0
    assert args[5:16] == (b, kc, 1 << 16, 60000, 768, cand,
                              plan["q_tile"], plan["rows_per_split"],
                              plan["splits"], plan["groups"], plan["smem"])
    assert tuple(out.shape) == (b, kc * cand)
    assert mips.LAUNCHES["pca_rescan_int8"] == 1


def test_rescan_routes_bf16_to_the_tensor_cores(fake_card):
    q = torch.zeros(200, 768)
    index = torch.zeros(1 << 15, 768, dtype=torch.bfloat16)
    ids = torch.zeros(200, 20, dtype=torch.int32)
    mips.rescan(ids, q, index, 2048)
    plan = mips.rescan_plan(200, 20, 1 << 15, 2048, 768, torch.bfloat16)
    (fn, args), = fake_card.calls
    assert fn == "rescan_mma" and args[0] == 1 and args[4] is None
    assert args[5:16] == (200, 20, 1 << 15, 1 << 15, 768, 2048,
                          plan["q_tile"], plan["rows_per_split"],
                          plan["splits"], plan["groups"], plan["smem"])
    assert mips.LAUNCHES["rescan"] == 1


@pytest.mark.parametrize("d,dtype,code", [(768, torch.float32, 2),
                                          (96, torch.bfloat16, 1),
                                          (64, torch.int8, 0)])
def test_rescan_keeps_fp32_and_narrow_rows_on_simt(fake_card, d, dtype, code):
    q = torch.zeros(5, d, dtype=dtype)
    index = torch.zeros(4096, d, dtype=dtype)
    ids = torch.zeros(5, 3, dtype=torch.int32)
    if dtype == torch.int8:
        mips.pca_rescan_int8(ids, q, index, torch.ones(4096), 512)
    else:
        mips.rescan(ids, q, index, 512)
    (fn, args), = fake_card.calls
    assert fn == "rescan" and args[0] == code
    assert args[5:10] == (5, 3, d * dtype.itemsize // 4, 512, 4096)


def test_rescan_refuses_misaligned_rows_and_mismatched_queries(fake_card):
    """The tensor-core template copies 16-byte pieces: rows that start off a
    16-byte boundary raise, as do queries of another width, and nothing is
    launched or counted."""
    flat = torch.zeros(4096 * 768 + 8, dtype=torch.int8)
    index = flat[8:].view(4096, 768)
    ids = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mips.pca_rescan_int8(ids, torch.zeros(4, 768, dtype=torch.int8),
                             index, torch.ones(4096), 512)
    with pytest.raises(ValueError, match="do not match"):
        mips.rescan(ids, torch.zeros(4, 512),
                    torch.zeros(4096, 768, dtype=torch.bfloat16), 512)
    assert not fake_card.calls
    assert mips.LAUNCHES["pca_rescan_int8"] == mips.LAUNCHES["rescan"] == 0


def test_mips_scan_keeps_fp32_on_simt(fake_card):
    q = torch.zeros(70, 128)
    mips.mips_scan(q, torch.zeros(4096, 128), 3)
    plan = mips.scan_plan(70, 4096, 128, torch.float32, 3)
    (fn, args), = fake_card.calls
    assert fn == "mips_scan_topk" and args[4] == 2
    assert args[9:13] == (plan["splits"], plan["rows_per_split"], 3, 4)
    assert mips.LAUNCHES["mips_scan"] == 1


def test_mips_scan_refuses_fp32_rows_too_wide_for_a_block(fake_card):
    with pytest.raises(ValueError, match="shared memory"):
        mips.mips_scan(torch.zeros(4, 1024), torch.zeros(512, 1024), 1)
    assert not fake_card.calls and mips.LAUNCHES["mips_scan"] == 0
