"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving path does not reach (ragged query tiles, every
k, masked tails, fp32 rows, one chunk, k = the number of chunks, exact
ties across the tensor-core templates' lanes, warps and splits, the int8
extremes).  These
need a GPU and skip without one; run them there with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(--noconftest: the suite's conftest configures JAX, which the GPU host
lacks).

Tolerances: int8 results bit-equal; bf16/fp32 values to 1e-4 absolute
(fp32 sums in another order) with ids equal — the inputs are integers
scaled so that no two scores tie within that tolerance.  Kernel 8 (fused
attention): see ``assert_attention_close``.
"""

import pytest
import torch

from multihop_dense_retrieval_tpu_torch.ops import mips

pytestmark = pytest.mark.cuda

# kernels 1 and 2 on the tensor cores: 20,480 rows make 80 splits of 256
# rows (two 128-row tiles each) at one query tile; copies of the best row
# sit in another lane (3, 4), the same thread's other half (11), the other
# row warp (70), the next tile (131), the next split (261), far on (5000)
# and at the last valid row; one more past n_valid must never enter
_TIE_ROWS = (3, 4, 11, 70, 131, 261, 5000)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("b,n,k,n_valid", [(1, 640, 1, None),
                                           (70, 5000, 3, 4321),
                                           (129, 20480, 7, 20000),
                                           (8, 300, 6, 4)])
def test_int8_scan_matches_plain(dev, b, n, k, n_valid):
    g = _gen(dev, b + n)
    idx = torch.randint(-127, 128, (n, 128), device=dev, generator=g,
                        dtype=torch.int8)
    idx[n // 2] = idx[1]
    dsc = torch.rand(n, device=dev, generator=g) + 0.01
    dsc[n // 2] = dsc[1]
    qi, qs = mips.quantize_rows(torch.randn(b, 128, device=dev, generator=g))
    kv, ki = mips.mips_scan_int8(qi, qs, idx, dsc, k, n_valid)
    pv, pi = mips.mips_scan_int8_plain(qi, qs, idx, dsc, k, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def _int8_planted(dev, g, b, n, d, n_valid, rows):
    """Index rows over the whole int8 range (-128 included) with scales in
    [0.5, 1), queries of 0..127 with their own scales, and a best row of
    127s with scale 1 planted at `rows` and once more at n_valid (past the
    valid rows): every query's best score, 127 * sum(q) before the scales,
    is reached by the copies alone, as exact ties."""
    idx = torch.randint(-128, 128, (n, d), device=dev, generator=g,
                        dtype=torch.int8)
    dsc = torch.rand(n, device=dev, generator=g) * 0.5 + 0.5
    planted = list(rows) + [n_valid]
    idx[planted] = 127
    dsc[planted] = 1.0
    q = torch.randint(0, 128, (b, d), device=dev, generator=g,
                      dtype=torch.int8)
    qs = torch.rand(b, device=dev, generator=g) * 0.01 + 1e-3
    return idx, dsc, q, qs


# kernel 1 on the int8 tensor cores: 20,480 rows make splits of 256 to 1,024
# rows (two to eight 128-row tiles) as the query tiles narrow with k; the
# copies of the best row sit as kernel 2's do (_TIE_ROWS below)
@pytest.mark.parametrize("d", [128, 768, 1024])
@pytest.mark.parametrize("k", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("b", [1, 70, 192, 200, 384])
def test_int8_scan_on_the_tensor_cores_matches_plain(dev, b, k, d):
    """Kernel 1's int8 tensor-core template against its plain version, bit
    for bit: eight copies of the best row planted across lanes, the two
    halves of a thread, the row warps, tiles and splits, and a ninth past
    n_valid, which cuts inside a row tile; they must come back in row
    order.  The query tile stays in shared memory: at D = 1024 and k <= 2
    the plan narrows it to 128 (192 does not fit beside the ring); B = 192
    to 384 take two to six query tiles."""
    g = _gen(dev, 1000 * b + 10 * k + d)
    n, n_valid = 20480, 20000
    plan = mips.scan_plan(b, n, d, torch.int8, k, mips._sms(dev))
    assert plan["route"] == "mma"
    want = list(_TIE_ROWS) + [n_valid - 1]
    idx, dsc, q, qs = _int8_planted(dev, g, b, n, d, n_valid, want)
    mips.reset_launch_counts()
    kv, ki = mips.mips_scan_int8(q, qs, idx, dsc, k, n_valid)
    pv, pi = mips.mips_scan_int8_plain(q, qs, idx, dsc, k, n_valid)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["mips_scan_int8"] == 1
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert ki.tolist() == [want[:k]] * b


@pytest.mark.parametrize("k", [1, 3, 8])
def test_int8_scan_with_fewer_valid_rows_than_k(dev, k):
    """Two valid rows: the int8 tensor-core scan returns them, then
    (NEG_INF, 0) fillers, as the plain version and the JAX merge do."""
    g = _gen(dev, 30 + k)
    idx = torch.randint(-128, 128, (1024, 128), device=dev, generator=g,
                        dtype=torch.int8)
    dsc = torch.rand(1024, device=dev, generator=g) + 0.01
    qi, qs = mips.quantize_rows(torch.randn(40, 128, device=dev, generator=g))
    kv, ki = mips.mips_scan_int8(qi, qs, idx, dsc, k, 2)
    pv, pi = mips.mips_scan_int8_plain(qi, qs, idx, dsc, k, 2)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert bool((ki[:, 2:] == 0).all()) and bool((kv[:, 2:] == -3.0e38).all())


@pytest.mark.parametrize("d", [128, 768, 1024])
def test_int8_extremes_match_plain(dev, d):
    """Queries of +-127 only, index rows of -128 only and of 127 only
    beside the whole int8 range: the largest raw dots (127 * 128 * 1024 <
    2^24, exact in the plain fp32 sums too) through kernels 1 (k = 8) and
    7, bit-equal to their plain versions."""
    g = _gen(dev, d + 5)
    n, b = 8192, 70
    idx = torch.randint(-128, 128, (n, d), device=dev, generator=g,
                        dtype=torch.int8)
    idx[:10] = -128
    idx[4000:4010] = 127
    dsc = torch.rand(n, device=dev, generator=g) + 0.01
    sign = torch.randint(0, 2, (b, d), device=dev, generator=g) * 2 - 1
    q = (127 * sign).to(torch.int8)
    qs = torch.rand(b, device=dev, generator=g) + 0.01
    kv, ki = mips.mips_scan_int8(q, qs, idx, dsc, 8, n - 3)
    pv, pi = mips.mips_scan_int8_plain(q, qs, idx, dsc, 8, n - 3)
    got = mips.chunk_max_int8(q, idx, dsc, 512, n - 3)
    exp = mips.chunk_max_plain(q, idx, 512, n - 3, dsc)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert torch.equal(got, exp)


@pytest.mark.parametrize("d", [128, 768, 1024])
@pytest.mark.parametrize("b", [1, 70, 192, 200, 384])
def test_int8_chunk_max_on_the_tensor_cores_matches_plain(dev, b, d):
    """Kernel 7's int8 tensor-core template against its plain version, bit
    for bit, over 256 chunks of 512 rows: resident query tiles walk
    several chunks a block, streamed ones (D = 1024 at 192 queries a tile,
    B = 200 at D = 768) one; n_valid cuts chunk 254 mid-way and leaves
    chunk 255 with no valid row (NEG_INF).  Eight copies of the best row
    (in two lanes, two halves and two row warps of chunk 0, and chunks 1,
    9, 128 and 254) give their chunks the best score exactly; a ninth past
    n_valid must not count."""
    g = _gen(dev, 7 * b + d)
    n, chunk = 1 << 17, 512
    n_valid = n - chunk - 100
    plan = mips.chunk_max_plan(b, n, d, chunk, torch.int8, mips._sms(dev))
    assert plan["route"] == "mma"
    rows = (3, 4, 11, 70, 600, 5000, 66000, n_valid - 1)
    idx, dsc, q, _ = _int8_planted(dev, g, b, n, d, n_valid, rows)
    mips.reset_launch_counts()
    got = mips.chunk_max_int8(q, idx, dsc, chunk, n_valid)
    exp = mips.chunk_max_plain(q, idx, chunk, n_valid, dsc)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["chunk_max_int8"] == 1
    assert torch.equal(got, exp)
    assert bool((got[:, -1] == -3.0e38).all())
    best = 127 * q.float().sum(1)
    for r in rows:
        assert torch.equal(got[:, r // chunk], best), r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,k", [(5, 1000, 1), (64, 4096, 4), (100, 3000, 7)])
def test_float_scan_matches_plain(dev, dtype, b, n, k):
    g = _gen(dev, n)
    # small integers: bf16/fp32 products and sums are exact, so the
    # kernel and the plain version agree exactly whatever their order
    idx = torch.randint(-8, 9, (n, 64), device=dev, generator=g).to(dtype)
    q = torch.randint(-8, 9, (b, 64), device=dev, generator=g).float()
    kv, ki = mips.mips_scan(q, idx, k, n - 7)
    pv, pi = mips.mips_scan_plain(q, idx, k, n - 7)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)




@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("b", [1, 33, 100, 192, 257])
def test_bf16_scan_on_the_tensor_cores_matches_plain(dev, b, k):
    """Kernel 2's tensor-core template against its plain version, bit for
    bit: queries of 0..8 and rows of -8..8 (every product and sum an exact
    integer, whatever the order), and a best row of 8s planted at
    _TIE_ROWS, at the last valid row and past it, so that the top ranks
    are exact ties that must come back in row order across lanes, warps,
    tiles and splits; n_valid cuts inside a row tile and a split; B off
    the query tiles (33, 100, 257) and k at every list length."""
    g = _gen(dev, 100 * b + k)
    n, d, n_valid = 20480, 128, 20000
    assert mips.scan_plan(b, n, d, torch.bfloat16, k)["route"] == "mma"
    idx = torch.randint(-8, 9, (n, d), device=dev, generator=g).to(
        torch.bfloat16)
    idx[list(_TIE_ROWS) + [n_valid - 1, n_valid]] = 8
    q = torch.randint(0, 9, (b, d), device=dev, generator=g).float()
    mips.reset_launch_counts()
    kv, ki = mips.mips_scan(q, idx, k, n_valid)
    pv, pi = mips.mips_scan_plain(q, idx, k, n_valid)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["mips_scan"] == 1
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    # 8 * sum(q) is every query's best score, reached only by the copies
    want = list(_TIE_ROWS) + [n_valid - 1]
    assert ki.tolist() == [want[:k]] * b


@pytest.mark.parametrize("k", [1, 3, 8])
def test_bf16_scan_with_fewer_valid_rows_than_k(dev, k):
    """Two valid rows: the tensor-core scan returns them, then (NEG_INF, 0)
    fillers, as the plain version and the JAX merge do."""
    g = _gen(dev, k)
    idx = torch.randint(-8, 9, (1024, 64), device=dev, generator=g).to(
        torch.bfloat16)
    q = torch.randint(-8, 9, (40, 64), device=dev, generator=g).float()
    kv, ki = mips.mips_scan(q, idx, k, 2)
    pv, pi = mips.mips_scan_plain(q, idx, k, 2)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert bool((ki[:, 2:] == 0).all()) and bool((kv[:, 2:] == -3.0e38).all())


@pytest.mark.parametrize("b,n,k", [(192, 65536, 1), (100, 1 << 18, 2),
                                   (64, 20000, 8)])
def test_bf16_scan_values_within_rtol(dev, b, n, k):
    """N(0, 1) data at D = 768 (the paths' width): the tensor-core scan
    chooses rows by its own sums and returns them rescored in fp32, so
    values are within rtol 1e-5 of the plain scan's (fp32 sums in another
    order) and ids equal apart from near-ties within that tolerance."""
    g = _gen(dev, n + k)
    idx = torch.randn(n, 768, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn(b, 768, device=dev, generator=g)
    kv, ki = mips.mips_scan(q, idx, k, n - 5)
    pv, pi = mips.mips_scan_plain(q, idx, k, n - 5)
    torch.cuda.synchronize()
    tol = 1e-5 * pv.abs()
    assert bool(((kv - pv).abs() <= tol).all())
    alt = (q.to(torch.bfloat16).float()[:, None, :]
           * idx[ki.long()].float()).sum(-1)
    assert bool(((ki == pi) | ((alt - pv).abs() <= tol)).all())


@pytest.mark.parametrize("r", [64, 96, 128, 256])
@pytest.mark.parametrize("b", [7, 200, 300])
def test_pca_chunk_max_on_each_route_matches_plain(dev, b, r):
    """Kernel 3 at R = 64, 128, 256 (tensor cores, query tile resident,
    2-4 of the 256 chunks a block) and R = 96 (SIMT), bit for bit on small
    integers, with n_valid inside a chunk and a last chunk that has no
    valid row (NEG_INF)."""
    g = _gen(dev, b + r)
    n, cand = 1 << 17, 512
    n_valid = n - cand - 100
    plan = mips.chunk_max_plan(b, n, r, cand, torch.bfloat16, mips._sms(dev))
    assert plan["route"] == "simt" or plan["per_block"] > 1
    proj = torch.randint(-8, 9, (n, r), device=dev, generator=g).to(
        torch.bfloat16)
    qp = torch.randint(-8, 9, (b, r), device=dev, generator=g).to(
        torch.bfloat16)
    mips.reset_launch_counts()
    got = mips.pca_chunk_max(qp, proj, cand, n_valid)
    exp = mips.chunk_max_plain(qp, proj, cand, n_valid)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["pca_chunk_max"] == 1
    assert torch.equal(got, exp)
    assert bool((got[:, -1] == -3.0e38).all())


@pytest.mark.parametrize("b,n,r,n_valid", [(3, 1024, 32, None),
                                           (70, 8192, 128, 8000)])
def test_pca_chunk_max_matches_plain(dev, b, n, r, n_valid):
    g = _gen(dev, b)
    proj = torch.randn(n, r, device=dev, generator=g).to(torch.bfloat16)
    qp = torch.randn(b, r, device=dev, generator=g).to(torch.bfloat16)
    got = mips.pca_chunk_max(qp, proj, 512, n_valid)
    exp = mips.chunk_max_plain(qp, proj, 512, n_valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, exp, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,d,n_valid", [(5, 64, None), (33, 768, 3000)])
def test_pca_rescan_int8_matches_plain(dev, b, d, n_valid):
    g = _gen(dev, d)
    n, cand, kc = 4096, 128, 3
    idx = torch.randint(-127, 128, (n, d), device=dev, generator=g,
                        dtype=torch.int8)
    dsc = torch.rand(n, device=dev, generator=g)
    qi, _ = mips.quantize_rows(torch.randn(b, d, device=dev, generator=g))
    ids = torch.randint(0, n // cand, (b, kc), device=dev, generator=g,
                        dtype=torch.int32)
    got = mips.pca_rescan_int8(ids, qi, idx, dsc, cand, n_valid)
    exp = mips.rescan_plain(ids, qi, idx, dsc, cand, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


# widths of each template: the tensor-core one and the SIMT one
_WIDTHS = {"int8": {"mma": 768, "simt": 192},
           "bf16": {"mma": 768, "simt": 96}}


@pytest.mark.parametrize("route", ["mma", "simt"])
@pytest.mark.parametrize("kernel", ["mips_scan_int8", "mips_scan",
                                    "pca_chunk_max", "pca_rescan_int8",
                                    "rescan", "chunk_max", "chunk_max_int8"])
def test_kernels_with_no_valid_row(dev, kernel, route):
    """A shard of a row-sharded index that holds padding only runs its
    kernels with n_valid = 0: no row enters, so the merge can pick
    nothing of it.  Kernels 1-7 on each template return what their plain
    versions give: NEG_INF maxima and scores, (NEG_INF, 0) fillers."""
    g = _gen(dev, 7)
    int8 = kernel in ("mips_scan_int8", "pca_rescan_int8", "chunk_max_int8")
    d = _WIDTHS["int8" if int8 else "bf16"][route]
    n, chunk, b, k, kc = 4096, 512, 24, 4, 3
    q32 = torch.randn(b, d, device=dev, generator=g)
    if int8:
        rows = _rows(dev, g, n, d, torch.int8)
        dsc = torch.rand(n, device=dev, generator=g) + 0.01
        q, qs = mips.quantize_rows(q32)
    else:
        rows = _rows(dev, g, n, d, torch.bfloat16)
        q, dsc = q32.to(torch.bfloat16), None
    ids = torch.randint(0, n // chunk, (b, kc), device=dev, generator=g,
                        dtype=torch.int32)
    if kernel == "mips_scan_int8":
        got = mips.mips_scan_int8(q, qs, rows, dsc, k, 0)
        exp = mips.mips_scan_int8_plain(q, qs, rows, dsc, k, 0)
    elif kernel == "mips_scan":
        got = mips.mips_scan(q, rows, k, 0)
        exp = mips.mips_scan_plain(q, rows, k, 0)
    elif kernel == "pca_chunk_max":
        proj = rows[:, :128 if route == "mma" else 96].contiguous()
        qp = q[:, :proj.shape[1]].contiguous()
        got = mips.pca_chunk_max(qp, proj, chunk, 0)
        exp = mips.chunk_max_plain(qp, proj, chunk, 0)
    elif kernel == "chunk_max":
        got = mips.chunk_max(q, rows, chunk, 0)
        exp = mips.chunk_max_plain(q, rows, chunk, 0)
    elif kernel == "chunk_max_int8":
        got = mips.chunk_max_int8(q, rows, dsc, chunk, 0)
        exp = mips.chunk_max_plain(q, rows, chunk, 0, dsc)
    elif kernel == "pca_rescan_int8":
        got = mips.pca_rescan_int8(ids, q, rows, dsc, chunk, 0)
        exp = mips.rescan_plain(ids, q, rows, dsc, chunk, 0)
    else:
        got = mips.rescan(ids, q, rows, chunk, 0)
        exp = mips.rescan_plain(ids, q, rows, None, chunk, 0)
    torch.cuda.synchronize()
    got, exp = (got, exp) if isinstance(got, tuple) else ((got,), (exp,))
    for x, y in zip(got, exp):
        assert torch.equal(x, y), kernel
    assert bool((got[0] == -3.0e38).all()), kernel


def _rows(dev, g, n, d, dtype):
    """Small integers (int8: the full range) with fp32 scales: every float
    product and sum is exact, so kernel and plain version agree exactly
    whatever their order."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, (n, d), device=dev, generator=g,
                             dtype=torch.int8)
    return torch.randint(-8, 9, (n, d), device=dev, generator=g).to(dtype)


DTYPES = [torch.int8, torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,chunk,n_valid,d", [
    (1, 2048, 2048, None, 64), (7, 4096, 512, 3000, 64),
    (8, 3072, 1024, 1100, 768), (70, 8192, 512, 8000, 64),
    (200, 16384, 2048, 14000, 768), (257, 8192, 2048, 5000, 64),
    (70, 1 << 17, 512, (1 << 17) - 700, 64)])
def test_chunk_max_matches_plain(dev, dtype, b, n, chunk, n_valid, d):
    """Kernels 6 and 7: one chunk, ragged query tiles (bf16 rows: query
    tiles of 32 to 256, two tiles at B=257), D = 768 (24 pipeline stages a
    row tile), n_valid cutting inside a chunk with whole chunks after it
    that hold no valid row (NEG_INF); bf16 rows take the resident template
    where the query tile fits (two of 256 chunks a block in the last case)
    and the streamed one at B=200, D=768."""
    g = _gen(dev, b + n)
    idx = _rows(dev, g, n, d, dtype)
    q = _rows(dev, g, b, d, dtype)
    if dtype == torch.int8:
        dsc = torch.rand(n, device=dev, generator=g) + 0.01
        got = mips.chunk_max_int8(q, idx, dsc, chunk, n_valid)
        exp = mips.chunk_max_plain(q, idx, chunk, n_valid, dsc)
    else:
        got = mips.chunk_max(q, idx, chunk, n_valid)
        exp = mips.chunk_max_plain(q, idx, chunk, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,d,cand,kc,n_valid", [(3, 64, 128, 1, None),
                                                 (33, 768, 512, 4, 3000),
                                                 (9, 1024, 256, 16, 4095)])
def test_rescan_matches_plain(dev, dtype, b, d, cand, kc, n_valid):
    """Kernels 4 and 5 with the pad rows' chunk selected: on the SIMT
    template at every register width (8, 16 and 32 words a lane: fp32,
    and int8 at D=64), and on the tensor-core template elsewhere (bf16;
    int8 at D = 768 and 1024)."""
    g = _gen(dev, d + kc)
    n = 4096
    idx = _rows(dev, g, n, d, dtype)
    q = _rows(dev, g, b, d, dtype)
    ids = torch.randint(0, n // cand, (b, kc), device=dev, generator=g,
                        dtype=torch.int32)
    ids[0, 0] = n // cand - 1
    if dtype == torch.int8:
        dsc = torch.rand(n, device=dev, generator=g)
        got = mips.pca_rescan_int8(ids, q, idx, dsc, cand, n_valid)
        exp = mips.rescan_plain(ids, q, idx, dsc, cand, n_valid)
    else:
        got = mips.rescan(ids, q, idx, cand, n_valid)
        exp = mips.rescan_plain(ids, q, idx, None, cand, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


# kernels 4 and 5 on the tensor-core template (csrc/rescan_mma.cu)
MMA_RESCAN = [torch.int8, torch.bfloat16]


def _rescan_both(ids, q, idx, dsc, cand, n_valid):
    """(kernel, plain twin) of kernel 4 (``dsc`` given) or 5, with the
    kernel's launch counted."""
    mips.reset_launch_counts()
    if dsc is not None:
        got = mips.pca_rescan_int8(ids, q, idx, dsc, cand, n_valid)
        name = "pca_rescan_int8"
    else:
        got = mips.rescan(ids, q, idx, cand, n_valid)
        name = "rescan"
    exp = mips.rescan_plain(ids, q, idx, dsc, cand, n_valid)
    torch.cuda.synchronize()
    assert mips.LAUNCHES[name] == 1
    return got, exp


def _mma_rescan_inputs(dev, g, n, d, dtype, b):
    idx = _rows(dev, g, n, d, dtype)
    q = _rows(dev, g, b, d, dtype)
    dsc = (torch.rand(n, device=dev, generator=g) + 0.01
           if dtype == torch.int8 else None)
    return idx, q, dsc


@pytest.mark.parametrize("dtype", MMA_RESCAN)
@pytest.mark.parametrize("d", [128, 768, 1024])
@pytest.mark.parametrize("b", [1, 7, 192, 200, 384])
def test_rescan_on_the_tensor_cores_matches_plain(dev, b, d, dtype):
    """Kernels 4 and 5 on their tensor-core template against the plain
    twin, bit for bit (int8 over its whole range, bf16 on small integers,
    whose fp32 sums are exact in any order), at kc = 1, 8, 16, 20 and
    chunks of 128, 512 and 2048 rows of a 131,072-row index: chunk ids
    drawn with repeats (a chunk selected by up to 120 slots, more than a
    query tile holds, and ids repeated within a row), the pad rows' chunk
    selected by query 0, n_valid cutting inside it, and a chunk's rows
    split over several blocks where the chunks are few."""
    g = _gen(dev, 11 * b + d + (dtype == torch.int8))
    n = 1 << 17
    idx, q, dsc = _mma_rescan_inputs(dev, g, n, d, dtype, b)
    for cand in (128, 512, 2048):
        n_valid = n - cand // 2 - 3
        for kc in (1, 8, 16, 20):
            plan = mips.rescan_plan(b, kc, n, cand, d, dtype, mips._sms(dev))
            assert plan["route"] == "mma"
            ids = torch.randint(0, n // cand, (b, kc), device=dev,
                                generator=g, dtype=torch.int32)
            ids[0, 0] = n // cand - 1
            got, exp = _rescan_both(ids, q, idx, dsc, cand, n_valid)
            assert torch.equal(got, exp), (cand, kc, plan)
            assert bool((got[0, n_valid % cand:cand] == -3.0e38).all())


@pytest.mark.parametrize("dtype", MMA_RESCAN)
def test_rescan_with_every_slot_on_one_chunk(dev, dtype):
    """Every query selects chunk 5 eight times (3,072 slots on one chunk,
    sixteen or more query tiles, each id repeated in its row) and the pad
    rows' chunk once: each repeat gives the chunk's scores again."""
    g = _gen(dev, 21)
    n, d, cand, b = 1 << 16, 768, 512, 384
    idx, q, dsc = _mma_rescan_inputs(dev, g, n, d, dtype, b)
    ids = torch.full((b, 9), 5, device=dev, dtype=torch.int32)
    ids[:, 8] = n // cand - 1
    got, exp = _rescan_both(ids, q, idx, dsc, cand, n - 100)
    assert torch.equal(got, exp)
    assert torch.equal(got[:, :cand], got[:, 7 * cand:8 * cand])


@pytest.mark.parametrize("dtype", MMA_RESCAN)
def test_rescan_with_every_chunk_distinct(dev, dtype):
    """192 queries x 8 chunks over 1,536 chunks of 128 rows: every chunk
    selected exactly once (one slot a block, no row split)."""
    g = _gen(dev, 22)
    cand, b, kc, d = 128, 192, 8, 768
    n = b * kc * cand
    idx, q, dsc = _mma_rescan_inputs(dev, g, n, d, dtype, b)
    ids = torch.randperm(n // cand, device=dev, generator=g).view(b, kc)
    got, exp = _rescan_both(ids.to(torch.int32), q, idx, dsc, cand, None)
    assert torch.equal(got, exp)


@pytest.mark.parametrize("d", [128, 768, 1024])
def test_int8_rescan_extremes_match_plain(dev, d):
    """Queries of +-127 against rows of -128 only, of 127 only and over the
    whole range: the largest raw dots through kernel 4, bit-equal."""
    g = _gen(dev, d + 23)
    n, cand, b, kc = 8192, 512, 70, 8
    idx = torch.randint(-128, 128, (n, d), device=dev, generator=g,
                        dtype=torch.int8)
    idx[:600] = -128
    idx[4000:4600] = 127
    dsc = torch.rand(n, device=dev, generator=g) + 0.01
    sign = torch.randint(0, 2, (b, d), device=dev, generator=g) * 2 - 1
    q = (127 * sign).to(torch.int8)
    ids = torch.randint(0, n // cand, (b, kc), device=dev, generator=g,
                        dtype=torch.int32)
    ids[:, 0], ids[:, 1] = 0, 7
    got, exp = _rescan_both(ids, q, idx, dsc, cand, n - 3)
    assert torch.equal(got, exp)


@pytest.mark.parametrize("cand,kc", [(2048, 20), (512, 16)])
def test_bf16_rescan_within_tolerance(dev, cand, kc):
    """Kernel 5 at the FEVER CLI's shapes on N(0,1) bf16 data (B=200,
    262,144 x 768): within 1e-3 of the plain fp32 sums (the tensor cores
    add in their own order)."""
    g = _gen(dev, cand + kc)
    n, d, b = 1 << 18, 768, 200
    idx = torch.randn(n, d, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn(b, d, device=dev, generator=g).to(torch.bfloat16)
    ids = torch.stack([torch.randperm(n // cand, device=dev, generator=g)[:kc]
                       for _ in range(b)]).to(torch.int32)
    got, exp = _rescan_both(ids, q, idx, None, cand, n - 1000)
    torch.testing.assert_close(got, exp, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", MMA_RESCAN)
def test_rescan_launch_variants_agree(dev, dtype):
    """The tensor-core template under other launch plans than the one the
    wrapper picks (query tiles of 32 and 64 slots, the row split off, at
    512 rows and at one 128-row tile a block, one to three blocks sharing
    a range's query tiles): the same scores, bit for bit."""
    from multihop_dense_retrieval_tpu_torch.ops import _build

    g = _gen(dev, 24)
    n, d, cand, b, kc = 1 << 17, 768, 2048, 200, 20
    idx, q, dsc = _mma_rescan_inputs(dev, g, n, d, dtype, b)
    ids = torch.randint(0, n // cand, (b, kc), device=dev, generator=g,
                        dtype=torch.int32)
    exp = mips.rescan_plain(ids, q, idx, dsc, cand, n - 77)
    lib = _build.load("rescan_mma")
    int8 = dtype == torch.int8
    for q_tile, rows, groups in ((32, cand, 1), (32, 128, 1), (64, cand, 1),
                                 (64, 128, 1), (32, cand, 3), (32, 512, 2)):
        out = torch.empty(b, kc * cand, device=dev)
        _build.check(lib.rescan_mma(
            0 if int8 else 1, ids.data_ptr(), q.data_ptr(), idx.data_ptr(),
            dsc.data_ptr() if int8 else None, b, kc, n, n - 77, d, cand,
            q_tile, rows, cand // rows, groups,
            mips._rescan_smem(q_tile, d * idx.element_size(), int8),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "rescan_mma")
        torch.cuda.synchronize()
        assert torch.equal(out, exp), (q_tile, rows, groups)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k", [(8, 8), (12, 20), (16, 64)])
def test_two_phase_on_card_matches_cpu(dev, dtype, b, k):
    """The whole two-phase search on the card against the CPU (plain
    twins): k = 8 with B % 8 == 0, k > 8 with B % 8 != 0, and k = 64 =
    the number of chunks (every chunk rescanned)."""
    g = torch.Generator().manual_seed(k)
    n, d, chunk = 32768, 128, 512
    idx = torch.randint(-60, 61, (n, d), generator=g).to(dtype)
    q = torch.randn(b, d, generator=g)
    dsc = (torch.rand(n, generator=g) + 0.01) if dtype == torch.int8 else None
    cpu = mips.mips_topk(idx, q, k, chunk_rows=chunk, n_valid=n - 5,
                         doc_scales=dsc)
    mips.reset_launch_counts()
    gpu = mips.mips_topk(idx.to(dev), q.to(dev), k, chunk_rows=chunk,
                         n_valid=n - 5,
                         doc_scales=None if dsc is None else dsc.to(dev))
    torch.cuda.synchronize()
    int8 = dtype == torch.int8
    assert mips.LAUNCHES["chunk_max_int8" if int8 else "chunk_max"] == 1
    assert mips.LAUNCHES["pca_rescan_int8" if int8 else "rescan"] == 1
    assert torch.equal(gpu[1].cpu(), cpu[1])
    if int8:
        assert torch.equal(gpu[0].cpu(), cpu[0])
    else:
        torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-5, atol=0)


# leg l (cli/eval_retrieval at its defaults: batch 256, top 100, D = 768):
# over e2's 32,768 int8 rows the chunk rule (two_phase_chunk) gives 16
# chunks of 2048 rows, and k_chunks = min(100, 16) makes every query
# select every chunk; 8 chunks of 4096 rows is the same skew at the
# --chunk-rows default.  Over c's 262,144 bf16 rows: 128 chunks of 2048,
# kc = 100.
@pytest.mark.parametrize("n,chunk", [(1 << 15, 2048), (1 << 15, 4096)])
def test_int8_two_phase_at_top_100_with_every_chunk_selected(dev, n, chunk):
    """Kernels 7 and 4 at B = 256, k = 100 (every query on every chunk,
    its chunks in its own rank order), then the whole two-phase search on
    the card against the CPU: all bit-equal."""
    g = _gen(dev, chunk)
    b, d, n_valid, k = 256, 768, n - 300, 100
    idx = torch.randint(-127, 128, (n, d), device=dev, generator=g,
                        dtype=torch.int8)
    dsc = torch.rand(n, device=dev, generator=g) * 0.02 + 1e-3
    q32 = torch.randn(b, d, device=dev, generator=g)
    qi, qs = mips.quantize_rows(q32)
    mips.reset_launch_counts()
    maxima = mips.chunk_max_int8(qi, idx, dsc, chunk, n_valid)
    assert torch.equal(maxima,
                       mips.chunk_max_plain(qi, idx, chunk, n_valid, dsc))
    kc = min(k, n // chunk)
    ids = mips.topk_lower_index(maxima, kc)[1].to(torch.int32)
    assert bool((ids.sort(1)[0] == torch.arange(
        n // chunk, device=dev, dtype=torch.int32)).all())
    got, exp = _rescan_both(ids, qi, idx, dsc, chunk, n_valid)
    assert torch.equal(got, exp)
    gpu = mips.mips_topk_two_phase(idx, q32, k, chunk_rows=chunk,
                                   n_valid=n_valid, doc_scales=dsc)
    cpu = mips.mips_topk_two_phase(idx.cpu(), q32.cpu(), k, chunk_rows=chunk,
                                   n_valid=n_valid, doc_scales=dsc.cpu())
    assert torch.equal(gpu[0].cpu(), cpu[0]) and torch.equal(gpu[1].cpu(),
                                                             cpu[1])


def test_bf16_two_phase_at_top_100(dev):
    """Kernels 6 and 5 at leg l1's exact shape (B = 256 over 262,144 bf16
    rows, 2048-row chunks, kc = 100: 204,800 rows rescanned a query):
    bit-equal on small integers; on N(0,1) rows within 1e-3 of the plain
    fp32 sums, and the whole search's top 100 within rtol 1e-5 of the
    plain exact scan, ids equal apart from near-ties."""
    g = _gen(dev, 100)
    n, d, b, chunk, k, n_valid = 1 << 18, 768, 256, 2048, 100, (1 << 18) - 500
    assert mips.two_phase_chunk(n, b, d, 2, k, 4096) == chunk
    idx = _rows(dev, g, n, d, torch.bfloat16)
    q = _rows(dev, g, b, d, torch.bfloat16)
    mips.reset_launch_counts()
    maxima = mips.chunk_max(q, idx, chunk, n_valid)
    assert torch.equal(maxima, mips.chunk_max_plain(q, idx, chunk, n_valid))
    ids = mips.topk_lower_index(maxima, k)[1].to(torch.int32)
    got, exp = _rescan_both(ids, q, idx, None, chunk, n_valid)
    assert torch.equal(got, exp)
    del idx, got, exp
    idx = torch.randn(n, d, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn(b, d, device=dev, generator=g).to(torch.bfloat16)
    ids = mips.topk_lower_index(mips.chunk_max_plain(q, idx, chunk, n_valid),
                                k)[1].to(torch.int32)
    got, exp = _rescan_both(ids, q, idx, None, chunk, n_valid)
    torch.testing.assert_close(got, exp, rtol=0, atol=1e-3)
    del got, exp
    vals, rows = mips.mips_topk(idx, q, k, chunk_rows=4096, n_valid=n_valid)
    pv, pi = mips.mips_scan_plain(q, idx, k, n_valid)
    torch.testing.assert_close(vals, pv, rtol=1e-5, atol=0)
    alt = (q.float()[:, None, :] * idx[rows.long()].float()).sum(-1)
    assert bool(((rows == pi) | ((alt - pv).abs() <= 1e-5 * pv.abs())).all())


@pytest.mark.parametrize("n,dtype", [(1 << 18, torch.bfloat16),
                                     (1 << 15, torch.int8)])
def test_pca_tier_at_top_100(dev, n, dtype):
    """Kernels 3 and 5 (leg l1 --pca: 262,144 bf16 rows) or 3 and 4 (leg
    l2 --pca: 32,768 int8 rows) at B = 256, R = 128, 512-row candidate
    chunks, kc = 16: kernel 3 within 1e-3 of its twin (fp32 sums of bf16
    products in another order), the rescan of each query's 16 chunks
    bit-equal on small integers (int8 over its whole range)."""
    g = _gen(dev, n)
    b, d, r, cand, kc, n_valid = 256, 768, 128, 512, 16, n - 200
    proj = torch.randn(n, r, device=dev, generator=g).to(torch.bfloat16)
    qp = torch.randn(b, r, device=dev, generator=g).to(torch.bfloat16)
    mips.reset_launch_counts()
    maxp = mips.pca_chunk_max(qp, proj, cand, n_valid)
    torch.testing.assert_close(maxp, mips.chunk_max_plain(qp, proj, cand,
                                                          n_valid),
                               rtol=0, atol=1e-3)
    assert mips.LAUNCHES["pca_chunk_max"] == 1
    ids = mips.topk_lower_index(maxp, kc)[1].to(torch.int32)
    idx, q, dsc = _mma_rescan_inputs(dev, g, n, d, dtype, b)
    got, exp = _rescan_both(ids, q, idx, dsc, cand, n_valid)
    assert torch.equal(got, exp)


def test_float_pca_on_card_matches_cpu(dev):
    """mips_topk_pca over a bf16 index (kernels 3 and 5) on the card
    against the CPU: certificates and ids equal, values to rtol 1e-5."""
    g = torch.Generator().manual_seed(6)
    n, d, r, cand, b = 8192, 64, 32, 128, 24
    basis = torch.linalg.qr(torch.randn(d, d, generator=g))[0][:, :8]
    emb = (torch.randn(n, 8, generator=g) * torch.linspace(3, 0.8, 8)
           ) @ basis.t() + 0.05 * torch.randn(n, d, generator=g)
    rot = torch.from_numpy(mips.train_pca_rotation(emb[:2048].numpy(), r))
    proj, bounds = mips.build_pca_prefilter(emb.numpy(), rot.numpy(),
                                            cand_rows=cand)
    args = (emb.to(torch.bfloat16), torch.from_numpy(proj).to(torch.bfloat16),
            rot, torch.from_numpy(bounds),
            emb[torch.randperm(n, generator=g)[:b]]
            + 0.05 * torch.randn(b, d, generator=g))
    cpu = mips.mips_topk_pca(*args, 2, k_chunks=6, cand_rows=cand,
                             n_valid=n - 50)
    mips.reset_launch_counts()
    gpu = mips.mips_topk_pca(*(a.to(dev) for a in args), 2, k_chunks=6,
                             cand_rows=cand, n_valid=n - 50)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["pca_chunk_max"] == mips.LAUNCHES["rescan"] == 1
    assert torch.equal(gpu[2].cpu(), cpu[2]) and bool(cpu[2].any())
    assert torch.equal(gpu[1].cpu(), cpu[1])
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-5, atol=0)


def test_mips_topk_pca_on_card_matches_cpu(dev):
    """The whole PCA tier (kernels 3 and 4 plus the torch glue) on the card
    against the same function on the CPU: certificates equal, and every
    certified query has the exact int8 scan's top row."""
    g = torch.Generator().manual_seed(5)
    n, d, r, cand, b = 8192, 64, 32, 128, 24
    basis = torch.linalg.qr(torch.randn(d, d, generator=g))[0][:, :8]
    emb = (torch.randn(n, 8, generator=g) * torch.linspace(3, 0.8, 8)
           ) @ basis.t() + 0.05 * torch.randn(n, d, generator=g)
    rot = torch.from_numpy(mips.train_pca_rotation(emb[:2048].numpy(), r))
    qi, sc = mips.quantize_rows(emb)
    proj, bounds = mips.build_pca_prefilter(emb.numpy(), rot.numpy(),
                                            cand_rows=cand,
                                            scales=sc.numpy())
    proj = torch.from_numpy(proj).to(torch.bfloat16)
    bounds = torch.from_numpy(bounds)
    q = emb[torch.randperm(n, generator=g)[:b]] \
        + 0.05 * torch.randn(b, d, generator=g)
    args = (qi, proj, rot, bounds, q)
    cpu = mips.mips_topk_pca(*args, 1, k_chunks=4, cand_rows=cand,
                             n_valid=n - 50, doc_scales=sc)
    gpu = mips.mips_topk_pca(*(a.to(dev) for a in args), 1, k_chunks=4,
                             cand_rows=cand, n_valid=n - 50,
                             doc_scales=sc.to(dev))
    exact = mips.mips_topk(qi, q, 1, n_valid=n - 50, doc_scales=sc)
    cert = gpu[2].cpu()
    assert torch.equal(cert, cpu[2]) and cert.float().mean() >= 0.5
    assert torch.equal(gpu[1].cpu()[cert], exact[1][cert])
    # (raw*dsc)*q_scale in the rescan vs (raw*q_scale)*dsc in the scan:
    # the two orders differ by at most an ulp
    torch.testing.assert_close(gpu[0].cpu()[cert], exact[0][cert],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [128, 768])
def test_grown_index_kernels_match_plain(dev, d):
    """Kernels 1, 3 and 4 over an int8 + PCA index that live updates grew
    on the card (a full 4096-row index appended to: 8192 rows, n_valid
    4196, a chunk half filled and one empty) and then swap-deleted from,
    against their plain versions on a CPU copy of the same index: hop-1
    scan bit-equal, PCA certificates equal, certified queries equal to
    the exact scan.  The same updates made on the CPU store the same int8
    rows and scales; their projections (fp32 products summed in another
    order on each device) within one bf16 ulp."""
    import dataclasses

    from multihop_dense_retrieval_tpu_torch.index import DenseIndex

    rng = torch.Generator().manual_seed(d)
    emb = torch.randn(4096, d, generator=rng)
    extra = torch.randn(100, d, generator=rng)
    q = torch.cat([extra[:40], emb[:40]]) + 0.05 * torch.randn(80, d,
                                                               generator=rng)
    idx = {}
    for where in ("cpu", dev):
        i = DenseIndex.build(emb.numpy(), chunk_rows=4096, dtype="int8",
                             pca_dims=64, pca_cand_rows=512, device=where)
        i = i.append(extra.numpy())
        assert (i.vectors.shape[0], i.n_docs) == (8192, 4196)
        idx[where] = i.delete_swap(7)[0]
    b = idx[dev]
    a = dataclasses.replace(b, **{
        name: getattr(b, name).cpu() for name in (
            "vectors", "scales", "pca_rot", "pca_proj", "pca_bounds")})
    for name in ("vectors", "scales"):
        assert torch.equal(getattr(idx["cpu"], name), getattr(a, name))
    ulps = (idx["cpu"].pca_proj.view(torch.int16).int()
            - a.pca_proj.view(torch.int16).int()).abs()
    assert int(ulps.max()) <= 1
    mips.reset_launch_counts()
    got = mips.mips_topk(b.vectors, q.to(dev), 5, n_valid=b.n_docs,
                         doc_scales=b.scales)
    exp = mips.mips_topk(a.vectors, q, 5, n_valid=a.n_docs,
                         doc_scales=a.scales)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["mips_scan_int8"] == 1
    assert torch.equal(got[0].cpu(), exp[0]) and torch.equal(got[1].cpu(),
                                                              exp[1])
    args = dict(k_chunks=4, cand_rows=512, n_valid=a.n_docs)
    pg = mips.mips_topk_pca(b.vectors, b.pca_proj, b.pca_rot, b.pca_bounds,
                            q.to(dev), 1, doc_scales=b.scales, **args)
    pc = mips.mips_topk_pca(a.vectors, a.pca_proj, a.pca_rot, a.pca_bounds,
                            q, 1, doc_scales=a.scales, **args)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["pca_chunk_max"] == 1
    assert mips.LAUNCHES["pca_rescan_int8"] == 1
    cert = pg[2].cpu()
    assert torch.equal(cert, pc[2]) and bool(cert.any())
    assert torch.equal(pg[1].cpu()[cert], exp[1][cert, :1])
    assert bool((pg[1].cpu() < a.n_docs).all())


def _attn_inputs(dev, g, b, wq, w, nh, d, dtype, masked_row=True):
    q, k, v = (torch.randn(b, n, nh * d, device=dev, generator=g).to(dtype)
               for n in (wq, w, w))
    lens = torch.randint(1, w + 1, (b,), device=dev, generator=g)
    mask = (torch.arange(w, device=dev)[None] < lens[:, None]).to(torch.int32)
    if masked_row:
        mask[-1] = 0                      # a fully masked row
    return q, k, v, mask


def _bf16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def assert_attention_close(got, exp, q, k, v, mask, nh):
    """Kernel 8 against its plain version.  fp32: atol/rtol 1e-5 (sums in
    another order).  bf16: within 2 bf16 ulps of the plain value, plus
    2^-7 * sum_j p_j |v_j|: both round p to bf16 from fp32 values whose
    sums differ in order, and a p rounded the other way moves o by one ulp
    of p_j (<= 2^-7 p_j) times |v_j|."""
    assert got.dtype == exp.dtype == q.dtype and got.shape == exp.shape
    got, exp_f = got.float(), exp.float()
    assert bool(torch.isfinite(got).all())
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, exp_f, atol=1e-5, rtol=1e-5)
        return
    from multihop_dense_retrieval_tpu_torch.ops.fused_attention import \
        fused_attention_plain
    env = fused_attention_plain(q, k, v.abs(), mask, nh).float()
    tol = 2 * _bf16_ulp(exp_f) + 2.0 ** -7 * env * (1 + 2.0 ** -7)
    assert bool(((got - exp_f).abs() <= tol).all()), \
        float(((got - exp_f).abs() - tol).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("w", [1, 15, 16, 17, 33, 300, 350, 514])
def test_fused_attention_matches_plain(dev, dtype, d, w):
    """Kernel 8 at every head dim and every template (attention_plan),
    square (Wq = W: key padding at 15, 17, 33, 300, 350 and 514, ragged
    last query tiles) and Wq = 1, with ragged masks and a fully masked
    row; B=1 at the widest W."""
    from multihop_dense_retrieval_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_plain)

    g = _gen(dev, d * 1000 + w)
    nh = max(1, 256 // d)
    b = 1 if w >= 512 else 3
    for wq in sorted({w, 1}):
        q, k, v, mask = _attn_inputs(dev, g, b, wq, w, nh, d, dtype)
        mips.reset_launch_counts()
        got = fused_attention(q, k, v, mask, nh)
        exp = fused_attention_plain(q, k, v, mask, nh)
        torch.cuda.synchronize()
        assert mips.LAUNCHES["fused_attention"] == 1
        assert_attention_close(got, exp, q, k, v, mask, nh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wq", [40, 1])
def test_fused_attention_fully_masked_rows_are_uniform(dev, dtype, wq):
    """No attendable key: JAX's softmax over s - 1e9 (equal after
    rounding) is uniform over the W = 40 real keys, so each query row is
    the mean of v (bf16: p = bf16(1/40) times the sum of v, within 2 ulps;
    the tensor-core template pads the keys to 48, and pad keys counted in
    the softmax would give 40/48 of it)."""
    from multihop_dense_retrieval_tpu_torch.ops.fused_attention import \
        fused_attention

    g = _gen(dev, 8)
    q, k, v, _ = _attn_inputs(dev, g, 2, wq, 40, 4, 64, dtype)
    mask = torch.zeros(2, 40, dtype=torch.int32, device=dev)
    got = fused_attention(q, k, v, mask, 4)
    if dtype == torch.float32:
        torch.testing.assert_close(
            got, v.mean(1, keepdim=True).expand_as(got), atol=1e-5, rtol=1e-5)
        return
    p = torch.tensor(1 / 40).to(dtype).float()
    exp = (p * v.float().sum(1, keepdim=True)).to(dtype).float()
    diff = (got.float() - exp).abs()
    assert bool((diff <= 2 * _bf16_ulp(exp) + 1e-6).all()), float(diff.max())


def test_attention_division_is_ieee(dev):
    """Kernel 8's tensor-core template divides e = expf(s - m) by the row
    sum l without __fdiv_rn (csrc/fused_attention.cu::div_rn, a rounded
    reciprocal and two FMA corrections).  It must give the IEEE quotient
    bit for bit wherever that is a normal float, and stay within one
    subnormal ulp (2^-149) below: e over every binade expf gives for
    s - m in [-104, 0] (subnormals and 0 included), l over [1, 514] and
    every integer sum, against torch's division (IEEE on the card)."""
    from multihop_dense_retrieval_tpu_torch.ops import _build

    g = _gen(dev, 11)
    n = 1 << 22
    e = torch.exp(-104 * torch.rand(n, device=dev, generator=g))
    e[:6] = torch.tensor([0.0, 1.0, 2.0 ** -149, 2.0 ** -126, 1 - 2.0 ** -24,
                          2.0 ** -100], device=dev)
    lsum = 1 + 513 * torch.rand(n, device=dev, generator=g)
    lsum[6:520] = torch.arange(1, 515, dtype=torch.float32, device=dev)
    out = torch.empty_like(e)
    _build.check(_build.load("fused_attention").attention_divide(
        e.data_ptr(), lsum.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream().cuda_stream), "attention_divide")
    exp = e / lsum
    torch.cuda.synchronize()
    normal = exp >= 2.0 ** -126
    assert int(normal.sum()) > n // 2 and int((~normal).sum()) > 1000
    assert torch.equal(out[normal], exp[normal])
    assert bool(((out - exp)[~normal].abs() <= 2.0 ** -149).all())


def test_fused_encoder_on_card_matches_cpu(dev):
    """A 2-layer, 128-wide fp32 fused encoder (d=64) on the card against
    the same weights on the CPU (the plain version): one launch a layer,
    and the vectors within 1e-4 (two layers of fp32 sums in another
    order)."""
    from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
    from multihop_dense_retrieval_tpu_torch.models import MhopRetriever

    cfg = EncoderConfig.tiny(attention_impl="fused", hidden_size=128,
                             num_heads=2, intermediate_size=256)
    torch.manual_seed(0)
    model = MhopRetriever(cfg, cls_only=True).eval()
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(4, 120, (6, 30), generator=g)
    mask = (torch.arange(30)[None] < torch.randint(3, 31, (6, 1),
                                                    generator=g)).int()
    with torch.no_grad():
        cpu = model.encode_seq(ids, mask)
        mips.reset_launch_counts()
        gpu = model.to(dev).encode_seq(ids.to(dev), mask.to(dev))
    torch.cuda.synchronize()
    assert mips.LAUNCHES["fused_attention"] == cfg.num_layers
    torch.testing.assert_close(gpu.cpu(), cpu, atol=1e-4, rtol=1e-4)


# ---- kernels 9-11: the encoder's elementwise chains ------------------------


def _bf16_ulps(got, exp, floor=0.0):
    """|got - exp| in bf16 ulps of max(|exp|, floor) (whatever the dtype:
    fp32 outputs that differ by a few fp32 ulps read as a small fraction of
    one)."""
    e = exp.float().abs().clamp(min=floor)
    _, ex = torch.frexp(e)
    ulp = torch.where(e > 0, torch.ldexp(torch.ones_like(e), ex - 8),
                      torch.full_like(e, 2.0 ** -133))
    return (got.float() - exp.float()).abs().detach() / ulp


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,cols", [(37584, 3072), (16384, 4096),
                                       (5, 40), (3, 37)])
def test_bias_gelu_is_bit_equal_to_plain(dev, dtype, rows, cols):
    """Kernel 9 at hop 2's FFN (37,584 tokens), the reader's (32 x 512 rows
    of 4096) and widths off 16 bytes: bit for bit, saturated tails, zeros
    and a bias that cancels the input included."""
    from multihop_dense_retrieval_tpu_torch.ops.encoder_fused import (
        bias_gelu, bias_gelu_plain)

    g = _gen(dev, rows + cols)
    y = (3 * torch.randn(rows, cols, device=dev, generator=g)).to(dtype)
    bias = torch.randn(cols, device=dev, generator=g).to(dtype)
    y[0, :4] = torch.tensor([0.0, -0.0, 12.0, -12.0]).to(dtype)
    y[-1] = -bias
    mips.reset_launch_counts()
    got = bias_gelu(y, bias)
    exp = bias_gelu_plain(y, bias)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["bias_gelu"] == 1
    assert got.dtype == dtype and torch.equal(got, exp)


def _softmax_steps(raw, attn_bias, scale):
    """The plain path's bf16-score steps up to the row sum: (e, sum)."""
    dt = raw.dtype
    s = raw / scale + attn_bias.to(dt)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e, e.sum(-1, keepdim=True)


# (B, nh, Lq, L, d): mhop.beam5.b100's tile 5 (63 rows at 350) and its
# cls_only layer, hop 1 (100 x 70), the reader (32 x 512), a ragged square
# of head dim 32 (a scale of 5.65625, whose reciprocal is inexact), the
# widest row the kernel takes
SOFTMAX_CASES = [(63, 12, 350, 350, 64), (63, 12, 1, 350, 64),
                 (100, 12, 70, 70, 64), (32, 16, 512, 512, 64),
                 (5, 4, 17, 17, 32), (3, 2, 1, 544, 32)]


@pytest.mark.parametrize("dtype,scores_dtype", [
    (torch.bfloat16, "float32"), (torch.bfloat16, "bfloat16"),
    (torch.float32, "float32")])
@pytest.mark.parametrize("case", SOFTMAX_CASES)
def test_masked_softmax_within_an_ulp_of_plain(dev, case, dtype,
                                               scores_dtype):
    """Kernel 10 against its twin, ragged masks and a fully masked row.
    The division by the CPU scalar is the product with its fp32
    reciprocal (PyTorch's, checked here), which the kernel takes.
    fp32 scores: the row sums differ in order only, so every probability
    lies within 1 bf16 ulp of the twin's (fp32 outputs: within a few fp32
    ulps), and at most 1e-3 of bf16 outputs differ at all.  bf16 scores:
    every step before the sum is the twin's bit for bit, and the row sum
    is rounded to bf16, so a row equals the twin's e / s exactly for s the
    twin's bf16 sum or, where the fp32 sums in another order round the
    other way, its bf16 neighbour (a share of rows at most 1e-3; those
    rows' probabilities move by 1-2 ulps)."""
    import math

    from multihop_dense_retrieval_tpu_torch.ops.encoder_fused import (
        masked_softmax, masked_softmax_plain)

    b, nh, lq, w, d = case
    g = _gen(dev, b * w + d)
    raw = (3 * math.sqrt(d) * torch.randn(b, nh, lq, w, device=dev,
                                          generator=g)).to(dtype)
    lens = torch.randint(1, w + 1, (b,), device=dev, generator=g)
    mask = torch.arange(w, device=dev)[None] < lens[:, None]
    mask[-1] = False
    attn_bias = torch.where(mask[:, None, None, :], 0.0, -1e9).to(
        torch.float32)
    scale = torch.tensor(math.sqrt(d), dtype=torch.float32).to(dtype)
    inv = (torch.ones((), dtype=torch.float32) / scale.float()).to(dev)
    assert torch.equal(raw / scale, (raw.float() * inv).to(dtype))
    mips.reset_launch_counts()
    got = masked_softmax(raw, attn_bias, scale, scores_dtype)
    exp = masked_softmax_plain(raw, attn_bias, scale, scores_dtype)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["masked_softmax"] == 1
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    if scores_dtype == "float32" or dtype == torch.float32:
        off = _bf16_ulps(got, exp)
        assert float(off.max()) <= 1.0, float(off.max())
        if dtype == torch.bfloat16:
            assert float((off > 0).float().mean()) <= 1e-3
        return
    e, s = _softmax_steps(raw, attn_bias, scale)
    bits = s.view(torch.int16)                 # s >= 1: the next bf16 values
    same = (got == exp).all(-1)
    near = [(e / (bits + k).view(dtype) == got).all(-1) for k in (1, -1)]
    assert bool((same | near[0] | near[1]).all())
    assert float((~same).float().mean()) <= 1e-3


# (rows, N, L, eps): mhop.beam5.b100's tile 5 (63 x 350 tokens), its
# cls_only layer (63 rows, each 350 x 768 apart), hop 1, the reader (32 x
# 512 at 1024, eps 1e-12), and widths off 16 bytes
LN_CASES = [(63, 350, 768, 1e-5, False), (63, 350, 768, 1e-5, True),
            (100, 70, 768, 1e-5, False), (32, 512, 1024, 1e-12, False),
            (7, 9, 36, 1e-5, True), (3, 5, 37, 1e-5, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,w,n,eps,cls_only", LN_CASES)
def test_add_layer_norm_within_an_ulp_of_plain(dev, dtype, b, w, n, eps,
                                               cls_only):
    """Kernel 11 against its twin.  The bias and residual adds are the
    twin's bit for bit; the mean and E[h^2] differ by the order of their
    row sums, a few fp32 ulps, so every output lies within 1 bf16 ulp of
    the twin's, an output below 2^-8 in magnitude counted in ulps of 2^-8
    (there the difference is one of fp32 terms of order 1, not of the
    output), and at most 1e-3 of bf16 outputs differ at all."""
    from multihop_dense_retrieval_tpu_torch.ops.encoder_fused import (
        add_layer_norm, add_layer_norm_plain)

    g = _gen(dev, b * n + w)
    x = (2 * torch.randn(b, w, n, device=dev, generator=g) + 0.5).to(dtype)
    res = x[:, :1] if cls_only else x
    y = torch.randn(res.shape, device=dev, generator=g).to(dtype)
    bias = (0.1 * torch.randn(n, device=dev, generator=g)).to(dtype)
    ln = torch.nn.LayerNorm(n, eps=eps).to(dev)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(n, device=dev, generator=g))
        ln.bias.copy_(0.1 * torch.randn(n, device=dev, generator=g))
    mips.reset_launch_counts()
    got = add_layer_norm(y, bias, res, ln)
    exp = add_layer_norm_plain(y, bias, res, ln)
    torch.cuda.synchronize()
    assert mips.LAUNCHES["add_layer_norm"] == 1
    assert got.dtype == dtype and got.shape == exp.shape
    off = _bf16_ulps(got, exp, floor=2.0 ** -8)
    assert float(off.max()) <= 1.0, float(off.max())
    if dtype == torch.bfloat16:
        assert float((off > 0).float().mean()) <= 1e-3


def _plain_forward(fn, *args):
    """``fn`` with gradients on (the layers' plain twins), nothing
    recorded for a backward."""
    with torch.enable_grad():
        return fn(*args)


def _fp32_twin(model, make):
    """``make(config)`` in float32 with ``model``'s weights (bf16 values,
    exact in fp32), on its device, for the plain path's reference."""
    import dataclasses

    twin = make(dataclasses.replace(model.config, dtype="float32"))
    twin.load_state_dict({k: v.float() for k, v in
                          model.state_dict().items()})
    twin = twin.to(next(model.parameters()).device).eval()
    for p in twin.parameters():
        p.requires_grad_(False)
    return twin


KERNELS_9_11 = ("bias_gelu", "masked_softmax", "add_layer_norm")


def test_retriever_forward_with_kernels_9_11_agrees_with_plain(dev):
    """A roberta-base MhopRetriever (bf16, fp32 scores, cls_only) on the
    card at mhop.beam5.b100's hop-1 batch (100 x 70) and hop-2 tile 5 (63
    x 350): kernels 9 and 10 once a layer and kernel 11 twice (12 layers,
    the last at one position), every layer counted fused.  Both bf16 paths
    are held to the plain fp32 encoder as the benchmark's vec_err holds
    the program (the largest |v - v32| / |v32| of a row): the kernels'
    roundings differ from the plain path's only in rare 1-ulp flips, which
    twelve layers spread like bf16's own rounding, so the kernels' error
    is held below the limit 0.045 and within 1.5x of the plain path's."""
    from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
    from multihop_dense_retrieval_tpu_torch.models import MhopRetriever
    from multihop_dense_retrieval_tpu_torch.utils.profiling import recorder

    cfg = EncoderConfig.roberta_base()
    torch.manual_seed(0)
    model = MhopRetriever(cfg, cls_only=True).to(dev).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    ref = _fp32_twin(model, lambda c: MhopRetriever(c, cls_only=True))
    g = _gen(dev, 21)

    def rel(v, v32):
        return float(((v.float() - v32).norm(dim=-1)
                      / v32.norm(dim=-1)).max())

    for b, w in ((100, 70), (63, 350)):
        ids = torch.randint(3, cfg.vocab_size, (b, w), device=dev, generator=g)
        lens = torch.randint(8, w + 1, (b,), device=dev, generator=g)
        mask = (torch.arange(w, device=dev)[None] < lens[:, None]).int()
        ids = torch.where(mask.bool(), ids, cfg.pad_token_id)
        mips.reset_launch_counts()
        with torch.inference_mode(), recorder() as timers:
            got = model.encode_seq(ids, mask)
        assert {k: mips.LAUNCHES[k] for k in KERNELS_9_11} == {
            "bias_gelu": 12, "masked_softmax": 12, "add_layer_norm": 24}
        assert dict(timers.counters) == {"encoder.layers_fused": 12}
        exp = _plain_forward(model.encode_seq, ids, mask)
        v32 = _plain_forward(ref.encode_seq, ids, mask)
        assert mips.LAUNCHES["bias_gelu"] == 12
        err, err_plain = rel(got, v32), rel(exp, v32)
        assert err <= min(0.045, 1.5 * err_plain), (err, err_plain)


def test_reader_forward_with_kernels_9_11_agrees_with_plain(dev):
    """An ELECTRA-large QAReader (bf16 scores, eps 1e-12) on the card at
    read.top5.q64's batch of 32 x 512: kernels 9 and 10 once and kernel 11
    twice in each of 24 layers.  As in the retriever's test, both bf16
    paths are held to the plain fp32 reader: the largest |logit - fp32| of
    the span, rank and supporting-sentence logits (the benchmark's
    logit_err and sp_err read the same) below logit_err's limit 0.3 and
    within 1.5x of the plain path's."""
    from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
    from multihop_dense_retrieval_tpu_torch.models import QAReader

    cfg = EncoderConfig.electra_large(attention_scores_dtype="bfloat16")
    torch.manual_seed(0)
    model = QAReader(cfg, sp_pred=True).to(dev).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    ref = _fp32_twin(model, lambda c: QAReader(c, sp_pred=True))
    g = _gen(dev, 22)
    b, w = 32, 512
    lens = torch.randint(64, w + 1, (b,), device=dev, generator=g)
    mask = (torch.arange(w, device=dev)[None] < lens[:, None]).int()
    batch = {"input_ids": torch.randint(3, cfg.vocab_size, (b, w), device=dev,
                                        generator=g) * mask,
             "attention_mask": mask,
             "token_type_ids": (torch.arange(w, device=dev)[None] >= 40
                                ).int() * mask,
             "paragraph_mask": mask.clone(),
             "sent_offsets": torch.randint(1, 64, (b, 8), device=dev,
                                           generator=g)}
    mips.reset_launch_counts()
    with torch.inference_mode():
        got = model(batch)
    assert {k: mips.LAUNCHES[k] for k in KERNELS_9_11} == {
        "bias_gelu": 24, "masked_softmax": 24, "add_layer_norm": 48}
    exp = _plain_forward(model, batch)
    out32 = _plain_forward(ref, batch)
    for k in ("start_logits", "end_logits", "rank_score", "sp_score"):
        keep = out32[k] > -1e20
        err = float((got[k] - out32[k])[keep].abs().max())
        err_plain = float((exp[k] - out32[k])[keep].abs().max())
        assert err <= min(0.3, 1.5 * err_plain), (k, err, err_plain)


# ---- beam-4 serving on the card (pruning, the stop-skip cascade) ----------


def _beam4_engine(dev, **cfg_kw):
    """A 2-layer, 128-wide fp32 UnifiedRetriever over an 8192-row int8
    index with PCA (R=32, 512-row chunks) and a 60-wide token store, all
    on the card: (engine, the tokenized questions)."""
    from multihop_dense_retrieval_tpu_torch.core.config import (EncoderConfig,
                                                                SearchConfig)
    from multihop_dense_retrieval_tpu_torch.data import TokenizerSpec
    from multihop_dense_retrieval_tpu_torch.index import DenseIndex
    from multihop_dense_retrieval_tpu_torch.models import UnifiedRetriever
    from multihop_dense_retrieval_tpu_torch.search import BeamSearcher

    cfg = EncoderConfig.tiny(vocab_size=512, max_position_embeddings=140,
                             hidden_size=128, num_heads=2,
                             intermediate_size=256)
    torch.manual_seed(0)
    model = UnifiedRetriever(cfg, cls_only=True)
    for lin in (model.stop_head,):
        torch.nn.init.normal_(lin.weight, std=0.5)
    model = model.to(dev).eval()
    g = torch.Generator().manual_seed(2)
    n, width, b = 8192, 60, 32
    emb = torch.randn(n, 128, generator=g)
    index = DenseIndex.build(emb.numpy(), chunk_rows=4096, dtype="int8",
                             pca_dims=32, pca_cand_rows=512, device=dev)
    text_lens = torch.randint(1, width + 1, (n,), generator=g)
    text_ids = torch.randint(10, 500, (n, width), generator=g)
    text_ids[torch.arange(width)[None] >= text_lens[:, None]] = 1
    spec = TokenizerSpec(cls_id=0, sep_id=2, pad_id=1, vocab_size=512)
    engine = BeamSearcher(
        encode_fn=model.encode_seq, encode_qsp_fn=model.encode_qsp,
        index=index, text_ids=text_ids, text_lens=text_lens,
        empty=torch.zeros(n, dtype=torch.bool), spec=spec, device=dev,
        config=SearchConfig(beam_size_1=4, beam_size_2=4, topk=16,
                            max_q_len=24, max_q_sp_len=128, use_pca=True,
                            pca_k_chunks=4, hop2_buckets=(48, 64, 96, 128),
                            hop2_tile_fracs=(0.25, 0.25, 0.25, 0.25),
                            **cfg_kw))
    lens = torch.randint(3, 22, (b,), generator=g)
    raw = torch.randint(10, 500, (b, 22), generator=g)
    raw[torch.arange(22)[None] >= lens[:, None]] = 1
    ids = torch.full((b, 24), 1)
    mask = torch.zeros((b, 24), dtype=torch.int32)
    for i, m in enumerate(lens.tolist()):
        ids[i, :m + 2] = torch.cat([torch.tensor([0]), raw[i, :m],
                                    torch.tensor([2])])
        mask[i, :m + 2] = 1
    q = ({"input_ids": ids.numpy(), "attention_mask": mask.numpy()},
         raw.numpy(), lens.numpy())
    return engine, q


def _hold_hops_to_exact_scan(engine, q):
    """Run one search recording every MIPS call, and hold each to the
    exact int8 scan on its own query vectors: a scan hop bit-equal; a PCA
    hop's certified queries return the exact top-1 (scores within the two
    epilogue orders' ulp)."""
    seen = []
    hop_mips = engine._mips

    def recorded(queries, k, pca=True):
        res = hop_mips(queries, k, pca)
        seen.append((queries, k, res))
        return res

    engine._mips = recorded
    out = engine.search(*q)
    torch.cuda.synchronize()
    index = engine.index
    for queries, k, (vals, docs, cert) in seen:
        qi, qs = mips.quantize_rows(queries)
        ev, ei = mips.mips_scan_int8_plain(qi, qs, index.vectors,
                                           index.scales, k, index.n_docs)
        if cert is None:
            assert torch.equal(vals, ev) and torch.equal(docs, ei.long())
            continue
        c = cert
        assert torch.equal(docs[c, 0], ei[c, 0].long())
        torch.testing.assert_close(vals[c, 0], ev[c, 0], rtol=1e-6, atol=0)
    return out


@pytest.mark.parametrize("margin", [0.0, -0.5, -0.9])
def test_beam4_cascade_on_card_holds_to_exact_scan(dev, margin):
    """Pruning (auto:Q) and the stop-skip cascade on the card, at about
    half the questions stopped: every hop equals the exact scan on its own
    vectors; every live chain's hop-1 candidate meets the margin rule on
    the engine's own d1; a stopped question keeps exactly its top-1
    candidate's beam2 chains; a skipped row's stop probability is 0.5."""
    from multihop_dense_retrieval_tpu_torch.ops.mips import NEG_INF

    base, q = _beam4_engine(dev)
    probe = base.search(*q)
    slot = probe["hop1_cand_scores"].argmax(1)
    p_top = probe["stop_probs"][range(len(slot)), slot]
    thr = float(sorted(p_top)[len(p_top) // 2])
    engine, _ = _beam4_engine(dev, stop_skip_threshold=thr,
                              hop2_prune_margin=margin)
    mips.reset_launch_counts()
    out = _hold_hops_to_exact_scan(engine, q)
    for name in ("mips_scan_int8", "pca_chunk_max", "pca_rescan_int8"):
        assert mips.LAUNCHES[name] > 0, name
    d1 = out["hop1_cand_scores"]
    top1 = d1.max(1, keepdims=True)
    gaps = (top1 - d1).ravel()
    gaps.sort()
    bsz, beam1 = d1.shape
    if margin < 0:
        m = gaps[bsz + int((gaps.size - bsz - 1) * -margin)]
        kept = d1 >= top1 - m
    else:
        kept = d1 > NEG_INF / 2
    stopped = out["stop_probs"][range(bsz), d1.argmax(1)] >= thr
    assert stopped.any() and not stopped.all()
    live = out["path_scores"] > NEG_INF / 2
    for b in range(bsz):
        slots = [list(out["hop1_cand_ids"][b]).index(h)
                 for h in out["hop1_ids"][b][live[b]]]
        assert all(kept[b, s] for s in slots)
        if stopped[b]:
            assert live[b].sum() == 4 and set(slots) == {int(d1[b].argmax())}
    assert (out["stop_probs"] == 0.5).any()


def test_hnsw_binding_beside_cuda_tensors(dev):
    """The host HNSW tier in a process that holds CUDA tensors: vectors
    made on the card, the graph searched on the host, recall@10 >= 0.85
    against the exact scores computed on the card."""
    from multihop_dense_retrieval_tpu_torch.index.hnsw import HNSWIndex

    g = _gen(dev, 9)
    vecs = torch.randn(4096, 64, device=dev, generator=g)
    queries = torch.randn(64, 64, device=dev, generator=g)
    idx = HNSWIndex(64, M=16, ef_construction=100)
    idx.add(vecs.cpu().numpy())
    scores, ids = idx.search(queries.cpu().numpy(), 10, 128)
    exact = (queries @ vecs.t()).topk(10).indices.cpu().numpy()
    torch.cuda.synchronize()
    recall = sum(len(set(a) & set(b)) for a, b in zip(ids, exact)) / ids.size
    assert recall >= 0.85, recall
    assert vecs.is_cuda and queries.is_cuda


def test_train_step_on_card_matches_cpu(dev):
    """One train step of a 2-layer, 64-wide retriever (fp32 compute, TF32
    off) on the card and on the CPU from the same weights and batch, as
    chip_smoke.py's leg j0 holds it: the loss within 1e-5 relative, the
    gradients within 1e-6 + 1e-4 of each tensor's largest, and each
    parameter within ``chip_smoke.adam_bound`` of that gradient tolerance
    on the clipped gradients."""
    import numpy as np

    from chip_smoke import adam_bound
    from multihop_dense_retrieval_tpu_torch.core.config import (
        EncoderConfig, RetrieverTrainConfig)
    from multihop_dense_retrieval_tpu_torch.models import MhopRetriever
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    torch.manual_seed(0)
    cfg = EncoderConfig.tiny(vocab_size=96, max_position_embeddings=40,
                             hidden_size=64, intermediate_size=128)
    base = MhopRetriever(cfg, cls_only=True, fp32_params=True)
    rng = np.random.RandomState(0)
    batch = {}
    for name, width in (("q", 12), ("q_sp", 24), ("c1", 16), ("c2", 16),
                        ("neg1", 16), ("neg2", 16)):
        lens = rng.randint(4, width + 1, size=4)
        mask = (np.arange(width)[None] < lens[:, None]).astype(np.int32)
        batch[f"{name}_input_ids"] = np.where(
            mask > 0, rng.randint(4, 96, size=(4, width)), 1).astype(np.int32)
        batch[f"{name}_mask"] = mask
    tcfg = RetrieverTrainConfig(learning_rate=1e-3, warmup_ratio=0.0)
    out = []
    for d in (torch.device("cpu"), dev):
        model = MhopRetriever(cfg, cls_only=True, fp32_params=True).to(d)
        model.load_state_dict(base.state_dict())
        state = T.TrainState.create(model, T.make_optimizer(tcfg, 10))
        grads = {}
        update = state.opt.update

        def kept(model=model, update=update, grads=grads):
            grads.update({n: p.grad.cpu().clone()
                          for n, p in model.named_parameters()})
            return update()

        state.opt.update = kept
        _, loss = T.make_train_step()(state, T.to_device(batch, d))
        out.append((float(loss), grads,
                    {k: v.cpu() for k, v in model.state_dict().items()}))
    (lc, gc, pc), (lg, gg, pg) = out
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in gc.values()))
    clip = min(1.0, tcfg.max_grad_norm / norm.item())
    lr, eps = tcfg.learning_rate, tcfg.adam_eps
    for name, g in gc.items():
        scale = g.abs().max().item()
        assert (gg[name] - g).abs().max().item() <= 1e-6 + 1e-4 * scale, name
        bound = adam_bound(g * clip, (1e-6 + 1e-4 * scale) * clip,
                           pc[name], lr, eps)
        assert ((pg[name] - pc[name]).abs() / lr <= bound).all(), name


def test_reader_train_step_on_card_matches_cpu(dev):
    """chip_smoke.py's leg k0 as a test: one reader train step (2 layers at
    ELECTRA-large width, fp32 compute, TF32 off, B=6 ragged up to 512, sp
    on) on the card and on the CPU from the same weights and batch: the
    loss within 1e-5 relative, the gradients within 1e-6 + 1e-4 of each
    tensor's largest, each parameter within ``chip_smoke.adam_bound``."""
    import chip_smoke
    from multihop_dense_retrieval_tpu_torch import models
    from multihop_dense_retrieval_tpu_torch.core import config
    from multihop_dense_retrieval_tpu_torch.train import qa as TQA
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    r = chip_smoke.check_reader_step_on_card(T, TQA, models, config, dev,
                                             "test")
    assert r["worst_g"][0] <= 1 and r["worst_p"][0] <= 1


def _near_tie_index(seed, b=192, r=128, d=768, cand=512, n_chunks=64,
                    k_chunks=8):
    """A bf16 index and queries on which the PCA certificate has no slack
    but kernel 3's own error: rows and queries live in the first ``r``
    coordinates and the rotation is the identity there, so the residual
    and projection-storage bounds are 0 and the queries (bf16 values) lose
    nothing to rounding.  Each query has ``k_chunks`` + 1 planted rows in
    distinct chunks whose float64 scores tie to within m·ε (m in -4..4,
    ε from 2^-14 to 2^-25 of the score, exact ties included), set through
    three control coordinates whose query weights are 1, 2^-8 and 2^-16;
    every other row scores far below them.  The certificate boundary (the
    k_chunks-th against the next chunk's maximum) therefore falls inside
    these near ties."""
    import numpy as np

    rng = np.random.RandomState(seed)
    bf = mips.bf16_round
    x = np.zeros((n_chunks * cand, d), np.float32)
    x[:, :r] = bf(rng.randn(len(x), r) * 0.1)
    q = np.zeros((b, d), np.float32)
    q[:, :r - 3] = bf(rng.randn(b, r - 3))
    q[:, r - 3:r] = [1.0, 2.0 ** -8, 2.0 ** -16]
    used = set()
    for i in range(b):
        rows = []
        for c in rng.choice(n_chunks, k_chunks + 1, replace=False):
            row = c * cand + rng.randint(cand)
            while row in used:
                row = c * cand + rng.randint(cand)
            used.add(row)
            rows.append(row)
        base = bf(0.5 * q[i, :r - 3] + 0.05 * rng.randn(k_chunks + 1, r - 3))
        part = base.astype(np.float64) @ q[i, :r - 3].astype(np.float64)
        target = part.max() + 1.0
        eps = target * 2.0 ** -(14 + i % 12)
        need = target + rng.randint(-4, 5, size=k_chunks + 1) * eps - part
        y1 = bf(need)
        need = need - y1
        y2 = bf(need * 2.0 ** 8)
        need = need - y2.astype(np.float64) * 2.0 ** -8
        y3 = bf(need * 2.0 ** 16)
        x[rows, :r - 3] = base
        x[rows, r - 3], x[rows, r - 2], x[rows, r - 1] = y1, y2, y3
    return x, q, np.eye(d, r, dtype=np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pca_certificate_holds_at_kernel_3_near_ties(dev, monkeypatch, seed):
    """Kernel 3's tensor-core chunk maxima against the certificate of
    ``mips_topk_pca`` (bf16 index, kernels 3 and 5): with every other
    bound term 0 and planted near ties across the certificate boundary,
    no certified query may have a row outside the chunks it rescanned
    whose float64 score is above the value it returned.  The queries
    whose margin at the boundary lies within kernel 3's largest error on
    this data (the cases the test can see; there must be some) and the
    certified ones are printed.  Without kernel 3's error bound in the
    upper bounds every seed here certified wrong queries (three at seed
    0, margins down to -1.0e-5 at scores near 63)."""
    import numpy as np

    cand = 512
    x, q, rot = _near_tie_index(seed, cand=cand)
    proj, bounds = mips.build_pca_prefilter(x, rot, cand_rows=cand)
    assert bounds[:2].max() < 1e-30       # no residual, no storage error
    seen = {}
    rescan = mips.rescan

    def recorded(chunk_ids, *args):
        seen["chunks"] = chunk_ids.cpu().numpy()
        return rescan(chunk_ids, *args)

    monkeypatch.setattr(mips, "rescan", recorded)
    proj_d = torch.from_numpy(proj).to(dev, torch.bfloat16)
    vals, ids, cert = mips.mips_topk_pca(
        torch.from_numpy(x).to(dev, torch.bfloat16), proj_d,
        torch.from_numpy(rot).to(dev), torch.from_numpy(bounds).to(dev),
        torch.from_numpy(q).to(dev), 1, k_chunks=8, cand_rows=cand)
    maxp = mips.pca_chunk_max(torch.from_numpy(q[:, :rot.shape[1]]).to(
        dev, torch.bfloat16), proj_d, cand).cpu().numpy()
    torch.cuda.synchronize()
    exact = (q.astype(np.float64) @ x.astype(np.float64).T).reshape(
        len(q), -1, cand).max(2)                       # (B, chunks)
    err = np.abs(maxp - exact).max()
    outside = exact.copy()
    np.put_along_axis(outside, seen["chunks"].astype(np.int64), -np.inf,
                      axis=1)
    v = vals.cpu().numpy()[:, 0].astype(np.float64)
    cert = cert.cpu().numpy()
    margin = v - outside.max(1)
    sharp = int((np.abs(margin) < err).sum())
    print(f"kernel 3 max error {err:.3g}; {sharp} of {len(q)} queries "
          f"within it of the next chunk; certified {cert.sum()}, smallest "
          f"certified margin {margin[cert].min():.3g}")
    assert cert.any() and sharp > 0
    bad = np.flatnonzero(cert & (margin < 0))
    assert not len(bad), (bad, margin[bad])


def test_default_card_encode_never_copies_the_encoder(dev, monkeypatch):
    """The default device is a bare ``cuda`` while the module's parameters
    report ``cuda:0``: the two name one card, so encoding on it uses the
    caller's module and makes no copy of it."""
    from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
    from multihop_dense_retrieval_tpu_torch.core.device import resolve_device
    from multihop_dense_retrieval_tpu_torch.index import build
    from multihop_dense_retrieval_tpu_torch.models import MhopRetriever

    model = MhopRetriever(EncoderConfig.tiny(), cls_only=True).to(dev)
    monkeypatch.setattr(build.copy, "deepcopy", lambda _: pytest.fail(
        "the encoder was copied"))
    assert build._replicas(model.encode_seq, [resolve_device(None)]) == \
        [model.encode_seq]


def _small_mhop_batch(seed, b=8):
    """A ragged multi-hop batch of ``b`` rows for a 96-token vocabulary."""
    import numpy as np

    rng = np.random.RandomState(seed)
    batch = {}
    for name, width in (("q", 12), ("q_sp", 24), ("c1", 16), ("c2", 16),
                        ("neg1", 16), ("neg2", 16)):
        lens = rng.randint(4, width + 1, size=b)
        mask = (np.arange(width)[None] < lens[:, None]).astype(np.int32)
        batch[f"{name}_input_ids"] = np.where(
            mask > 0, rng.randint(4, 96, size=(b, width)), 1).astype(np.int32)
        batch[f"{name}_mask"] = mask
    return batch


def _parallel_devices(layout):
    if layout == "two cards":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards")
        return [torch.device("cuda", 0), torch.device("cuda", 1)]
    return [torch.device("cuda", 0)] * 2


@pytest.mark.parametrize("layout", ["one card twice", "two cards"])
@pytest.mark.parametrize("tp", [False, True], ids=["dp", "tp"])
def test_parallel_train_step_on_card_matches_single_device(dev, layout, tp):
    """A data-parallel (data 2) or tensor-parallel (index 2) train step of
    a 2-layer, 64-wide retriever (fp32 compute, TF32 off) on the card,
    against the single-device card step from the same weights and batch:
    chip_smoke.hold_step's criteria (leg j0's: the loss within 1e-5
    relative, the gradients within 1e-6 + 1e-4 of each tensor's largest,
    the parameters within ``adam_bound``), and for the tensor-parallel
    step also tests/test_parallel.py's.  On two cards the data entries
    compute on a copy of the model on cuda:1, the blocks live there."""
    import chip_smoke
    from multihop_dense_retrieval_tpu_torch.core.config import (
        EncoderConfig, RetrieverTrainConfig)
    from multihop_dense_retrieval_tpu_torch.core.mesh import make_mesh
    from multihop_dense_retrieval_tpu_torch.models import MhopRetriever
    from multihop_dense_retrieval_tpu_torch.parallel import shard_params
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    devs = _parallel_devices(layout)
    torch.manual_seed(0)
    base = MhopRetriever(EncoderConfig.tiny(
        vocab_size=96, max_position_embeddings=40, hidden_size=64,
        intermediate_size=128), cls_only=True, fp32_params=True)
    batch = _small_mhop_batch(1)
    mesh = make_mesh(data=1 if tp else 2, index=2 if tp else 1, devices=devs)
    tcfg = RetrieverTrainConfig(learning_rate=1e-3, warmup_ratio=0.0)
    ref = chip_smoke.run_step(T, base, T.make_train_step, batch, tcfg,
                              devs[0])
    got = chip_smoke.run_step(
        T, base, lambda: T.make_train_step(mesh=mesh, tensor_parallel=tp),
        batch, tcfg, devs[0],
        prepare=(lambda m: shard_params(m, mesh)) if tp else None)
    r = chip_smoke.hold_step(T, ref, got, tcfg)
    if tp:
        chip_smoke.jax_tp_criteria(got[2], ref[2], tcfg.learning_rate,
                                   ref[1], r["clip"])
        blocks = {p.device for n, p in got[4].model.named_parameters()
                  if n.endswith("query.weight.1")}
        assert blocks == {devs[1]}


def test_dp_by_tp_step_on_four_cards_matches_single_device(dev):
    """dp x tp in one step over four cards (data 2 x index 2: the model's
    blocks on cuda:0 and cuda:1, the second data row on a copy whose
    blocks sit on cuda:2 and cuda:3), against the single-device step by
    chip_smoke.hold_step's criteria and tests/test_parallel.py's."""
    import chip_smoke
    from multihop_dense_retrieval_tpu_torch.core.config import (
        EncoderConfig, RetrieverTrainConfig)
    from multihop_dense_retrieval_tpu_torch.core.mesh import make_mesh
    from multihop_dense_retrieval_tpu_torch.models import MhopRetriever
    from multihop_dense_retrieval_tpu_torch.parallel import shard_params
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    devs = [torch.device("cuda", i) for i in range(4)]
    torch.manual_seed(0)
    base = MhopRetriever(EncoderConfig.tiny(
        vocab_size=96, max_position_embeddings=40, hidden_size=64,
        intermediate_size=128), cls_only=True, fp32_params=True)
    batch = _small_mhop_batch(2)
    mesh = make_mesh(data=2, index=2, devices=devs)
    tcfg = RetrieverTrainConfig(learning_rate=1e-3, warmup_ratio=0.0)
    ref = chip_smoke.run_step(T, base, T.make_train_step, batch, tcfg,
                              devs[0])
    got = chip_smoke.run_step(
        T, base, lambda: T.make_train_step(mesh=mesh, tensor_parallel=True),
        batch, tcfg, devs[0], prepare=lambda m: shard_params(m, mesh))
    r = chip_smoke.hold_step(T, ref, got, tcfg)
    chip_smoke.jax_tp_criteria(got[2], ref[2], tcfg.learning_rate, ref[1],
                               r["clip"])
