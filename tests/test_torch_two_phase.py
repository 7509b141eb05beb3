"""Two-phase exact MIPS parity: the port's kernels 5-7 (through their plain
twins on the CPU), ``mips_topk_two_phase``, the dispatcher's route and the
bf16 PCA rescan against the JAX package (Pallas kernels in interpret mode),
on the same seeded numpy inputs.

Tolerances:
  * int8: bit-equal.  An int8 dot over D <= 1040 terms is an integer below
    2^24, exact in fp32 whatever the summation order, and the scale
    products are taken in the JAX order (float(raw) * d_scale, then
    * q_scale).  Ties included: both sides break them by position.
  * bf16/fp32 scores: bf16 products are exact in fp32; only the order of
    the fp32 sums differs, so values agree to rtol 1e-5 and ids are equal
    (the fixtures' score gaps are far wider, which the tests check).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from multihop_dense_retrieval_tpu.ops import mips as jm
from multihop_dense_retrieval_tpu_torch.ops import mips as tm

_TDT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _index(rng, n, d, dtype, dup=False):
    """(numpy fp32 rows, JAX index, port index, JAX scales, port scales);
    with ``dup`` rows 12, 700 and 1500 are equal (ties across chunks)."""
    emb = rng.randn(n, d).astype(np.float32)
    if dup:
        emb[700] = emb[12]
        emb[1500] = emb[12]
    if dtype == "int8":
        qi, sc = jm.quantize_rows(jnp.asarray(emb))
        return emb, qi, _t(qi), sc, _t(sc)
    jidx = jnp.asarray(emb, jnp.dtype(dtype))
    return emb, jidx, _t(emb).to(_TDT[dtype]), None, None


def _jax_chunk_max(q, index, chunk_rows, n_valid, dsc=None):
    """The JAX package's phase-1 kernels, called as mips_topk_two_phase
    calls them (transposed (num_chunks, B) blocks), returned as
    (B, num_chunks)."""
    n, d = index.shape
    b = q.shape[0]
    num_chunks = n // chunk_rows
    nv = jnp.asarray([n if n_valid is None else n_valid], jnp.int32)
    nc_pad = -(-num_chunks // jm._MAXBLOCK) * jm._MAXBLOCK
    out_spec = pl.BlockSpec((jm._MAXBLOCK, b), lambda i: (i // jm._MAXBLOCK, 0),
                            memory_space=pltpu.VMEM)
    full = pl.BlockSpec((b, d), lambda i: (0, 0), memory_space=pltpu.VMEM)
    rows = pl.BlockSpec((chunk_rows, d), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    kw = dict(chunk_rows=chunk_rows, mask_valid=n_valid is not None)
    if dsc is None:
        kernel, specs, args = (jm._chunk_max_kernel, [full, rows, smem],
                               (q, index, nv))
    else:
        packed = dsc.astype(jnp.float32).reshape(n // 128, 128)
        specs = [full, rows,
                 pl.BlockSpec((chunk_rows // 128, 128), lambda i: (i, 0),
                              memory_space=pltpu.VMEM), smem]
        kernel, args = jm._chunk_max_kernel_int8, (q, index, packed, nv)
    out = pl.pallas_call(
        functools.partial(kernel, **kw),
        grid_spec=pl.GridSpec(grid=(num_chunks,), in_specs=specs,
                              out_specs=out_spec),
        out_shape=jax.ShapeDtypeStruct((nc_pad, b), jnp.float32),
        interpret=True)(*args)
    return np.asarray(out)[:num_chunks].T


@pytest.mark.parametrize("n_valid", [None, 1700])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_chunk_max_matches_jax_kernel(dtype, n_valid):
    rng = np.random.RandomState(11)
    n, d, b, chunk = 2048, 64, 8, 256
    emb, jidx, tidx, jsc, tsc = _index(rng, n, d, dtype)
    q = rng.randn(b, d).astype(np.float32)
    if dtype == "int8":
        jq = jm.quantize_rows(jnp.asarray(q))[0]
        exp = _jax_chunk_max(jq, jidx, chunk, n_valid, jsc)
        got = tm.chunk_max_int8(_t(jq), tidx, tsc, chunk, n_valid)
        np.testing.assert_array_equal(got.numpy(), exp)
    else:
        jq = jnp.asarray(q).astype(jidx.dtype)
        exp = _jax_chunk_max(jq, jidx, chunk, n_valid)
        got = tm.chunk_max(_t(q), tidx, chunk, n_valid)
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)
    assert got.shape == (b, n // chunk)
    if n_valid is not None:
        # chunks past the last valid row hold no valid row: NEG_INF
        assert (got[:, -(-n_valid // chunk):] == tm.NEG_INF).all()


@pytest.mark.parametrize("n_valid", [None, 1900])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_float_rescan_matches_jax_kernel(dtype, n_valid):
    """Kernel 5's twin against ``_sparse_rescan`` over bf16/fp32 rows."""
    rng = np.random.RandomState(12)
    n, d, b, cand, kc = 2048, 64, 8, 128, 5
    emb, jidx, tidx, _, _ = _index(rng, n, d, dtype)
    q = rng.randn(b, d).astype(np.float32)
    ids = np.stack([rng.choice(n // cand, kc, replace=False)
                    for _ in range(b)]).astype(np.int32)
    ids[0, 0] = n // cand - 1                   # the chunk holding pad rows
    nv = jnp.asarray([n if n_valid is None else n_valid], jnp.int32)
    jq = jnp.asarray(q).astype(jidx.dtype)
    exp = np.asarray(jm._sparse_rescan(
        jnp.asarray(ids), nv, jq, jidx, None, chunk_rows=cand, k_chunks=kc,
        mask_valid=n_valid is not None, interpret=True))
    got = tm.rescan(_t(ids), _t(q), tidx, cand, n_valid)
    assert got.shape == (b, kc * cand)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)
    if n_valid is not None:
        assert (got[0, n_valid % cand:cand] == tm.NEG_INF).all()


@pytest.mark.parametrize("layout", ["one_chunk", "repeat", "pad_chunk"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_rescan_edge_cases_match_jax_kernel(dtype, layout):
    """The rescan twin (kernels 4 and 5) against ``_sparse_rescan`` in
    interpret mode where the chunk-major template's schedule has its edge
    cases: every query selects the same chunk, a chunk id repeats within a
    query's list (its scores given twice), and the pad rows' chunk with
    n_valid cutting inside it.  int8 bit-equal; bf16 and fp32 as the other
    rescan tests."""
    rng = np.random.RandomState(17)
    n, d, b, cand, kc = 1024, 64, 9, 128, 3
    emb, jidx, tidx, jsc, tsc = _index(rng, n, d, dtype)
    q = rng.randn(b, d).astype(np.float32)
    ids = np.stack([rng.choice(n // cand, kc, replace=False)
                    for _ in range(b)]).astype(np.int32)
    n_valid = None
    if layout == "one_chunk":
        ids[:] = 2
    elif layout == "repeat":
        ids[:, 2] = ids[:, 0]
    else:
        ids[:, 1] = n // cand - 1
        n_valid = n - 50
    nv = jnp.asarray([n if n_valid is None else n_valid], jnp.int32)
    if dtype == "int8":
        jq, _ = jm.quantize_rows(jnp.asarray(q))
        tq = _t(np.asarray(jq))
        exp = np.asarray(jm._sparse_rescan(
            jnp.asarray(ids), nv, jq, jidx, jsc.reshape(n // cand, cand),
            chunk_rows=cand, k_chunks=kc, mask_valid=n_valid is not None,
            interpret=True))
        got = tm.pca_rescan_int8(_t(ids), tq, tidx, tsc, cand, n_valid)
        np.testing.assert_array_equal(got.numpy(), exp)
    else:
        jq = jnp.asarray(q).astype(jidx.dtype)
        exp = np.asarray(jm._sparse_rescan(
            jnp.asarray(ids), nv, jq, jidx, None, chunk_rows=cand,
            k_chunks=kc, mask_valid=n_valid is not None, interpret=True))
        got = tm.rescan(_t(ids), _t(q), tidx, cand, n_valid)
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)
    assert got.shape == (b, kc * cand)
    if layout == "repeat":
        assert (got[:, :cand] == got[:, 2 * cand:]).all()
    if layout == "pad_chunk":
        assert (got[:, cand + n_valid % cand:2 * cand] == tm.NEG_INF).all()


@pytest.mark.parametrize("k", [8, 12, 20])
@pytest.mark.parametrize("dtype,n_valid,dup", [
    ("int8", None, True), ("int8", 1950, False), ("bfloat16", None, False),
    ("float32", 1800, False)])
def test_two_phase_matches_jax(dtype, n_valid, dup, k):
    rng = np.random.RandomState(13)
    n, d, b, chunk = 2048, 64, 16, 128
    emb, jidx, tidx, jsc, tsc = _index(rng, n, d, dtype, dup)
    q = rng.randn(b, d).astype(np.float32)
    if dup:
        q[0] = emb[12] * 3.0          # rows 12, 700, 1500 tie at the top
    jv, ji = jm.mips_topk_two_phase(jidx, jnp.asarray(q), k, chunk_rows=chunk,
                                    interpret=True, n_valid=n_valid,
                                    doc_scales=jsc)
    tv, ti = tm.mips_topk_two_phase(tidx, _t(q), k, chunk_rows=chunk,
                                    n_valid=n_valid, doc_scales=tsc)
    assert ti.dtype == torch.int32 and tv.shape == (b, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if dtype == "int8":
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
        gaps = -np.diff(np.asarray(jv), axis=1)
        assert gaps.min() > 1e-5 * np.abs(np.asarray(jv)).max()
    if dup:
        assert ti[0, :3].tolist() == [12, 700, 1500]
    if n_valid is not None:
        assert (ti < n_valid).all()


@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_auto_chunk_rows_matches_jax(itemsize):
    for b in (1, 8, 100, 192, 200, 384, 1000, 4096):
        for d in (32, 128, 768, 1024, 4096):
            assert tm.auto_chunk_rows(b, d, itemsize) == \
                jm.auto_chunk_rows(b, d, itemsize), (b, d)


@pytest.mark.parametrize("b", [8, 12, 16])
@pytest.mark.parametrize("k", [4, 8, 20])
def test_dispatcher_route_and_result_match_jax(k, b, monkeypatch):
    """Route: two-phase iff k >= 8 and (B % 8 == 0 or k > 8), as
    ``two_phase_chunk`` states.  Results against ``jm.mips_topk`` in
    interpret mode.  At k=20, B=12 JAX takes its single-pass kernel and the
    port the two-phase search; both are the exact top-k, so on this
    tie-free data ids are equal, and values agree to an ulp (the int8
    epilogues multiply the two scales in the other order)."""
    rng = np.random.RandomState(14)
    n, d, chunk = 2048, 64, 256
    emb, jidx, tidx, jsc, tsc = _index(rng, n, d, "int8")
    q = rng.randn(b, d).astype(np.float32)
    calls = []
    two_phase = tm.mips_topk_two_phase
    monkeypatch.setattr(tm, "mips_topk_two_phase", lambda *a, **kw: (
        calls.append(kw["chunk_rows"]), two_phase(*a, **kw))[1])
    tv, ti = tm.mips_topk(tidx, _t(q), k, chunk_rows=chunk, n_valid=n - 30,
                          doc_scales=tsc)
    jv, ji = jm.mips_topk(jidx, jnp.asarray(q), k, chunk_rows=chunk,
                          interpret=True, n_valid=n - 30, doc_scales=jsc)
    want = chunk if k >= 8 and (b % 8 == 0 or k > 8) else 0
    assert tm.two_phase_chunk(n, b, d, 1, k, chunk) == want
    assert calls == ([chunk] if want else [])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if k > 8 and b % 8:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
        assert (-np.diff(np.asarray(jv), axis=1)).min() > 1e-5
    else:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_two_phase_chunk_rules():
    # the FEVER CLI's hop 2 (B=200 bf16) and the int8 engine's (B=384)
    assert tm.two_phase_chunk(1 << 18, 200, 768, 2, 20) == 2048
    assert tm.two_phase_chunk(1 << 20, 384, 768, 1, 20) == 2048
    assert tm.two_phase_chunk(1 << 20, 100, 768, 2, 20) == 2048
    assert tm.two_phase_chunk(1 << 20, 8, 128, 2, 20) == 4096     # chunk_rows
    assert tm.two_phase_chunk(1 << 20, 100, 768, 2, 8) == 0    # B % 8
    assert tm.two_phase_chunk(1 << 20, 192, 768, 1, 4) == 0    # k < 8
    assert tm.two_phase_chunk(3000, 8, 64, 1, 10) == 0         # N % chunk
    assert tm.two_phase_chunk(4096, 8, 64, 2, 300, 256) == 0   # k > chunk
    # JAX's VMEM rule gives 0 here (its XLA tier); the port's floor is 512
    assert jm.auto_chunk_rows(8192, 768, 2) == 0
    assert tm.two_phase_chunk(1 << 20, 8192, 768, 2, 10) == 512


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_mips_topk_pca_float_index_matches_jax(store, k):
    """Phase 2 through kernel 5's twin: every query (certified or not)
    returns the JAX ids, values to rtol 1e-5, the same certificates."""
    rng = np.random.RandomState(15)
    n, d, b, cand, kc = 4096, 64, 16, 128, 6
    basis = np.linalg.qr(rng.randn(d, d))[0]
    emb = ((rng.randn(n, 8) * np.linspace(3.0, 0.8, 8)) @ basis[:, :8].T
           + 0.05 * rng.randn(n, d)).astype(np.float32)
    rot = jm.train_pca_rotation(emb[:1024], 32)
    proj, bounds = jm.build_pca_prefilter(emb, rot, cand_rows=cand,
                                          store_dtype=store)
    q = emb[rng.choice(n, b, replace=False)] \
        + 0.05 * rng.randn(b, d).astype(np.float32)
    jv, ji, jc = jm.mips_topk_pca(
        jnp.asarray(emb, jnp.dtype(store)), jnp.asarray(proj, jnp.bfloat16),
        jnp.asarray(rot), jnp.asarray(bounds), jnp.asarray(q), k,
        k_chunks=kc, cand_rows=cand, step_rows=1024, interpret=True,
        n_valid=n - 70)
    tv, ti, tc = tm.mips_topk_pca(
        _t(emb).to(_TDT[store]), _t(proj).to(torch.bfloat16), _t(rot),
        _t(bounds), _t(q), k, k_chunks=kc, cand_rows=cand, n_valid=n - 70)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert np.asarray(jc).any()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)


def test_quantize_rows_matches_jitted_jax_on_many_rows():
    """The query scales every int8 search uses: equal to the jitted JAX
    function on every row, where the eager one (a true quotient) differs
    on some rows by an ulp."""
    rng = np.random.RandomState(16)
    x = (rng.randn(20000, 64) * rng.rand(20000, 1) * 10).astype(np.float32)
    jq, js = jax.jit(jm.quantize_rows)(jnp.asarray(x))
    tq, ts = tm.quantize_rows(_t(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    eager = np.asarray(jm.quantize_rows(jnp.asarray(x))[1])
    assert (eager != np.asarray(js)).any()
