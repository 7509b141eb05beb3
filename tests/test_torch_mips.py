"""MIPS parity: the port's plain versions of kernels 1-4 and its PCA tier
against the JAX package (Pallas kernels in interpret mode, or its XLA
tiers), on the same seeded numpy inputs.

Tolerances:
  * int8 paths: bit-equal.  An int8 dot over D <= 1040 terms is an integer
    below 2^24, exact in fp32 whatever the summation order, and the scale
    products are taken in the same order in both packages.
  * bf16/fp32 scores: bf16 products are exact in fp32, only the order of
    the fp32 sums differs, so values agree to rtol 1e-5 (a few ulps);
    ids are equal.
  * quantization, PCA projection and bounds: bit-equal (same host
    arithmetic, bf16 round-to-nearest-even on both sides).
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _anisotropic(rng, n, d, r0=8, noise=0.05):
    basis = np.linalg.qr(rng.randn(d, d))[0]
    z = rng.randn(n, r0) * np.linspace(3.0, 0.8, r0)
    return (z @ basis[:, :r0].T + noise * rng.randn(n, d)).astype(np.float32)


def test_quantize_rows_bit_equal():
    """Against the JAX function as its searches run it, under jit (XLA
    rewrites ``max / 127`` there as a product with the fp32 reciprocal)."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 48).astype(np.float32) * rng.rand(64, 1).astype(np.float32)
    x[3] = 0.0                                   # scale floor row
    x[5, :4] = [0.5, -0.5, 1.5, 127.0]           # half-way rounding
    jq, js = jax.jit(jm.quantize_rows)(jnp.asarray(x))
    tq, ts = tm.quantize_rows(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _int8_case(seed, n, d, b, dup=False):
    rng = np.random.RandomState(seed)
    emb = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    if dup:
        # duplicated rows tie exactly: the lower row id must win
        emb[700] = emb[12]
        emb[1500] = emb[12]
        q[0] = emb[12] * 3.0
    qi, sc = jm.quantize_rows(jnp.asarray(emb))
    return emb, q, qi, sc


@pytest.mark.parametrize("k,n_valid,dup", [(1, None, False), (3, None, True),
                                           (5, 1300, False), (7, 1030, True)])
def test_int8_scan_bit_equal_to_jax(k, n_valid, dup):
    n, d, b = 2048, 64, 8
    _, q, qi, sc = _int8_case(1, n, d, b, dup)
    jv, ji = jm.mips_topk_pallas_int8(qi, sc, jnp.asarray(q), k,
                                      chunk_rows=512, interpret=True,
                                      n_valid=n_valid)
    xv, xi = jm.mips_topk_xla_int8(qi, sc, jnp.asarray(q), k, chunk_rows=512,
                                   n_valid=n_valid)
    tq, ts = tm.quantize_rows(_t(q))
    tv, ti = tm.mips_scan_int8(tq, ts, _t(np.asarray(qi)), _t(np.asarray(sc)),
                               k, n_valid)
    for ev, ei in ((jv, ji), (xv, xi)):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(ev))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ei))
    if dup:
        assert ti[0, 0].item() == 12


def test_int8_scan_fillers_when_k_exceeds_valid_rows():
    """Fewer valid rows than k: the tail is (NEG_INF, id 0), as the JAX
    merge gives."""
    n, d, b, k = 1024, 32, 4, 6
    _, q, qi, sc = _int8_case(2, n, d, b)
    xv, xi = jm.mips_topk_xla_int8(qi, sc, jnp.asarray(q), k, chunk_rows=256,
                                   n_valid=4)
    tq, ts = tm.quantize_rows(_t(q))
    tv, ti = tm.mips_scan_int8(tq, ts, _t(np.asarray(qi)), _t(np.asarray(sc)),
                               k, 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(xv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    assert (ti[:, 4:] == 0).all() and (tv[:, 4:] == tm.NEG_INF).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k,n_valid", [(1, None), (4, 1500)])
def test_float_scan_matches_jax(dtype, k, n_valid):
    rng = np.random.RandomState(3)
    n, d, b = 2048, 64, 8
    emb = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    jidx = jnp.asarray(emb, jnp.dtype(dtype))
    jv, ji = jm.mips_topk_pallas(jidx, jnp.asarray(q), k, chunk_rows=512,
                                 interpret=True, n_valid=n_valid)
    tidx = _t(emb).to(getattr(torch, dtype))
    tv, ti = tm.mips_scan(_t(q), tidx, k, n_valid)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


def test_dispatcher_matches_jax_xla_tier():
    rng = np.random.RandomState(4)
    emb = rng.randn(1000, 32).astype(np.float32)
    q = rng.randn(6, 32).astype(np.float32)
    for k in (2, 9):   # 9: the CPU path has no k limit
        jv, ji = jm.mips_topk(jnp.asarray(emb), jnp.asarray(q), k,
                              use_pallas=False, chunk_rows=256)
        tv, ti = tm.mips_topk(_t(emb), _t(q), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5)


def _jax_chunk_max(qp, proj, cand_rows, step_rows, n_valid):
    """The JAX package's phase-1 kernel, called as mips_topk_pca calls it."""
    n, r = proj.shape
    b = qp.shape[0]
    nv = jnp.asarray([n if n_valid is None else n_valid], jnp.int32)
    out = pl.pallas_call(
        functools.partial(jm._chunk_max_fine_kernel, step_rows=step_rows,
                          cand_rows=cand_rows, mask_valid=n_valid is not None),
        grid_spec=pl.GridSpec(
            grid=(n // step_rows,),
            in_specs=[pl.BlockSpec((b, r), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec((step_rows, r), lambda i: (i, 0),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec(memory_space=pltpu.SMEM)],
            out_specs=pl.BlockSpec((step_rows // cand_rows, b),
                                   lambda i: (i, 0), memory_space=pltpu.VMEM)),
        out_shape=jax.ShapeDtypeStruct((n // cand_rows, b), jnp.float32),
        interpret=True)(qp, proj, nv)
    return np.asarray(out).T


@pytest.mark.parametrize("n_valid", [None, 1700])
def test_pca_chunk_max_matches_jax_kernel(n_valid):
    rng = np.random.RandomState(5)
    n, r, b, cand = 2048, 32, 8, 128
    proj = rng.randn(n, r).astype(np.float32)
    qp = rng.randn(b, r).astype(np.float32)
    jp, jq = jnp.asarray(proj, jnp.bfloat16), jnp.asarray(qp, jnp.bfloat16)
    exp = _jax_chunk_max(jq, jp, cand, 512, n_valid)
    got = tm.pca_chunk_max(_t(qp).to(torch.bfloat16),
                           _t(proj).to(torch.bfloat16), cand, n_valid)
    assert got.shape == (b, n // cand)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)
    if n_valid is not None:
        assert (got[:, n_valid // cand + 1:] == tm.NEG_INF).all()


@pytest.mark.parametrize("n_valid", [None, 1900])
def test_pca_rescan_int8_bit_equal_to_jax(n_valid):
    rng = np.random.RandomState(6)
    n, d, b, cand, kc = 2048, 64, 8, 128, 4
    emb = rng.randn(n, d).astype(np.float32)
    qi, sc = jm.quantize_rows(jnp.asarray(emb))
    q = rng.randn(b, d).astype(np.float32)
    q_used, _ = jm.quantize_rows(jnp.asarray(q))
    ids = np.stack([rng.choice(n // cand, kc, replace=False)
                    for _ in range(b)]).astype(np.int32)
    ids[0, 0] = n // cand - 1                   # the chunk holding pad rows
    nv = jnp.asarray([n if n_valid is None else n_valid], jnp.int32)
    exp = jm._sparse_rescan(jnp.asarray(ids), nv, q_used, qi,
                            sc.reshape(n // cand, cand), chunk_rows=cand,
                            k_chunks=kc, mask_valid=n_valid is not None,
                            interpret=True)
    got = tm.pca_rescan_int8(_t(ids), _t(np.asarray(q_used)),
                             _t(np.asarray(qi)), _t(np.asarray(sc)), cand,
                             n_valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("store", ["int8", "bfloat16", "float32"])
def test_build_pca_prefilter_bit_equal(store):
    rng = np.random.RandomState(7)
    emb = _anisotropic(rng, 1000, 64)
    rot_j = jm.train_pca_rotation(emb[:512], 24)
    rot_t = tm.train_pca_rotation(emb[:512], 24)
    np.testing.assert_array_equal(rot_t, rot_j)
    scales = None
    if store == "int8":
        scales = np.asarray(jm.quantize_rows(jnp.asarray(emb))[1])
    pj, bj = jm.build_pca_prefilter(emb, rot_j, cand_rows=128, n_pad=1024,
                                    scales=scales, store_dtype=store)
    pt, bt = tm.build_pca_prefilter(emb, rot_t, cand_rows=128, n_pad=1024,
                                    scales=scales, store_dtype=store)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(
        _t(pt).to(torch.bfloat16).view(torch.int16).numpy(),
        np.asarray(jnp.asarray(pj, jnp.bfloat16).view(jnp.int16)))


@pytest.mark.parametrize("store,k", [("int8", 1), ("int8", 3),
                                     ("bfloat16", 2), ("float32", 4)])
def test_mips_topk_pca_matches_jax(store, k):
    rng = np.random.RandomState(8)
    n, d, b, cand, kc = 4096, 64, 16, 128, 4
    emb = _anisotropic(rng, n, d)
    rot = jm.train_pca_rotation(emb[:1024], 32)
    scales = None
    if store == "int8":
        qi, sc = jm.quantize_rows(jnp.asarray(emb))
        scales = np.asarray(sc)
        jidx, tidx = qi, _t(np.asarray(qi))
    else:
        jidx = jnp.asarray(emb, jnp.dtype(store))
        tidx = _t(emb).to(getattr(torch, store))
    proj, bounds = jm.build_pca_prefilter(emb, rot, cand_rows=cand,
                                          scales=scales, store_dtype=store)
    planted = emb[rng.choice(n, b, replace=False)] \
        + 0.05 * rng.randn(b, d).astype(np.float32)
    n_valid = n - 100
    jv, ji, jc = jm.mips_topk_pca(
        jidx, jnp.asarray(proj, jnp.bfloat16), jnp.asarray(rot),
        jnp.asarray(bounds), jnp.asarray(planted), k, k_chunks=kc,
        cand_rows=cand, step_rows=512, interpret=True, n_valid=n_valid,
        doc_scales=None if scales is None else jnp.asarray(scales))
    tv, ti, tc = tm.mips_topk_pca(
        tidx, _t(proj).to(torch.bfloat16), _t(rot), _t(bounds), _t(planted),
        k, k_chunks=kc, cand_rows=cand, n_valid=n_valid,
        doc_scales=None if scales is None else _t(scales))
    jc = np.asarray(jc)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert jc.sum() >= b // 2, jc
    for row in np.nonzero(jc)[0]:
        np.testing.assert_array_equal(ti[row].numpy(), np.asarray(ji)[row])
        np.testing.assert_allclose(tv[row].numpy(), np.asarray(jv)[row],
                                   rtol=1e-5, atol=1e-5)


def test_merge_multivector_matches_jax():
    rng = np.random.RandomState(9)
    vals = -np.sort(-rng.randn(5, 12).astype(np.float32), axis=1)
    rows = rng.randint(0, 40, size=(5, 12)).astype(np.int32)
    jv, jd = jm.merge_multivector(jnp.asarray(vals), jnp.asarray(rows), 4, 3)
    tv, td = tm.merge_multivector(_t(vals), _t(rows), 4, 3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_topk_lower_index_breaks_ties_like_lax():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = tm.topk_lower_index(_t(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
