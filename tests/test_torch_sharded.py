"""Row-sharded MIPS and the device mesh: the port's ``core/mesh.py`` and
``ops/mips.py::sharded_mips_topk`` / ``sharded_mips_topk_pca`` against
the JAX package's (the cases of tests/test_mips.py), on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's mesh repeats the CPU device (``[cpu] * n``), which is how it stands
in for them.  Every case runs at 2, 4 and 8 shards over a padded tail whose
valid rows all score below 0 (zero pad rows would score 0 and win if the
padding leaked), so that at 4 and 8 shards the last shards hold padding
only.

Tolerances:
  * int8: ids and values bit-equal (exact integer dots, the same scale
    products in the same order), except at k >= 8, where the port's
    shards take the two-phase search, whose epilogue is (raw · d_scale) ·
    q_scale, and JAX's sharded search on the CPU its XLA tier, (raw ·
    q_scale) · d_scale: the two roundings of each order put the values
    within 2 fp32 ulps;
  * fp32 and bf16: ids equal, values within rtol 1e-5 (fp32 sums of the
    same products in another order);
  * PCA: certificate masks equal, ids equal, values as above, and every
    certified query equals brute force.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core import mesh as jmesh
from multihop_dense_retrieval_tpu.ops import mips as jm
from multihop_dense_retrieval_tpu_torch.core import mesh as tmesh
from multihop_dense_retrieval_tpu_torch.core.device import (normal_device,
                                                            world)
from multihop_dense_retrieval_tpu_torch.ops import mips as tm

CPU = torch.device("cpu")
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _torch(a):
    """A JAX array as a torch tensor of its dtype (bf16 by its bits)."""
    if a.dtype == jnp.bfloat16:
        return _t(np.asarray(a.view(jnp.int16))).view(torch.bfloat16)
    return _t(np.asarray(a))


def _meshes(shards, data=None):
    """The JAX mesh over the virtual devices and the port's over [cpu]."""
    n = len(jax.devices())
    jm_ = jmesh.make_mesh(data=data or n // shards, index=shards)
    tm_ = tmesh.make_mesh(data=data or 1, index=shards,
                          devices=[CPU] * (shards * (data or 1)))
    return jm_, tm_


def _brute(index, queries, k, n_valid=None):
    x = np.asarray(index, np.float32)[:n_valid]
    scores = np.asarray(queries, np.float32) @ x.T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def test_make_mesh_shapes_and_rejects_oversized_axes():
    """The JAX rules (tests/test_mips.py::test_make_mesh_rejects_oversized_
    axes): an axis larger than the devices raises, a strict subset of them
    is allowed; the default layout puts every device on the index axis."""
    devs = [CPU] * 8
    with pytest.raises(ValueError, match="does not fit"):
        tmesh.make_mesh(index=16, devices=devs)
    with pytest.raises(ValueError, match="does not fit"):
        tmesh.make_mesh(data=8, index=2, devices=devs)
    for kw in (dict(data=2, index=1), dict(), dict(index=2),
               dict(data=2, index=4)):
        got = tmesh.make_mesh(devices=devs, **kw)
        exp = jmesh.make_mesh(**kw)
        assert got.shape == dict(exp.shape), kw
        assert got.shard_devices() == [CPU] * got.shape["index"]
    # without cards and without a list, the visible cards: none here
    with pytest.raises(ValueError, match="does not fit the 0"):
        tmesh.make_mesh(index=2)
    assert tmesh.local_devices("cpu", 3) == [CPU] * 3
    assert tmesh.local_devices("cuda", 3) == []


def _negative_padded(seed, d, b, n_pad=2048, n_valid=1348):
    """All-positive queries x all-negative rows: every valid score is
    below 0, the zero pad rows score 0."""
    rng = np.random.RandomState(seed)
    index = np.zeros((n_pad, d), np.float32)
    index[:n_valid] = -np.abs(rng.randn(n_valid, d)) - 0.01
    q = np.abs(rng.randn(b, d)).astype(np.float32) + 0.01
    return index, q, n_valid


@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_mips_matches_jax(shards, dtype, k):
    """k = 5 takes the scan on every shard; k = 10 the two-phase search
    (kernels 6/7 + 4/5) on the port's shards, the XLA tier on JAX's."""
    index, q, n_valid = _negative_padded(3 + shards, 32, 8)
    jmesh_, tmesh_ = _meshes(shards)
    scales = None
    if dtype == "int8":
        qi, sc = jax.jit(jm.quantize_rows)(jnp.asarray(index))
        jidx, tidx = qi, _t(np.asarray(qi))
        scales = (sc, _t(np.asarray(sc)))
    else:
        jidx = jnp.asarray(index, _JDT[dtype])
        tidx = _t(index).to(_TDT[dtype])
    jv, ji = jm.sharded_mips_topk(
        jidx, jnp.asarray(q), k, jmesh_, use_pallas=False, chunk_rows=256,
        n_valid=n_valid, doc_scales=None if scales is None else scales[0])
    tv, ti = tm.sharded_mips_topk(
        tidx, _t(q), k, tmesh_, chunk_rows=256, n_valid=n_valid,
        doc_scales=None if scales is None else scales[1])
    assert (tv.numpy() < 0).all(), "pad rows leaked into the top-k"
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if dtype == "int8" and k < 8:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    elif dtype == "int8":
        np.testing.assert_array_max_ulp(tv.numpy(), np.asarray(jv), maxulp=2)
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
        ref = np.asarray(jidx.astype(jnp.float32))
        _, bi = _brute(ref, np.asarray(jnp.asarray(q).astype(jidx.dtype),
                                       np.float32), k, n_valid)
        np.testing.assert_array_equal(ti.numpy(), bi)


def test_sharded_unpadded_and_2d_mesh_match_single_device():
    """tests/test_mips.py's test_sharded_matches_single_device and
    test_sharded_2d_mesh: no padding, an 8-shard mesh and a (2, 4) one."""
    rng = np.random.RandomState(3)
    index = rng.randn(8 * 512, 64).astype(np.float32)
    q = rng.randn(16, 64).astype(np.float32)
    v_ref, i_ref = tm.mips_topk(_t(index), _t(q), 5, chunk_rows=512)
    for shards, data in ((8, None), (4, 2)):
        jmesh_, tmesh_ = _meshes(shards, data)
        tv, ti = tm.sharded_mips_topk(_t(index), _t(q), 5, tmesh_,
                                      chunk_rows=512)
        jv, ji = jm.sharded_mips_topk(jnp.asarray(index), jnp.asarray(q), 5,
                                      jmesh_, use_pallas=False,
                                      chunk_rows=512)
        assert torch.equal(ti, i_ref)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), v_ref.numpy(), rtol=1e-5)


def test_sharded_merge_ties_go_to_the_lower_shard():
    """Rows duplicated across shards tie exactly: the merge keeps the copy
    in the lower shard (then the lower local rank), as lax.top_k on the
    tiled all_gather does."""
    rng = np.random.RandomState(5)
    index = rng.randn(1024, 16).astype(np.float32)
    index[700] = index[12]
    index[900] = index[12]
    q = np.tile(index[12:13], (8, 1)) + 0.001 * rng.randn(8, 16).astype(
        np.float32)
    jmesh_, tmesh_ = _meshes(4)
    qi, sc = jax.jit(jm.quantize_rows)(jnp.asarray(index))
    jv, ji = jm.sharded_mips_topk(qi, jnp.asarray(q), 3, jmesh_,
                                  use_pallas=False, chunk_rows=256,
                                  doc_scales=sc)
    tv, ti = tm.sharded_mips_topk(_t(np.asarray(qi)), _t(q), 3, tmesh_,
                                  chunk_rows=256,
                                  doc_scales=_t(np.asarray(sc)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (ti.numpy()[:, :3] == [12, 700, 900]).all()


def _anisotropic(rng, n, d, r0=8, noise=0.05):
    basis = np.linalg.qr(rng.randn(d, d))[0]
    z = rng.randn(n, r0) * np.linspace(3.0, 0.8, r0)
    return (z @ basis[:, :r0].T + noise * rng.randn(n, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_pca_matches_jax(shards, dtype):
    """tests/test_mips.py::test_sharded_pca_certified_matches_bruteforce
    over a padded tail of 1,200 rows (at 4 and 8 shards the last shards
    are all padding): per-shard prefilters, global ids, the certificate
    the AND over shards."""
    rng = np.random.RandomState(27)
    n, d, b, k, cand = 8 * 512, 64, 16, 2, 128
    n_valid = n - 1200
    emb = _anisotropic(rng, n, d)
    emb[n_valid:] = 0.0
    planted = emb[rng.choice(n_valid, b, replace=False)] \
        + 0.05 * rng.randn(b, d).astype(np.float32)
    rot = jm.train_pca_rotation(emb[:1024], 32)
    if dtype == "int8":
        qi, sc = jax.jit(jm.quantize_rows)(jnp.asarray(emb))
        jidx, scales = qi, sc
        proj, bounds = jm.build_pca_prefilter(emb[:n_valid], rot,
                                              cand_rows=cand, n_pad=n,
                                              scales=np.asarray(sc)[:n_valid])
        stored = np.asarray(qi, np.float32) * np.asarray(sc)[:, None]
    else:
        jidx, scales = jnp.asarray(emb, jnp.bfloat16), None
        proj, bounds = jm.build_pca_prefilter(emb[:n_valid], rot,
                                              cand_rows=cand, n_pad=n)
        stored = np.asarray(jidx, np.float32)
    jproj = jnp.asarray(proj, jnp.bfloat16)
    jmesh_, tmesh_ = _meshes(shards)
    jv, ji, jc = jm.sharded_mips_topk_pca(
        jidx, jproj, jnp.asarray(rot), jnp.asarray(bounds),
        jnp.asarray(planted), k, jmesh_, k_chunks=3, cand_rows=cand,
        doc_scales=scales, n_valid_dyn=jnp.int32(n_valid), interpret=True)
    tv, ti, tc = tm.sharded_mips_topk_pca(
        _torch(jidx), _torch(jproj), _t(rot),
        _t(bounds), _t(planted), k, tmesh_, k_chunks=3, cand_rows=cand,
        n_valid=n_valid,
        doc_scales=None if scales is None else _t(np.asarray(scales)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
    assert ti.numpy().max() < n_valid
    cert = tc.numpy()
    assert cert.mean() >= 0.5, f"certification rate {cert.mean()}"
    if dtype == "int8":
        qq, qs = jax.jit(jm.quantize_rows)(jnp.asarray(planted))
        qvec = np.asarray(qq, np.float32) * np.asarray(qs)[:, None]
    else:
        qvec = np.asarray(jnp.asarray(planted).astype(jnp.bfloat16),
                          np.float32)
    _, bi = _brute(stored, qvec, k, n_valid)
    for row in np.nonzero(cert)[0]:
        np.testing.assert_array_equal(ti.numpy()[row], bi[row])


def test_sharded_pca_refuses_too_few_chunks_per_shard():
    """The JAX errors: cand_rows must divide a shard's rows, and a shard
    needs at least 2 candidate chunks."""
    _, tmesh_ = _meshes(4)
    x = torch.zeros(1024, 16)
    proj = torch.zeros(1024, 8, dtype=torch.bfloat16)
    rot, q = torch.zeros(16, 8), torch.zeros(8, 16)
    with pytest.raises(ValueError, match="cand_rows must divide"):
        tm.sharded_mips_topk_pca(x, proj, rot, torch.zeros(4, 5), q, 2,
                                 tmesh_, cand_rows=200)
    with pytest.raises(ValueError, match=">= 2 per shard"):
        tm.sharded_mips_topk_pca(x, proj, rot, torch.zeros(4, 4), q, 2,
                                 tmesh_, cand_rows=256)


def test_sharded_blocks_are_views_on_a_shared_device():
    """Shards on one device are views of the global tensor (no copy);
    gather gives it back."""
    _, tmesh_ = _meshes(4)
    x = torch.arange(64.0).reshape(16, 4)
    s = tmesh.Sharded.split(x, tmesh_)
    assert all(b.data_ptr() == x[4 * i:].data_ptr()
               for i, b in enumerate(s.blocks))
    assert torch.equal(s.gather(), x) and s.shape == x.shape
    cols = tmesh.Sharded.split(x.t().contiguous(), tmesh_, axis=1)
    assert torch.equal(cols.gather(), x.t()) and cols.block_len == 4
    with pytest.raises(ValueError, match="equal shards"):
        tmesh.Sharded.split(torch.zeros(10, 4), tmesh_)


def _owns_its_storage(t):
    return t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_sharded_blocks_on_distinct_devices_own_their_storage():
    """Over two distinct devices (``cpu`` and ``cpu:0`` are two names),
    split copies the block that stays on the array's device, so that the
    whole array can be freed; grow rebuilds every block at the longer
    length from the old blocks' pieces, zeros past the old end."""
    mesh = tmesh.make_mesh(index=2, devices=[CPU, torch.device("cpu", 0)])
    x = torch.arange(48.0).reshape(12, 4)
    s = tmesh.Sharded.split(x, mesh)
    assert all(_owns_its_storage(b) for b in s.blocks)
    assert torch.equal(s.gather(), x)
    g = s.grow(20)
    assert [b.shape[0] for b in g.blocks] == [10, 10] and g.shape[0] == 20
    assert all(_owns_its_storage(b) for b in g.blocks)
    assert torch.equal(g.gather(), torch.cat([x, torch.zeros(8, 4)]))
    cols = tmesh.Sharded.split(x.t().contiguous(), mesh, axis=1).grow(16)
    assert torch.equal(cols.gather(),
                       torch.cat([x.t(), torch.zeros(4, 4)], dim=1))
    with pytest.raises(ValueError, match="equal shards"):
        s.grow(21)


def test_normal_device_names_the_current_card(monkeypatch):
    """A bare ``cuda`` takes the current card's index (the device a tensor
    placed there reports); other devices are left as named."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert normal_device("cuda") == torch.device("cuda", 3)
    assert normal_device("cuda:1") == torch.device("cuda", 1)
    assert normal_device(CPU) == CPU
    assert tmesh.make_mesh(devices=["cuda"] * 2).devices == (
        (torch.device("cuda", 3),) * 2,)


def test_pod_helpers_are_no_ops_in_one_process():
    """host_local_batch_to_global / replicate_to_global (JAX core/mesh.py
    :79-104) return their input in a single process, as JAX's do; the
    world is (rank 0, 1 process) without a process group."""
    _, tmesh_ = _meshes(2)
    batch = {"q": np.arange(6).reshape(2, 3)}
    assert tmesh.host_local_batch_to_global(batch, tmesh_) is batch
    tree = {"w": np.ones(3)}
    assert tmesh.replicate_to_global(tree, tmesh_) is tree
    assert world() == (0, 1)
    assert not tmesh_.spans_processes
    assert tmesh_.local_shards() == [(0, CPU), (1, CPU)]
