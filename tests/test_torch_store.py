"""Index store parity: the port's DenseIndex.build quantizes and pads like
the JAX package's (bit-equal), and an index saved by either package loads
in the other and gives the same top-k (ids equal; int8 scores bit-equal,
float scores to rtol 1e-5 from fp32 summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.index.store import DenseIndex as JaxIndex
from multihop_dense_retrieval_tpu.ops import mips as jm
from multihop_dense_retrieval_tpu_torch.index import DenseIndex
from multihop_dense_retrieval_tpu_torch.ops import mips as tm

_JDT = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}


def _emb(seed, n=900, d=32):
    rng = np.random.RandomState(seed)
    basis = np.linalg.qr(rng.randn(d, d))[0]
    z = rng.randn(n, 6) * np.linspace(3.0, 0.8, 6)
    return (z @ basis[:, :6].T + 0.05 * rng.randn(n, d)).astype(np.float32)


def _host(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jhost(a):
    a = np.asarray(a if a.dtype != jnp.bfloat16 else a.view(jnp.int16))
    return a


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_build_bit_equal_to_jax(dtype):
    emb = _emb(0)
    j = JaxIndex.build(emb, chunk_rows=256, dtype=_JDT[dtype], pca_dims=8,
                       pca_cand_rows=128)
    t = DenseIndex.build(emb, chunk_rows=256, dtype=dtype, pca_dims=8,
                         pca_cand_rows=128, device="cpu")
    assert t.n_docs == j.n_docs and t.vectors.shape == j.vectors.shape
    np.testing.assert_array_equal(_host(t.vectors), _jhost(j.vectors))
    if dtype == "int8":
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_array_equal(t.pca_rot.numpy(), np.asarray(j.pca_rot))
    np.testing.assert_array_equal(_host(t.pca_proj), _jhost(j.pca_proj))
    np.testing.assert_array_equal(t.pca_bounds.numpy(),
                                  np.asarray(j.pca_bounds))


def _topk_jax(idx, q, k):
    return jm.mips_topk(idx.vectors, jnp.asarray(q), k, use_pallas=False,
                        chunk_rows=256, n_valid=idx.n_docs,
                        doc_scales=idx.scales)


def _topk_torch(idx, q, k):
    return tm.mips_topk(idx.vectors, torch.from_numpy(q), k,
                        n_valid=idx.n_docs, doc_scales=idx.scales)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_round_trip_across_packages(tmp_path, dtype, writer):
    emb = _emb(1)
    q = np.random.RandomState(2).randn(5, 32).astype(np.float32)
    path = str(tmp_path / "index.npz")
    if writer == "jax":
        JaxIndex.build(emb, chunk_rows=256, dtype=_JDT[dtype], pca_dims=8,
                       pca_cand_rows=128).save(path)
    else:
        DenseIndex.build(emb, chunk_rows=256, dtype=dtype, pca_dims=8,
                         pca_cand_rows=128, device="cpu").save(path)
    j = JaxIndex.load(path)
    t = DenseIndex.load(path, device="cpu")
    assert (t.n_docs, t.chunk_rows, t.multi_vector, t.pca_cand_rows) == \
        (j.n_docs, j.chunk_rows, j.multi_vector, j.pca_cand_rows)
    np.testing.assert_array_equal(_host(t.vectors), _jhost(j.vectors))
    np.testing.assert_array_equal(_host(t.pca_proj), _jhost(j.pca_proj))
    jv, ji = _topk_jax(j, q, 4)
    tv, ti = _topk_torch(t, q, 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if dtype == "int8":
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5)


def test_build_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseIndex.build(_emb(3, n=64), chunk_rows=64)
