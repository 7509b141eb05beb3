"""The port's HNSW binding (``index/hnsw.py``) against the JAX package's,
over the one ``native/hnsw.cpp``: a graph file written by either binding
loads in the other and searches to the same ids and scores, bit for bit
(the same source built with the same flags); the port's own build meets
tests/test_hnsw.py's recall bar; and the port's library lies in its own
build directory, never ``native/``."""

import threading
from pathlib import Path

import numpy as np
import pytest

from multihop_dense_retrieval_tpu.index.hnsw import HNSWIndex as JaxHNSW
from multihop_dense_retrieval_tpu_torch.index import hnsw as thnsw
from multihop_dense_retrieval_tpu_torch.index.hnsw import HNSWIndex

ROOT = Path(__file__).resolve().parent.parent
N, D = 2000, 64


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return (rng.randn(N, D).astype(np.float32),
            rng.randn(50, D).astype(np.float32))


def _same_search(a, b, q, k=10, ef=128):
    sa, ia = a.search(q, k, ef)
    sb, ib = b.search(q, k, ef)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(sa, sb)
    return sa, ia


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_file_is_shared_by_both_bindings(data, tmp_path, writer):
    vecs, q = data
    cls = JaxHNSW if writer == "jax" else HNSWIndex
    built = cls(D, M=16, ef_construction=100, seed=0)
    built.add(vecs)
    path = str(tmp_path / "index.hnsw")
    built.save(path)
    port, jax_side = HNSWIndex.load(path), JaxHNSW.load(path)
    assert len(port) == len(jax_side) == N
    _same_search(port, jax_side, q)
    _same_search(port, built, q)


def test_port_build_recall_vs_exact(data):
    vecs, q = data
    idx = HNSWIndex(D, M=16, ef_construction=100, seed=0)
    idx.add(vecs)
    scores, ids = idx.search(q, k=10, ef_search=128)
    exact = q @ vecs.T
    exact_ids = np.argsort(-exact, axis=1)[:, :10]
    recall = np.mean([len(set(ids[i]) & set(exact_ids[i])) / 10
                      for i in range(len(q))])
    assert recall >= 0.85, f"HNSW recall@10 too low: {recall}"
    rows = np.arange(len(q))[:, None]
    np.testing.assert_allclose(scores, exact[rows, ids], rtol=1e-4)
    assert np.all(np.diff(scores, axis=1) <= 1e-6)
    # fewer rows than k: the missing slots are id -1
    small = HNSWIndex(D, M=4, ef_construction=16)
    small.add(vecs[:3])
    _, ids = small.search(q[:2], k=5)
    assert (ids[:, 3:] == -1).all() and (ids[:, :3] >= 0).all()


def test_library_lives_outside_native():
    lib = thnsw.library_path()
    assert lib.parent == thnsw.BUILD_DIR
    assert ROOT / "native" not in lib.parents
    assert lib.name.startswith("libhnsw-") and lib.suffix == ".so"
    assert thnsw.BUILD_DIR == (ROOT / "multihop_dense_retrieval_tpu_torch"
                               / "index" / "_build")
    assert "multihop_dense_retrieval_tpu_torch/index/_build/" in \
        (ROOT / ".gitignore").read_text().splitlines()
    has_omp, threads = thnsw.openmp_info()
    assert isinstance(has_omp, bool) and threads >= 1


def test_load_checks_the_file_dim(data, tmp_path):
    vecs, _ = data
    idx = HNSWIndex(D, M=4, ef_construction=16)
    idx.add(vecs[:50])
    path = str(tmp_path / "g.hnsw")
    idx.save(path)
    assert HNSWIndex.load(path, dim=D).dim == D
    with pytest.raises(ValueError, match="dim"):
        HNSWIndex.load(path, dim=D + 1)
    with pytest.raises(ValueError):
        idx.search(np.zeros((2, D + 1), np.float32), 3)


def test_concurrent_add_and_search_are_serialized():
    """add() reallocates the native buffers a concurrent search() reads;
    the shared/exclusive lock keeps overlapping threads safe."""
    rng = np.random.RandomState(3)
    d = 32
    idx = HNSWIndex(d, M=8, ef_construction=40, seed=0)
    idx.add(rng.randn(500, d).astype(np.float32))
    stop = threading.Event()
    errs = []

    def adder():
        try:
            for _ in range(20):
                idx.add(rng.randn(200, d).astype(np.float32))
        except Exception as e:  # surfaced in the main thread below
            errs.append(e)
        finally:
            stop.set()

    q = rng.randn(8, d).astype(np.float32)
    t = threading.Thread(target=adder)
    t.start()
    while not stop.is_set():
        _, ids = idx.search(q, 5, ef_search=64)
        assert ids.shape == (8, 5)
        assert np.all(ids >= 0) and np.all(ids < 500 + 200 * 20)
    t.join(timeout=120)
    assert not t.is_alive()
    assert not errs, errs
    assert len(idx) == 500 + 20 * 200
