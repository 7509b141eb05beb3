"""The sharded serving engine: the port's ``BeamSearcher(mesh=)`` and the
sharded ``DenseIndex`` against the JAX package's, on the CPU (the cases
of tests/test_search.py, tests/test_config_matrix.py and
tests/test_index_updates.py that shard the index).

The JAX engines run on the 8 virtual CPU devices of tests/conftest.py,
the port's on a mesh of the CPU device repeated.  The port's engine calls
the JAX encoder, so both engines' searches see the same query vectors:
hop ids and certificates must be equal, and path scores within 1e-6 (fp32
sums of the same products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core import mesh as jmesh
from multihop_dense_retrieval_tpu.core.config import (
    EncoderConfig as JaxEncoderConfig, SearchConfig as JaxSearchConfig)
from multihop_dense_retrieval_tpu.data import Corpus, TokenizedCorpus
from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxHashTokenizer
from multihop_dense_retrieval_tpu.index import DenseIndex as JaxIndex
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxRetriever
from multihop_dense_retrieval_tpu.search import BeamSearcher as JaxSearcher
from multihop_dense_retrieval_tpu_torch.core import mesh as tmesh
from multihop_dense_retrieval_tpu_torch.core.config import SearchConfig
from multihop_dense_retrieval_tpu_torch.index import DenseIndex
from multihop_dense_retrieval_tpu_torch.ops import mips as tm
from multihop_dense_retrieval_tpu_torch.search import BeamSearcher
from tests import synth

CPU = torch.device("cpu")
_JDT = {"float32": jnp.float32, "int8": jnp.int8}


def _world(n_docs, seed, max_pos=96, center=False, max_text_len=48):
    tok = JaxHashTokenizer(vocab_size=512)
    rng = np.random.RandomState(seed)
    docs = synth.make_corpus(rng, n_docs, empty_every=19)
    corpus = Corpus(docs)
    tc = TokenizedCorpus.build(corpus, tok, max_text_len=max_text_len)
    model = JaxRetriever(JaxEncoderConfig.tiny(
        vocab_size=512, max_position_embeddings=max_pos))
    params = model.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32), method=model.encode_seq)

    def jenc(p, ids, mask, tt=None):
        return model.apply(p, ids, mask, tt, method=model.encode_seq)

    embs = []
    for s in range(0, n_docs, 500):
        enc = tok.encode_batch_pair(
            [(corpus[i]["title"], corpus.encode_text(i))
             for i in range(s, min(s + 500, n_docs))], 64)
        embs.append(np.asarray(jenc(params, jnp.asarray(enc["input_ids"]),
                                    jnp.asarray(enc["attention_mask"])),
                               np.float32))
    emb = np.concatenate(embs)
    if center:
        emb = emb - emb.mean(axis=0, keepdims=True)
    qs = [f"question about {corpus[i * 3]['title']}" for i in range(8)]
    q_inputs = tok.encode_batch_one(qs, 20)
    raw = [tok.raw_ids_padded(q, 18) for q in qs]
    return dict(tok=tok, corpus=corpus, tc=tc, params=params, jenc=jenc,
                emb=emb, q_inputs=q_inputs,
                q_raw=(np.stack([r[0] for r in raw]),
                       np.array([r[1] for r in raw])))


def _stores(w, n_pad):
    tc, n = w["tc"], len(w["corpus"])
    text_ids = np.full((n_pad, tc.text_ids.shape[1]), w["tok"].spec.pad_id,
                       np.int32)
    text_ids[:n] = tc.text_ids
    text_lens = np.zeros(n_pad, np.int32)
    text_lens[:n] = tc.text_lens
    empty = np.zeros(n_pad, bool)
    empty[:n] = tc.empty
    return text_ids, text_lens, empty


def _shared_encoder(w):
    """The JAX encoder behind the port's encode_fn signature."""
    def encode_fn(ids, mask, tt=None):
        out = w["jenc"](w["params"], jnp.asarray(ids.numpy()),
                        jnp.asarray(mask.numpy()),
                        None if tt is None else jnp.asarray(tt.numpy()))
        return torch.from_numpy(np.array(out, np.float32))
    return encode_fn


def _engines(w, shards, dtype="float32", pca=None, **kw):
    """(JAX engine, port engine) over the same rows, sharded over
    ``shards`` (1: unsharded), with SearchConfig ``kw``; the index's layout
    chunk is the config's chunk_rows."""
    emb, chunk_rows = w["emb"], kw["chunk_rows"]
    pca = dict(pca_dims=pca, pca_cand_rows=128) if pca else {}
    jm_ = jmesh.make_mesh(index=shards) if shards > 1 else None
    tm_ = (tmesh.make_mesh(index=shards, devices=[CPU] * shards)
           if shards > 1 else None)
    jindex = JaxIndex.build(emb, chunk_rows=chunk_rows, n_shards=shards,
                            dtype=_JDT[dtype], mesh=jm_, **pca)
    tindex = DenseIndex.build(emb, chunk_rows=chunk_rows, n_shards=shards,
                              dtype=dtype, mesh=tm_, device="cpu", **pca)
    stores = _stores(w, jindex.vectors.shape[0])
    jsearch = JaxSearcher(
        encode_fn=w["jenc"], params=w["params"], index=jindex,
        text_ids=jnp.asarray(stores[0]), text_lens=jnp.asarray(stores[1]),
        empty=jnp.asarray(stores[2]), spec=w["tok"].spec,
        config=JaxSearchConfig(**kw, use_pallas=False), mesh=jm_)
    tsearch = BeamSearcher(
        encode_fn=_shared_encoder(w), index=tindex, text_ids=stores[0],
        text_lens=stores[1], empty=stores[2], spec=w["tok"].spec,
        config=SearchConfig(**kw), mesh=tm_, device="cpu")
    return jsearch, tsearch


def _search(engine, w):
    return engine.search(dict(w["q_inputs"]), *w["q_raw"])


def _same(got, exp, keys=("hop1_ids", "hop2_ids", "hop1_cand_ids",
                          "pca_cert1", "pca_cert2")):
    assert set(got) == set(exp)
    for key in keys:
        if key in exp:
            np.testing.assert_array_equal(got[key], np.asarray(exp[key]),
                                          err_msg=key)
    for key in ("path_scores", "hop1_cand_scores"):
        np.testing.assert_allclose(got[key], np.asarray(exp[key]), rtol=1e-6,
                                   atol=1e-6, err_msg=key)


BASE = dict(beam_size_1=4, beam_size_2=4, topk=4, max_q_len=20,
            max_q_sp_len=80)


@pytest.fixture(scope="module")
def small():
    """tests/test_search.py::test_bucketed_search_on_sharded_index: 40
    docs in 8-row chunks over 8 shards."""
    return _world(40, 21)


@pytest.fixture(scope="module")
def large():
    """tests/test_config_matrix.py's world: 2,000 centred docs."""
    return _world(2000, 77, center=True)


def test_bucketed_search_on_sharded_index(small):
    """Hop-2 buckets on an index sharded 8 ways (8 rows a shard): equal to
    the JAX sharded engine, and to the port's unsharded engine."""
    kw = dict(BASE, chunk_rows=8, hop2_buckets=(32, 48, 64, 80))
    jsearch, tsearch = _engines(small, 8, **kw)
    got = _search(tsearch, small)
    _same(got, _search(jsearch, small))
    assert isinstance(tsearch.index.vectors, tmesh.Sharded)
    _, plain = _engines(small, 1, **dict(BASE, chunk_rows=8))
    _same(_search(plain, small), got)


@pytest.mark.parametrize("dtype,buckets,pca,shards", [
    ("float32", False, False, 2),
    ("float32", True, False, 2),
    ("float32", False, True, 2),
    ("int8", True, False, 2),
    ("int8", False, True, 4),
])
def test_config_matrix_shards_match_jax(large, dtype, buckets, pca, shards):
    """tests/test_config_matrix.py's sharded configurations, each against
    the JAX engine of the same configuration (pca: both hops prefiltered,
    14 of 8 chunks a shard asked, 7 rescanned)."""
    kw = dict(BASE, chunk_rows=128,
              hop2_buckets=(32, 48, 64, 80) if buckets else (),
              use_pca=pca, pca_k_chunks=14, pca_hops="12" if pca else "auto")
    jsearch, tsearch = _engines(large, shards, dtype=dtype,
                                pca=large["emb"].shape[1] if pca else None,
                                **kw)
    got = _search(tsearch, large)
    _same(got, _search(jsearch, large))
    if pca:
        assert got["pca_cert1"].any() or got["pca_cert2"].any()


@pytest.mark.parametrize("hops", ["auto", "12", "1"])
def test_sharded_pca_engine_search(large, hops):
    """tests/test_search.py::test_sharded_pca_engine_search: 2 shards of 8
    candidate chunks; the hops the prefilter serves carry their
    certificate masks, equal to JAX's."""
    kw = dict(BASE, max_q_sp_len=88, chunk_rows=128, use_pca=True,
              pca_k_chunks=4, hop2_buckets=(32, 48, 64, 88), pca_hops=hops)
    jsearch, tsearch = _engines(large, 2, pca=32, **kw)
    got = _search(tsearch, large)
    _same(got, _search(jsearch, large))
    assert ("pca_cert1" in got) == (hops != "auto")
    assert ("pca_cert2" in got) == (hops != "1")


def test_sharded_pca_small_corpus_falls_back_to_plain():
    """tests/test_search.py::test_sharded_pca_small_corpus_falls_back_to_
    plain: 256 padded rows over 2 shards are one candidate chunk a shard,
    so both hops take the plain sharded scan (no certificates), with the
    chains of the unsharded exact engine."""
    w = _world(200, 7)
    kw = dict(BASE, chunk_rows=128, use_pca=True, pca_k_chunks=2)
    jsearch, tsearch = _engines(w, 2, pca=w["emb"].shape[1], **kw)
    got = _search(tsearch, w)
    _same(got, _search(jsearch, w))
    assert "pca_cert2" not in got
    _, plain = _engines(w, 1, **dict(kw, use_pca=False))
    _same(_search(plain, w), got)


def _new_docs(w, rows):
    corpus = Corpus(rows)
    tc = TokenizedCorpus.build(corpus, w["tok"], max_text_len=40)
    enc = w["tok"].encode_batch_pair(
        [(corpus[i]["title"], corpus.encode_text(i))
         for i in range(len(corpus))], 48)
    emb = np.asarray(w["jenc"](w["params"], jnp.asarray(enc["input_ids"]),
                               jnp.asarray(enc["attention_mask"])),
                     np.float32)
    return emb, tc


@pytest.mark.parametrize("dtype,pca,shards,chunk,n_new", [
    ("float32", None, 8, 8, 40), ("int8", 16, 2, 256, 500)])
def test_live_updates_on_sharded_index(dtype, pca, shards, chunk, n_new):
    """tests/test_index_updates.py::test_live_updates_on_sharded_index:
    add_docs past the padding (the index grows by its chunk x its shard
    count and is sharded again) then delete_doc(0) on the sharded engines:
    the port's equals the JAX one.  fp32 over 8 shards of 8-row chunks
    (30 docs + 40, growing 64 rows to 128) also equals the port's unsharded
    engine over the updated corpus; int8 with a PCA prefilter runs 2 shards of two 128-row
    candidate chunks (30 docs + 500, growing 512 rows to 1024)."""
    w = _world(30, 9, max_pos=80, max_text_len=40)
    kw = dict(beam_size_1=3, beam_size_2=3, topk=3, max_q_len=20,
              max_q_sp_len=72, chunk_rows=chunk, use_pca=pca is not None,
              pca_k_chunks=1)
    new_rows = synth.make_corpus(np.random.RandomState(3), n_new)
    jsearch, tsearch = _engines(w, shards, dtype=dtype, pca=pca, **kw)
    n_pad = tsearch.index.vectors.shape[0]
    nemb, ntc = _new_docs(w, new_rows)
    for eng in (jsearch, tsearch):
        ids = eng.add_docs(nemb, ntc.text_ids, ntc.text_lens, ntc.empty)
        assert ids == list(range(30, 30 + n_new))
    assert tsearch.index.vectors.shape == jsearch.index.vectors.shape
    assert tsearch.index.vectors.shape[0] > n_pad
    assert tsearch.index.vectors.shape[0] % (chunk * shards) == 0
    assert isinstance(tsearch.index.vectors, tmesh.Sharded)
    _same(_search(tsearch, w), _search(jsearch, w))
    last = 30 + n_new - 1
    assert tsearch.delete_doc(0) == jsearch.delete_doc(0) == last
    got = _search(tsearch, w)
    _same(got, _search(jsearch, w))
    assert got["hop1_ids"].max() < last and got["hop2_ids"].max() < last
    if pca:
        return
    rows = np.concatenate([w["emb"], nemb])
    rows[0] = rows[last]
    index = DenseIndex.build(rows[:last], chunk_rows=chunk, dtype=dtype,
                             device="cpu")
    stores = _stores_updated(w, ntc, last, index.vectors.shape[0])
    plain = BeamSearcher(
        encode_fn=_shared_encoder(w), index=index, text_ids=stores[0],
        text_lens=stores[1], empty=stores[2], spec=w["tok"].spec,
        config=SearchConfig(**kw), device="cpu")
    exp = _search(plain, w)
    for key in ("hop1_ids", "hop2_ids"):
        np.testing.assert_array_equal(got[key], exp[key], err_msg=key)


def _stores_updated(w, ntc, last, n_pad):
    """The token stores of the corpus after the appends and the swap."""
    tc = w["tc"]
    pad = w["tok"].spec.pad_id
    new_ids = np.full((len(ntc.text_lens), tc.text_ids.shape[1]), pad,
                      np.int32)
    new_ids[:, :ntc.text_ids.shape[1]] = ntc.text_ids
    out = []
    for a, fill in ((np.concatenate([tc.text_ids, new_ids]), pad),
                    (np.concatenate([tc.text_lens, ntc.text_lens]), 0),
                    (np.concatenate([tc.empty, ntc.empty]), False)):
        a[0] = a[last]
        b = np.full((n_pad,) + a.shape[1:], fill, a.dtype)
        b[:last] = a[:last]
        out.append(b)
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_sharded_index_arrays_save_load_and_grow(tmp_path, dtype):
    """build(n_shards=, mesh=) pads to chunk_rows x n_shards and places
    each row block on its shard; save writes the global arrays (the JAX
    package reads them, and they equal the unsharded index's file);
    load(mesh=) equals load().shard(mesh); an append that overflows the
    padding grows by chunk_rows x n_shards, as JAX's append(n_shards=)."""
    rng = np.random.RandomState(4)
    emb = rng.randn(300, 32).astype(np.float32)
    mesh = tmesh.make_mesh(index=4, devices=[CPU] * 4)
    sharded = DenseIndex.build(emb, chunk_rows=64, n_shards=4, dtype=dtype,
                               mesh=mesh, pca_dims=8, pca_cand_rows=64)
    assert sharded.vectors.shape[0] == 512 and sharded.mesh == mesh
    assert [b.shape[0] for b in sharded.vectors.blocks] == [128] * 4
    assert [b.shape[1] for b in sharded.pca_bounds.blocks] == [2] * 4
    path = str(tmp_path / "sharded.npz")
    sharded.save(path)
    plain = DenseIndex.build(emb, chunk_rows=64, n_shards=4, dtype=dtype,
                             device="cpu", pca_dims=8, pca_cand_rows=64)
    plain.save(str(tmp_path / "plain.npz"))
    a, b = np.load(path), np.load(str(tmp_path / "plain.npz"))
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    jidx = JaxIndex.load(path)
    assert jidx.n_docs == 300 and jidx.vectors.shape == (512, 32)

    loaded = DenseIndex.load(path, mesh=mesh)
    again = DenseIndex.load(path, device="cpu").shard(mesh)
    for name in ("vectors", "scales", "pca_proj", "pca_bounds"):
        x, y = getattr(loaded, name), getattr(again, name)
        if x is None:
            continue
        assert torch.equal(x.gather(), y.gather()), name
    assert torch.equal(loaded.pca_rot, again.pca_rot)

    new = rng.randn(250, 32).astype(np.float32)
    grown = loaded.append(new, chunk_rows=64)
    jm_ = jmesh.make_mesh(index=4)
    jgrown = JaxIndex.load(path, mesh=jm_).append(new, chunk_rows=64,
                                                  n_shards=4)
    assert grown.n_docs == jgrown.n_docs == 550
    assert grown.vectors.shape[0] == jgrown.vectors.shape[0] == 768
    assert isinstance(grown.vectors, tmesh.Sharded) and grown.mesh == mesh
    got = grown.unshard("cpu")
    exp = jgrown.vectors
    if dtype == "bfloat16":
        np.testing.assert_array_equal(
            got.vectors.view(torch.int16).numpy(),
            np.asarray(exp.view(jnp.int16)))
    else:
        np.testing.assert_array_equal(got.vectors.numpy(), np.asarray(exp))
    # the unsharded index takes the same update to the same arrays
    ref = DenseIndex.load(path, device="cpu").append(new, chunk_rows=64,
                                                     n_shards=4)
    for name in ("vectors", "scales", "pca_proj", "pca_bounds", "pca_rot"):
        x, y = getattr(got, name), getattr(ref, name)
        assert (x is None and y is None) or torch.equal(x, y), name


def test_sharded_index_on_distinct_devices_grows_shard_by_shard():
    """A mesh over two distinct devices (``cpu`` and ``cpu:0``): shard
    copies the block that stays on the index's device, and an append that
    overflows the padding rebuilds each block on its own device, so no
    block keeps the whole index alive.  The grown arrays equal the
    unsharded index's after the same append."""
    rng = np.random.RandomState(6)
    emb = rng.randn(200, 32).astype(np.float32)
    mesh = tmesh.make_mesh(index=2, devices=[CPU, torch.device("cpu", 0)])
    kw = dict(chunk_rows=64, n_shards=2, dtype="int8", pca_dims=8,
              pca_cand_rows=64)
    plain = DenseIndex.build(emb, device="cpu", **kw)
    sharded = plain.shard(mesh)
    new = rng.randn(100, 32).astype(np.float32)
    grown = sharded.append(new)
    ref = DenseIndex.build(emb, device="cpu", **kw).append(new, n_shards=2)
    assert grown.vectors.shape[0] == ref.vectors.shape[0] == 384
    for idx in (sharded, grown):
        for name in ("vectors", "scales", "pca_proj", "pca_bounds"):
            for b in getattr(idx, name).blocks:
                assert b.untyped_storage().nbytes() == \
                    b.numel() * b.element_size(), name
    got = grown.unshard("cpu")
    for name in ("vectors", "scales", "pca_proj", "pca_bounds", "pca_rot"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_sharded_replace_and_delete_swap_write_the_shards():
    """replace and delete_swap across shard boundaries write the blocks in
    place: the gathered arrays equal the unsharded index's after the same
    updates (bounds too)."""
    rng = np.random.RandomState(8)
    emb = rng.randn(500, 32).astype(np.float32)
    mesh = tmesh.make_mesh(index=4, devices=[CPU] * 4)
    kw = dict(chunk_rows=64, n_shards=4, dtype="int8", pca_dims=8,
              pca_cand_rows=64)
    sharded = DenseIndex.build(emb, mesh=mesh, **kw)
    plain = DenseIndex.build(emb, device="cpu", **kw)
    for idx in (sharded, plain):
        idx.replace(3, emb[7:8])
    for doc in (3, 130, 0):
        sharded, ms = sharded.delete_swap(doc)
        plain, mp = plain.delete_swap(doc)
        assert ms == mp
    got = sharded.unshard("cpu")
    for name in ("vectors", "scales", "pca_proj", "pca_bounds"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    assert sharded.n_docs == plain.n_docs == 497


def test_engine_mesh_shards_an_unsharded_index(small):
    """BeamSearcher(mesh=) shards an index built without the mesh (the
    caller need not shard it first) and serves the same chains."""
    kw = dict(BASE, chunk_rows=8)
    _, plain = _engines(small, 1, **kw)
    mesh = tmesh.make_mesh(index=4, devices=[CPU] * 4)
    index = DenseIndex.build(small["emb"], chunk_rows=8, n_shards=4,
                             dtype="float32", device="cpu")
    stores = _stores(small, index.vectors.shape[0])
    eng = BeamSearcher(encode_fn=_shared_encoder(small), index=index,
                       text_ids=stores[0], text_lens=stores[1],
                       empty=stores[2], spec=small["tok"].spec,
                       config=SearchConfig(**kw), mesh=mesh, device="cpu")
    assert eng.index.mesh == mesh
    _same(_search(eng, small), _search(plain, small))


def test_sharded_search_counts_launch_per_shard(small, monkeypatch):
    """Every MIPS call of a sharded engine runs the single-device search
    once per shard (on the card: each shard's kernels)."""
    calls = []
    topk = tm.mips_topk
    monkeypatch.setattr(tm, "mips_topk", lambda *a, **kw: (
        calls.append(a[0].shape[0]), topk(*a, **kw))[1])
    kw = dict(BASE, chunk_rows=8)
    _, tsearch = _engines(small, 4, **kw)
    _search(tsearch, small)
    assert calls == [tsearch.index.vectors.shape[0] // 4] * 8
