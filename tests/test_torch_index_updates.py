"""Online index updates: the port's DenseIndex.append / replace /
delete_swap and BeamSearcher.add_docs / delete_doc against the JAX
package's, on the cases of tests/test_index_updates.py (the sharded case
is tests/test_torch_sharded_engine.py::test_live_updates_on_sharded_index).

Tolerances:
  * stored rows (fp32, bf16, int8 values and scales), n_docs, shapes and
    token stores: bit-equal;
  * what an update projects: the fp32 product x·rot and the row sums run
    in another order in the two frameworks (XLA's CPU dot against
    PyTorch's), a few fp32 ulps apart.  So the bf16 projection of an
    updated row may sit one bf16 ulp off where the product lies by a
    rounding boundary (any other projection row is bit-equal); in the
    bounds of chunks an update touched, the pnorm, delta and xnorm rows
    agree to rtol 1e-5, and the residual row, sqrt(|x|² - |p|²) with
    |p| ≈ |x| at R = D, is held by its square: within 1e-5 · xnorm² (fp32
    cancellation over D terms).  Untouched chunks are bit-equal, and
    every bound is checked sound against the float64 truth of the rows it
    covers;
  * engines: hop ids and certificates equal, path scores atol 1e-4 (fp32
    encodes and sums in another order, as in tests/test_torch_beam.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core.config import (
    EncoderConfig as JaxEncoderConfig, SearchConfig as JaxSearchConfig)
from multihop_dense_retrieval_tpu.data import Corpus, TokenizedCorpus
from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxHashTokenizer
from multihop_dense_retrieval_tpu.index.store import DenseIndex as JaxIndex
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxRetriever
from multihop_dense_retrieval_tpu.search import BeamSearcher as JaxSearcher
from multihop_dense_retrieval_tpu_torch.core.config import (EncoderConfig,
                                                            SearchConfig)
from multihop_dense_retrieval_tpu_torch.data import HashTokenizer
from multihop_dense_retrieval_tpu_torch.index import DenseIndex
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, retriever_state_dict_from_jax)
from multihop_dense_retrieval_tpu_torch.ops import mips as tm
from multihop_dense_retrieval_tpu_torch.search import BeamSearcher
from tests import synth

D = 16
_JDT = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}


def _vecs(rng, n, d=D):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _host(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _jhost(a):
    return np.asarray(a.view(jnp.int16) if a.dtype == jnp.bfloat16 else a)


def _same_index(t, j, touched=(), projected=()):
    """Rows and scales bit-equal; projections and bounds as the module
    docstring says (``touched``: chunk ids an update wrote, ``projected``:
    the rows it projected)."""
    assert (t.n_docs, t.multi_vector, t.chunk_rows) == \
        (j.n_docs, j.multi_vector, j.chunk_rows)
    assert tuple(t.vectors.shape) == tuple(j.vectors.shape)
    np.testing.assert_array_equal(_host(t.vectors), _jhost(j.vectors))
    if j.scales is not None:
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    if j.pca_proj is None:
        assert t.pca_proj is None
        return
    tp, jp = _host(t.pca_proj).astype(np.int32), _jhost(j.pca_proj)
    keep = np.setdiff1d(np.arange(jp.shape[0]), list(projected))
    np.testing.assert_array_equal(tp[keep], jp[keep])
    assert np.abs(tp - jp).max() <= 1          # one bf16 ulp (same sign)
    tb, jb = t.pca_bounds.numpy(), np.asarray(j.pca_bounds)
    assert tb.shape == jb.shape
    rest = np.setdiff1d(np.arange(jb.shape[1]), list(touched))
    np.testing.assert_array_equal(tb[:, rest], jb[:, rest])
    np.testing.assert_allclose(tb[1:], jb[1:], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_less(np.abs(tb[0] ** 2 - jb[0] ** 2),
                                 1e-5 * jb[3] ** 2 + 1e-12)


def _assert_sound(t):
    """Every chunk's bounds cover the float64 truth of its stored rows."""
    x = t.vectors.double()
    if t.scales is not None:
        x = x * t.scales.double()[:, None]
    x = x[:t.n_docs].numpy()
    p = x @ t.pca_rot.double().numpy()
    ps = t.pca_proj.double().numpy()[:t.n_docs]
    truth = np.stack([
        np.sqrt(np.maximum((x * x).sum(1) - (p * p).sum(1), 0)),
        np.linalg.norm(p - ps, axis=1), np.linalg.norm(ps, axis=1),
        np.linalg.norm(x, axis=1)])
    cols = np.arange(t.n_docs) // t.pca_cand_rows
    bounds = t.pca_bounds.double().numpy()
    assert (truth <= bounds[:, cols] + 1e-7).all()


def _top1(idx, queries):
    _, ids = tm.mips_topk(idx.vectors, torch.from_numpy(queries), 1,
                          n_valid=idx.n_docs, doc_scales=idx.scales)
    return ids[:, 0].numpy()


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_append_within_padding_and_growth(dtype):
    rng = np.random.RandomState(0)
    base = _vecs(rng, 20)
    j = JaxIndex.build(base, chunk_rows=16, dtype=_JDT[dtype])
    t = DenseIndex.build(base, chunk_rows=16, dtype=dtype, device="cpu")
    assert t.vectors.shape[0] == 32

    extra = _vecs(rng, 8)
    j, t = j.append(extra, chunk_rows=16), t.append(extra, chunk_rows=16)
    assert t.n_docs == 28 and t.vectors.shape[0] == 32   # in the padding
    _same_index(t, j)
    np.testing.assert_array_equal(_top1(t, extra), np.arange(20, 28))
    np.testing.assert_array_equal(_top1(t, base[:5]), np.arange(5))

    more = _vecs(rng, 10)                                # 38 > 32: grows
    j, t = j.append(more, chunk_rows=16), t.append(more, chunk_rows=16)
    assert t.n_docs == 38 and t.vectors.shape[0] == 48
    _same_index(t, j)
    np.testing.assert_array_equal(_top1(t, more), np.arange(28, 38))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_replace_and_delete_swap(dtype):
    rng = np.random.RandomState(1)
    base = _vecs(rng, 12)
    j = JaxIndex.build(base, chunk_rows=16, dtype=_JDT[dtype])
    t = DenseIndex.build(base, chunk_rows=16, dtype=dtype, device="cpu")

    new3 = _vecs(rng, 1)
    j, t = j.replace(3, new3), t.replace(3, new3)
    _same_index(t, j)
    assert _top1(t, new3)[0] == 3

    (j, jm), (t, moved) = j.delete_swap(2), t.delete_swap(2)
    assert moved == jm == 11 and t.n_docs == 11
    _same_index(t, j)
    assert _top1(t, base[11:12])[0] == 2

    (j, jm), (t, moved) = j.delete_swap(10), t.delete_swap(10)
    assert moved is None and jm is None and t.n_docs == 10
    _same_index(t, j)
    with pytest.raises(IndexError):
        t.delete_swap(10)
    with pytest.raises(IndexError):
        t.replace(10, new3)


def test_multivector_group_updates():
    rng = np.random.RandomState(2)
    base = _vecs(rng, 8)                       # 4 docs x 2 vectors
    j = JaxIndex.build(base, chunk_rows=16, multi_vector=2)
    t = DenseIndex.build(base, chunk_rows=16, multi_vector=2, device="cpu")
    assert t.vectors.dtype == torch.bfloat16 and t.n_passages == 4

    extra = _vecs(rng, 2)                      # one new doc (2 rows)
    j, t = j.append(extra, chunk_rows=16), t.append(extra, chunk_rows=16)
    assert t.n_passages == 5
    _same_index(t, j)
    np.testing.assert_array_equal(_top1(t, extra), [8, 9])

    (j, jm), (t, moved) = j.delete_swap(0), t.delete_swap(0)
    assert moved == jm == 4 and t.n_passages == 4
    _same_index(t, j)
    np.testing.assert_array_equal(_top1(t, extra), [0, 1])
    with pytest.raises(ValueError):
        t.append(_vecs(rng, 3), chunk_rows=16)   # not whole documents


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("pca_dims", [16, 32])
def test_pca_prefilter_updates(dtype, pca_dims):
    """append (padding, then growth), replace and delete_swap on an index
    with the PCA prefilter: projections bit-equal, bounds as the module
    docstring says, and sound; the growth adds zero chunks."""
    rng = np.random.RandomState(3)
    base = rng.randn(200, 32).astype(np.float32)
    kw = dict(chunk_rows=64, pca_dims=pca_dims, pca_cand_rows=32)
    j = JaxIndex.build(base, dtype=_JDT[dtype], **kw)
    t = DenseIndex.build(base, dtype=dtype, device="cpu", **kw)
    touched, projected = set(), set()

    def step(fn_j, fn_t, rows):
        nonlocal j, t
        j, t = fn_j(j), fn_t(t)
        projected.update(rows)
        touched.update(r // 32 for r in rows)
        _same_index(t, j, sorted(touched), sorted(projected))
        _assert_sound(t)

    extra = rng.randn(5, 32).astype(np.float32)
    step(lambda i: i.append(extra), lambda i: i.append(extra),
         range(200, 205))
    more = rng.randn(70, 32).astype(np.float32)
    step(lambda i: i.append(more), lambda i: i.append(more),
         range(205, 275))
    assert t.vectors.shape[0] == 320 and t.pca_bounds.shape[1] == 10
    assert not t.pca_bounds[:, 9].any()        # grown chunk still empty
    step(lambda i: i.replace(3, more[:1]), lambda i: i.replace(3, more[:1]),
         [3])
    step(lambda i: i.delete_swap(7)[0], lambda i: i.delete_swap(7)[0], [7])


def test_index_remembers_layout_chunk(tmp_path):
    rng = np.random.RandomState(0)
    idx = DenseIndex.build(_vecs(rng, 30), chunk_rows=16, dtype="float32",
                           device="cpu")
    assert idx.chunk_rows == 16 and idx.vectors.shape[0] == 32
    idx = idx.append(_vecs(rng, 5))           # no chunk_rows argument
    assert idx.n_docs == 35 and idx.vectors.shape[0] == 48
    path = str(tmp_path / "idx.npz")
    idx.save(path)
    back = DenseIndex.load(path, device="cpu")
    assert back.chunk_rows == 16 and back.n_docs == 35
    np.testing.assert_array_equal(back.vectors.numpy(), idx.vectors.numpy())


# ---- live engines ---------------------------------------------------------


@pytest.fixture(scope="module")
def retriever():
    cfg = JaxEncoderConfig.tiny(vocab_size=512, max_position_embeddings=80)
    jmodel = JaxRetriever(cfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32), method=jmodel.encode_seq)
    model = MhopRetriever(EncoderConfig.tiny(vocab_size=512,
                                             max_position_embeddings=80))
    model.load_state_dict(retriever_state_dict_from_jax(
        jax.device_get(params)))
    return jmodel, params, model.eval()


def _encode(jmodel, params, tok, corpus):
    enc = tok.encode_batch_pair(
        [(corpus[i]["title"], corpus.encode_text(i))
         for i in range(len(corpus))], 48)
    return np.asarray(jmodel.apply(params, jnp.asarray(enc["input_ids"]),
                                   jnp.asarray(enc["attention_mask"]),
                                   method=jmodel.encode_seq), np.float32)


def _stores(tc, n_pad, pad_id, dtype=np.int32):
    text_ids = np.full((n_pad, tc.text_ids.shape[1]), pad_id, np.int32)
    text_ids[:len(tc.text_lens)] = tc.text_ids
    text_lens = np.zeros(n_pad, np.int32)
    text_lens[:len(tc.text_lens)] = tc.text_lens
    empty = np.zeros(n_pad, bool)
    empty[:len(tc.text_lens)] = tc.empty
    return text_ids.astype(dtype), text_lens, empty


def _engines(retriever, tok, rows, scfg, dtype="float32", pca=None,
             chunk_rows=16, emb=None, store_dtype=np.int32):
    """(JAX engine, port engine) over the same corpus and vectors."""
    jmodel, params, model = retriever
    corpus = Corpus(rows)
    tc = TokenizedCorpus.build(corpus, tok, max_text_len=40)
    emb = _encode(jmodel, params, tok, corpus) if emb is None else emb
    kw = dict(chunk_rows=chunk_rows)
    if pca:
        kw.update(pca_dims=emb.shape[1], pca_cand_rows=pca)
    jidx = JaxIndex.build(emb, dtype=_JDT[dtype], **kw)
    tidx = DenseIndex.build(emb, dtype=dtype, device="cpu", **kw)
    n_pad = jidx.vectors.shape[0]
    jstore = _stores(tc, n_pad, tok.spec.pad_id)
    tstore = _stores(tc, n_pad, tok.spec.pad_id, store_dtype)
    jeng = JaxSearcher(
        encode_fn=lambda p, ids, mask, tt=None: jmodel.apply(
            p, ids, mask, tt, method=jmodel.encode_seq),
        params=params, index=jidx, text_ids=jnp.asarray(jstore[0]),
        text_lens=jnp.asarray(jstore[1]), empty=jnp.asarray(jstore[2]),
        spec=tok.spec, config=JaxSearchConfig(use_pallas=False, **scfg),
        mesh=None)
    teng = BeamSearcher(
        encode_fn=model.encode_seq, index=tidx, text_ids=tstore[0],
        text_lens=tstore[1], empty=tstore[2], spec=HashTokenizer(
            vocab_size=tok.spec.vocab_size).spec,
        config=SearchConfig(**scfg), device="cpu")
    return jeng, teng, emb


def _queries(tok, rng, n=4):
    qs = [synth.rand_text(rng, 3, 8) for _ in range(n)]
    raw = [tok.raw_ids_padded(q, 22) for q in qs]
    return (tok.encode_batch_one(qs, 24), np.stack([r[0] for r in raw]),
            np.array([r[1] for r in raw]))


def _same_results(got, exp, keys=("hop1_ids", "hop2_ids")):
    for key in keys:
        np.testing.assert_array_equal(got[key], np.asarray(exp[key]))
    np.testing.assert_allclose(got["path_scores"],
                               np.asarray(exp["path_scores"]),
                               rtol=0, atol=1e-4)


def _new_docs(jmodel, params, tok, new_rows):
    nc = Corpus(new_rows)
    return _encode(jmodel, params, tok, nc), \
        TokenizedCorpus.build(nc, tok, max_text_len=40)


SCFG = dict(beam_size_1=3, beam_size_2=3, topk=3, max_q_len=24,
            max_q_sp_len=72, chunk_rows=16)


def test_live_engine_add_and_delete_matches_jax_and_rebuild(retriever):
    """add_docs / delete_doc on live engines: the port's index and token
    store stay bit-equal to the JAX engine's, both search alike, and the
    port's live engine equals one rebuilt on the updated corpus."""
    tok = JaxHashTokenizer(vocab_size=512)
    rng = np.random.RandomState(5)
    rows = synth.make_corpus(rng, 30, empty_every=7)
    new_rows = synth.make_corpus(rng, 4)
    for i, r in enumerate(new_rows):
        r["title"] = f"fresh doc {i}"
    jeng, teng, _ = _engines(retriever, tok, rows, SCFG)
    nemb, ntc = _new_docs(retriever[0], retriever[1], tok, new_rows)
    args = (nemb, ntc.text_ids, ntc.text_lens, ntc.empty)
    assert teng.add_docs(*args) == jeng.add_docs(*args) == [30, 31, 32, 33]
    assert teng.index.vectors.shape[0] == 48       # grew past 32
    _same_index(teng.index, jeng.index)
    for name in ("text_ids", "text_lens", "empty"):
        np.testing.assert_array_equal(getattr(teng, name).numpy(),
                                      np.asarray(getattr(jeng, name)))

    q = _queries(tok, rng)
    got = teng.search(*q)
    _same_results(got, jeng.search(*q))
    _, rebuilt, _ = _engines(retriever, tok, rows + new_rows, SCFG)
    _same_results(got, rebuilt.search(*q))

    assert teng.delete_doc(1) == jeng.delete_doc(1) == 33
    _same_index(teng.index, jeng.index)
    for name in ("text_ids", "text_lens", "empty"):
        np.testing.assert_array_equal(getattr(teng, name).numpy(),
                                      np.asarray(getattr(jeng, name)))
    swapped = list(rows + new_rows)
    swapped[1] = swapped[33]
    _, rebuilt2, _ = _engines(retriever, tok, swapped[:33], SCFG)
    got = teng.search(*q)
    _same_results(got, jeng.search(*q))
    _same_results(got, rebuilt2.search(*q))


def test_live_pca_engine_add_docs(retriever):
    """add_docs on a use_pca engine (the index grows by a chunk): the
    prefilter moves with the index, certificates stay present and equal
    the JAX engine's, and certified hop-1 rows equal the brute force over
    the updated index."""
    jmodel, params, _ = retriever
    tok = JaxHashTokenizer(vocab_size=512)
    rng = np.random.RandomState(8)
    rows = synth.make_corpus(rng, 1000, empty_every=13)
    corpus = Corpus(rows)
    emb = np.concatenate([_encode(jmodel, params, tok,
                                  Corpus(rows[s:s + 250]))
                          for s in range(0, 1000, 250)])
    emb = emb - emb.mean(axis=0, keepdims=True)
    scfg = dict(SCFG, chunk_rows=128, use_pca=True, pca_k_chunks=7)
    jeng, teng, _ = _engines(retriever, tok, rows, scfg, pca=128,
                             chunk_rows=128, emb=emb)
    assert teng.index.vectors.shape[0] == 1024
    nemb, ntc = _new_docs(jmodel, params, tok, synth.make_corpus(rng, 30))
    args = (nemb, ntc.text_ids, ntc.text_lens, ntc.empty)
    assert teng.add_docs(*args) == jeng.add_docs(*args) == \
        list(range(1000, 1030))
    assert teng.index.vectors.shape[0] == 1152
    _same_index(teng.index, jeng.index, touched=[7, 8],
                projected=range(1000, 1030))
    _assert_sound(teng.index)

    qs = [f"question about {corpus[i * 7]['title']}" for i in range(8)]
    raw = [tok.raw_ids_padded(q, 22) for q in qs]
    q = (tok.encode_batch_one(qs, 24), np.stack([r[0] for r in raw]),
         np.array([r[1] for r in raw]))
    got = teng.search(*q)
    exp = jeng.search(*q)
    _same_results(got, exp)
    for key in ("pca_cert1", "pca_cert2", "hop1_cand_ids"):
        np.testing.assert_array_equal(got[key], np.asarray(exp[key]))
    q_vec = np.asarray(jmodel.apply(
        params, jnp.asarray(q[0]["input_ids"]),
        jnp.asarray(q[0]["attention_mask"]), method=jmodel.encode_seq))
    brute = np.argsort(-(q_vec @ np.concatenate([emb, nemb]).T), axis=1,
                       kind="stable")[:, :3]
    cert = got["pca_cert1"]
    assert cert.any()
    np.testing.assert_array_equal(got["hop1_cand_ids"][cert], brute[cert])


def test_sixteen_bit_store_takes_high_ids(retriever):
    """A 16-bit token store (uint16 on disk, int16 bit patterns on the
    device) keeps appended ids >= 32768 as their bit patterns; the engine
    then searches exactly like one over an int32 store."""
    tok = JaxHashTokenizer(vocab_size=50265)
    rng = np.random.RandomState(6)
    rows = synth.make_corpus(rng, 20)
    emb = np.random.RandomState(7).randn(20, 32).astype(np.float32)
    torch.manual_seed(0)
    wide_vocab = (None, None, MhopRetriever(EncoderConfig.tiny(
        vocab_size=50265, max_position_embeddings=80)).eval())
    wide = _engines(wide_vocab, tok, rows, SCFG, emb=emb)[1]
    narrow = _engines(wide_vocab, tok, rows, SCFG, emb=emb,
                      store_dtype=np.uint16)[1]
    assert narrow.text_ids.dtype == torch.int16
    new_rows = synth.make_corpus(rng, 15)
    ntc = TokenizedCorpus.build(Corpus(new_rows), tok, max_text_len=40)
    assert (ntc.text_ids >= 32768).any()
    nemb = np.random.RandomState(8).randn(15, 32).astype(np.float32)
    for eng in (wide, narrow):
        assert eng.add_docs(nemb, ntc.text_ids, ntc.text_lens,
                            ntc.empty) == list(range(20, 35))
        eng.delete_doc(4)
    np.testing.assert_array_equal(
        narrow.text_ids.numpy().view(np.uint16).astype(np.int32),
        wide.text_ids.numpy())
    q = _queries(tok, rng)
    a, b = wide.search(*q), narrow.search(*q)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_multi_vector_engine_refuses_updates(retriever):
    tok = JaxHashTokenizer(vocab_size=512)
    rows = synth.make_corpus(np.random.RandomState(9), 8)
    eng = _engines(retriever, tok, rows, SCFG)[1]
    emb = np.random.RandomState(1).randn(16, 32).astype(np.float32)
    eng.index = DenseIndex.build(emb, chunk_rows=16, multi_vector=2,
                                 dtype="float32", device="cpu")
    with pytest.raises(NotImplementedError, match="single-vector"):
        eng.add_docs(emb[:2], np.zeros((1, 4), np.int32), np.ones(1))
    with pytest.raises(NotImplementedError, match="single-vector"):
        eng.delete_doc(0)
