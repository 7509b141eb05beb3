"""Beam-4 serving parity: candidate pruning (``hop2_prune_margin``, fixed
and ``auto:Q``), the unified stop head and the two-pass stop-skip cascade
of the port's BeamSearcher against the JAX BeamSearcher (``use_pallas=
False``, as the JAX package's own tests run it), on the same weights and
the same index, on the CPU.

The cases mirror tests/test_search.py's test_unified_stop_head_serving,
test_stop_skip_cascade_semantics, test_stop_skip_composes_with_prune_margin
and test_hop2_prune_margin_semantics.  Weights carry across through
``retriever_state_dict_from_jax`` (MhopRetriever) and
``unified_state_dict_from_jax`` (UnifiedRetriever).  The cascade's
thresholds lie halfway between two adjacent top-1 stop probabilities of
the unstopped unified run, so no question sits on the threshold.

Tolerances:
  * hop1_ids, hop2_ids, hop1_cand_ids, pca_cert*, and where path_scores
    are NEG_INF (pruned or stopped chains): equal;
  * path_scores and hop1_cand_scores: atol 1e-4 (fp32 summation order in
    encoder and MIPS, as tests/test_torch_beam.py);
  * stop_probs and top_stop_probs: rtol 1e-5, atol 1e-6, and exactly 0.5
    on the same rows (a skipped tile's zero logits);
  * the bf16 case: both engines call the JAX package's bf16 encoder,
    jitted (the two frameworks' own bf16 encodes differ by ~1e-2, beyond
    the score gaps of a random model), so any difference is the engine's
    and the fp32 tolerances above hold.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.core.config import (
    EncoderConfig as JaxEncoderConfig, SearchConfig as JaxSearchConfig)
from multihop_dense_retrieval_tpu.data import Corpus, TokenizedCorpus
from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxHashTokenizer
from multihop_dense_retrieval_tpu.index import DenseIndex as JaxIndex
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxMhop
from multihop_dense_retrieval_tpu.models import UnifiedRetriever as JaxUnified
from multihop_dense_retrieval_tpu.search import BeamSearcher as JaxSearcher
from multihop_dense_retrieval_tpu_torch.core.config import (EncoderConfig,
                                                            SearchConfig)
from multihop_dense_retrieval_tpu_torch.data import HashTokenizer
from multihop_dense_retrieval_tpu_torch.index import DenseIndex
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, UnifiedRetriever, retriever_state_dict_from_jax,
    unified_state_dict_from_jax)
from multihop_dense_retrieval_tpu_torch.ops.mips import NEG_INF
from multihop_dense_retrieval_tpu_torch.search import BeamSearcher
from tests import synth

BUCKETS = dict(hop2_buckets=(32, 48, 64, 88),
               hop2_tile_fracs=(0.25, 0.375, 0.25, 0.125))
BASE = dict(beam_size_1=4, beam_size_2=3, topk=12, max_q_len=24,
            max_q_sp_len=88, chunk_rows=16, use_pallas=False)

# name: (model, index, search kwargs; "stop" is the target stop rate of
# the cascade, turned into a threshold from the unstopped unified run)
CASES = {
    "prune_fixed_buckets": ("mhop", "fp32", dict(BUCKETS,
                                                 hop2_prune_margin=0.3)),
    "prune_fixed_plain": ("mhop", "fp32", dict(hop2_prune_margin=0.3)),
    "prune_auto_buckets": ("mhop", "fp32", dict(BUCKETS,
                                                hop2_prune_margin=-0.5)),
    "prune_auto_q9_plain": ("mhop", "fp32", dict(hop2_prune_margin=-0.9)),
    "prune_auto_int8_pca": ("mhop", "int8_pca", dict(BUCKETS,
                                                     hop2_prune_margin=-0.5)),
    "unified_buckets": ("unified", "fp32", dict(BUCKETS)),
    "unified_plain": ("unified", "fp32", {}),
    "unified_prune_buckets": ("unified", "fp32",
                              dict(BUCKETS, hop2_prune_margin=-0.5)),
    "cascade_stop0_buckets": ("unified", "fp32", dict(BUCKETS, stop=0.0)),
    "cascade_stop30_buckets": ("unified", "fp32", dict(BUCKETS, stop=0.3)),
    "cascade_stop60_buckets": ("unified", "fp32", dict(BUCKETS, stop=0.6)),
    "cascade_stop30_plain": ("unified", "fp32", dict(stop=0.3)),
    "cascade_stop60_prune_fixed": ("unified", "fp32",
                                   dict(BUCKETS, stop=0.6,
                                        hop2_prune_margin=0.3)),
    "cascade_stop60_prune_auto_q9": ("unified", "fp32",
                                     dict(BUCKETS, stop=0.6,
                                          hop2_prune_margin=-0.9)),
    "cascade_stop60_int8_pca": ("unified", "int8_pca",
                                dict(BUCKETS, stop=0.6)),
    # 128 questions at width 200: pass 1 takes its own 3-tile split
    "cascade_stop30_pass1_tiled": ("unified", "fp32",
                                   dict(stop=0.3, n_q=128, beam_size_1=2,
                                        beam_size_2=2, topk=4,
                                        max_q_sp_len=200,
                                        hop2_buckets=(128, 160, 200),
                                        hop2_tile_fracs=(0.25, 0.5, 0.25))),
    "cascade_stop60_bf16": ("unified_bf16", "fp32", dict(BUCKETS, stop=0.6)),
}


@functools.lru_cache(maxsize=None)
def _model(kind):
    cfg = JaxEncoderConfig.tiny(
        vocab_size=512, max_position_embeddings=220,
        dtype="bfloat16" if kind.endswith("bf16") else "float32")
    ids8 = jnp.ones((1, 8), jnp.int32)
    if kind == "mhop":
        model = JaxMhop(cfg)
        params = model.init(jax.random.PRNGKey(0), ids8, ids8,
                            method=model.encode_seq)
    else:
        model = JaxUnified(cfg)
        params = model.init(jax.random.PRNGKey(0), ids8, ids8,
                            method=model.encode_qsp)
    # a wider stop head spreads the random model's stop probabilities
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 3.0 if "stop_head" in jax.tree_util.keystr(path)
        else x, params)
    return cfg, model, params


@functools.lru_cache(maxsize=None)
def _corpus(index_kind):
    tok = JaxHashTokenizer(vocab_size=512)
    n_docs = 1000 if index_kind == "int8_pca" else 48
    rng = np.random.RandomState(21)
    docs = synth.make_corpus(rng, n_docs, empty_every=11)
    for i, d in enumerate(docs):
        if i % 3 == 0 and d["text"]:
            d["text"] = d["text"].split()[0]     # varied lengths for buckets
    corpus = Corpus(docs)
    return tok, corpus, TokenizedCorpus.build(corpus, tok, max_text_len=60)


def _questions(tok, n_q, max_q_len):
    rng = np.random.RandomState(5)
    qs = ([f"short q{i}" for i in range(n_q // 2)]
          + [f"a longer question about {synth.rand_text(rng, 4, 12)}"
             for _ in range(n_q - n_q // 2)])
    q_inputs = tok.encode_batch_one(qs, max_q_len)
    raw = [tok.raw_ids_padded(q, max_q_len - 2) for q in qs]
    return q_inputs, np.stack([r[0] for r in raw]), np.array(
        [r[1] for r in raw])


def _jax_fns(model, params, unified):
    def enc(p, ids, mask, tt=None):
        return model.apply(p, ids, mask, tt, method=model.encode_seq)

    def qsp(p, ids, mask, tt=None):
        return model.apply(p, ids, mask, tt, method=model.encode_qsp)

    return enc, (qsp if unified else None)


@functools.lru_cache(maxsize=None)
def _fixture(model_kind, index_kind):
    cfg, model, params = _model(model_kind)
    tok, corpus, tc = _corpus(index_kind)
    n_docs = len(corpus)
    enc = tok.encode_batch_pair(
        [(corpus[i]["title"], corpus.encode_text(i)) for i in range(n_docs)],
        72)
    emb = np.concatenate([np.asarray(model.apply(
        params, jnp.asarray(enc["input_ids"][s:s + 250]),
        jnp.asarray(enc["attention_mask"][s:s + 250]),
        method=model.encode_seq), np.float32)
        for s in range(0, n_docs, 250)])
    if index_kind == "int8_pca":
        kw = dict(chunk_rows=128, dtype="int8", pca_dims=32,
                  pca_cand_rows=128)
        jindex = JaxIndex.build(emb, chunk_rows=128, dtype=jnp.int8,
                                pca_dims=32, pca_cand_rows=128)
    else:
        kw = dict(chunk_rows=16, dtype="float32")
        jindex = JaxIndex.build(emb, chunk_rows=16, dtype=jnp.float32)
    n_pad = jindex.vectors.shape[0]
    text_ids = np.full((n_pad, 60), tok.spec.pad_id, np.int32)
    text_ids[:n_docs] = tc.text_ids
    text_lens = np.zeros(n_pad, np.int32)
    text_lens[:n_docs] = tc.text_lens
    empty = np.zeros(n_pad, bool)
    empty[:n_docs] = tc.empty
    return dict(emb=emb, index_kw=kw, jindex=jindex,
                text=(text_ids, text_lens, empty), tok=tok)


def _search_cfg(case):
    model_kind, index_kind, kw = CASES[case]
    kw = dict(BASE, **kw)
    kw.pop("stop", None)
    kw.pop("n_q", None)
    if index_kind == "int8_pca":
        kw.update(chunk_rows=128, use_pca=True, pca_k_chunks=4)
    return kw


def _jax_search(case, stop_skip=0.0):
    model_kind, index_kind, kw = CASES[case]
    _, model, params = _model(model_kind)
    f = _fixture(model_kind, index_kind)
    enc, qsp = _jax_fns(model, params, model_kind != "mhop")
    scfg = JaxSearchConfig(**_search_cfg(case),
                           stop_skip_threshold=stop_skip)
    text_ids, text_lens, empty = f["text"]
    searcher = JaxSearcher(
        encode_fn=enc, encode_qsp_fn=qsp, params=params, index=f["jindex"],
        text_ids=jnp.asarray(text_ids), text_lens=jnp.asarray(text_lens),
        empty=jnp.asarray(empty), spec=f["tok"].spec, config=scfg, mesh=None)
    q = _questions(f["tok"], kw.get("n_q", 8), scfg.max_q_len)
    return searcher.search(dict(q[0]), q[1], q[2])


@functools.lru_cache(maxsize=None)
def _threshold(case):
    """A threshold halfway between two adjacent top-1 stop probabilities of
    the unstopped unified run (or between the largest and 1): within 10
    points of the target share of questions stops, at the widest gap."""
    stop = CASES[case][2]["stop"]
    base = _jax_search(case)
    slot = np.argmax(base["hop1_cand_scores"], axis=1)
    p = np.sort(base["stop_probs"][np.arange(len(slot)), slot])[::-1]
    if stop == 0:
        return float((p[0] + 1.0) / 2)
    n = len(p)
    lo = max(1, int(round((stop - 0.1) * n)))
    hi = min(n - 1, int(round((stop + 0.1) * n)))
    n_stop = max(range(lo, hi + 1), key=lambda m: p[m - 1] - p[m])
    assert p[n_stop - 1] - p[n_stop] > 1e-4, "stop probabilities tie"
    return float((p[n_stop - 1] + p[n_stop]) / 2)


@functools.lru_cache(maxsize=None)
def _expected(case):
    thr = _threshold(case) if "stop" in CASES[case][2] else 0.0
    return _jax_search(case, thr), thr


def _port_fns(case):
    model_kind, index_kind, _ = CASES[case]
    cfg, jmodel, params = _model(model_kind)
    if model_kind == "unified_bf16":
        # jitted, as inside the JAX engine: XLA's fused bf16 program rounds
        # differently from op-by-op dispatch
        enc, qsp = map(jax.jit, _jax_fns(jmodel, params, True))

        def np_in(x):
            return None if x is None else jnp.asarray(x.numpy())

        def encode_fn(ids, mask, tt=None):
            return torch.from_numpy(np.array(
                enc(params, np_in(ids), np_in(mask), np_in(tt)), np.float32))

        def encode_qsp_fn(ids, mask, tt=None):
            v, s = qsp(params, np_in(ids), np_in(mask), np_in(tt))
            return (torch.from_numpy(np.array(v, np.float32)),
                    torch.from_numpy(np.array(s, np.float32)))

        return encode_fn, encode_qsp_fn
    tcfg = EncoderConfig.tiny(vocab_size=512, max_position_embeddings=220)
    host = jax.device_get(params)
    if model_kind == "mhop":
        model = MhopRetriever(tcfg)
        model.load_state_dict(retriever_state_dict_from_jax(host))
        return model.encode_seq, None
    model = UnifiedRetriever(tcfg)
    model.load_state_dict(unified_state_dict_from_jax(host))
    return model.encode_seq, model.encode_qsp


def _port_search(case, thr):
    model_kind, index_kind, kw = CASES[case]
    f = _fixture(model_kind, index_kind)
    encode_fn, encode_qsp_fn = _port_fns(case)
    index = DenseIndex.build(f["emb"], device="cpu", **f["index_kw"])
    tok = HashTokenizer(vocab_size=512)
    searcher = BeamSearcher(
        encode_fn=encode_fn, encode_qsp_fn=encode_qsp_fn, index=index,
        text_ids=f["text"][0], text_lens=f["text"][1], empty=f["text"][2],
        spec=tok.spec, device="cpu",
        config=SearchConfig(**_search_cfg(case), stop_skip_threshold=thr))
    q = _questions(tok, kw.get("n_q", 8), searcher.config.max_q_len)
    return searcher.search(dict(q[0]), q[1], q[2])


def _compare(got, exp):
    assert set(got) == set(exp)
    for key in ("hop1_ids", "hop2_ids", "hop1_cand_ids", "pca_cert1",
                "pca_cert2"):
        if key in exp:
            np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
    dead = exp["path_scores"] <= NEG_INF / 2
    np.testing.assert_array_equal(got["path_scores"] <= NEG_INF / 2, dead)
    np.testing.assert_array_equal(got["path_scores"][dead],
                                  exp["path_scores"][dead])
    for key in ("path_scores", "hop1_cand_scores"):
        np.testing.assert_allclose(got[key][~dead] if key == "path_scores"
                                   else got[key],
                                   exp[key][~dead] if key == "path_scores"
                                   else exp[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    for key in ("stop_probs", "top_stop_probs"):
        if key in exp:
            np.testing.assert_allclose(got[key], exp[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
            np.testing.assert_array_equal(got[key] == 0.5, exp[key] == 0.5,
                                          err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam4_engine_matches_jax(case):
    exp, thr = _expected(case)
    got = _port_search(case, thr)
    _compare(got, exp)
    kw = CASES[case][2]
    bsz, beam1 = exp["hop1_cand_scores"].shape
    beam2 = _search_cfg(case)["beam_size_2"]
    dead = exp["path_scores"] <= NEG_INF / 2
    if kw.get("hop2_prune_margin"):
        # the margin bites somewhere (the test is not vacuous) but never
        # removes a question's top-1 candidate
        assert dead.any() and (~dead).sum(axis=1).min() >= beam2
    if "stop" in kw:
        slot = np.argmax(exp["hop1_cand_scores"], axis=1)
        p_top = got["stop_probs"][np.arange(bsz), slot]
        stopped = p_top >= thr
        rate = stopped.mean()
        assert abs(rate - kw["stop"]) <= 0.13, rate
        for q in np.flatnonzero(stopped):
            # a stopped question keeps exactly its top-1 candidate's chains
            alive = ~dead[q]
            assert alive.sum() == beam2
            assert set(got["hop1_ids"][q][alive]) == {
                exp["hop1_cand_ids"][q, slot[q]]}
        if stopped.any() and "hop2_buckets" in kw and beam1 > 2:
            # a stopped question's non-top rows fill a skipped tile
            assert (got["stop_probs"] == 0.5).any()


def test_stop_skip_without_stop_head_raises():
    f = _fixture("mhop", "fp32")
    index = DenseIndex.build(f["emb"], device="cpu", **f["index_kw"])
    with pytest.raises(ValueError, match="stop_skip_threshold"):
        BeamSearcher(encode_fn=None, index=index, text_ids=f["text"][0],
                     text_lens=f["text"][1], empty=f["text"][2],
                     spec=HashTokenizer(vocab_size=512).spec, device="cpu",
                     config=SearchConfig(**BASE, stop_skip_threshold=0.5))


@pytest.mark.parametrize("sort", ["tail", "front"])
@pytest.mark.parametrize("tiling", ["buckets", "uneven", "none"])
def test_encode_hop2_skips_tiles_as_jax(sort, tiling):
    """_encode_hop2 with an active mask, tuple outputs, tail- and
    front-sort: the tiles' widths follow their active rows, a tile with no
    active row is zeros, and vectors and stop logits un-permute to the
    JAX engine's rows (fp32: atol 1e-5, zeros exact)."""
    from multihop_dense_retrieval_tpu.search import beam as jbeam
    from multihop_dense_retrieval_tpu_torch.search import beam as tbeam

    _, jmodel, params = _model("unified")
    enc, qsp = _jax_fns(jmodel, params, True)
    tok = JaxHashTokenizer(vocab_size=512)
    rng = np.random.RandomState(3)
    n = 24
    a = [tok.raw_ids_padded(synth.rand_text(rng, 1, 12), 20) for _ in range(n)]
    b = [tok.raw_ids_padded(synth.rand_text(rng, 1, 70), 70) for _ in range(n)]
    args = [np.stack([x[0] for x in a]), np.array([x[1] for x in a]),
            np.stack([x[0] for x in b]), np.array([x[1] for x in b])]
    qsp_j = jbeam.assemble_pair_inputs(*map(jnp.asarray, args), 88, tok.spec)
    qsp_t = tbeam.assemble_pair_inputs(*map(torch.from_numpy, args), 88,
                                       HashTokenizer(vocab_size=512).spec)
    # rows 0-11 inactive: with these lengths whole tiles go inactive
    active = np.arange(n) >= 12
    buckets, fracs = {"buckets": (BUCKETS["hop2_buckets"],
                                  BUCKETS["hop2_tile_fracs"]),
                      "uneven": ((32, 64, 88), ()),
                      "none": ((), ())}[tiling]
    cfg = dict(BASE, hop2_buckets=buckets, hop2_tile_fracs=fracs)
    jeng = JaxSearcher.__new__(JaxSearcher)
    jeng.config = JaxSearchConfig(**cfg)
    jeng.encode_fn = enc
    exp = jeng._encode_hop2(params, qsp_j, encode=qsp,
                            active=jnp.asarray(active), inactive_sort=sort)
    teng = BeamSearcher.__new__(BeamSearcher)
    teng.config = SearchConfig(**cfg)
    _, teng_qsp = _port_fns("unified_plain")
    with torch.inference_mode():
        got = teng._encode_hop2(qsp_t, encode=teng_qsp,
                                active=torch.from_numpy(active),
                                inactive_sort=sort)
    assert isinstance(got, tuple) and len(got) == 2
    for g, e in zip(got, exp):
        e = np.asarray(e, np.float32)
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g.numpy() == 0, e == 0)
    if tiling == "buckets":
        assert (np.asarray(exp[1]) == 0).all(axis=1).any(), \
            "no tile was skipped: the case is vacuous"
