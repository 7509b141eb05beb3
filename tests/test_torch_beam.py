"""Serving-engine parity: the port's BeamSearcher against the JAX
BeamSearcher on the tests/synth.py + HashTokenizer fixtures, with the same
weights (converted) and the same index.

Each case runs the port twice:
  * "shared": the port's engine calls the JAX encoder, so both engines'
    MIPS see identical query vectors — any difference is the engine's;
  * "port": the port's own encoder.  fp32 encodes differ from the JAX
    ones by <= 1e-5 (summation order, tests/test_torch_encoder.py), far
    below the gaps between competing scores in these fixtures, so ids and
    certificates must still be equal.
hop1_ids, hop2_ids and pca_cert* are compared exactly; path_scores to
atol 1e-4 (fp32 summation order in encoder and MIPS).
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
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxRetriever
from multihop_dense_retrieval_tpu.search import BeamSearcher as JaxSearcher
from multihop_dense_retrieval_tpu.search import beam as jbeam
from multihop_dense_retrieval_tpu_torch.core.config import (EncoderConfig,
                                                            SearchConfig)
from multihop_dense_retrieval_tpu_torch.core.mesh import make_mesh
from multihop_dense_retrieval_tpu_torch.data import HashTokenizer
from multihop_dense_retrieval_tpu_torch.index import DenseIndex
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, retriever_state_dict_from_jax)
from multihop_dense_retrieval_tpu_torch.search import (
    BeamSearcher, assemble_pair_inputs, truncate_longest_first)
from tests import synth

_JDT = {"int8": jnp.int8, "float32": jnp.float32}


def test_truncate_longest_first_bit_equal():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 80, size=500).astype(np.int32)
    b = rng.randint(0, 400, size=500).astype(np.int32)
    for budget in (1, 7, 64, 346):
        ja, jb = jbeam.truncate_longest_first(jnp.asarray(a), jnp.asarray(b),
                                              budget)
        ta, tb = truncate_longest_first(torch.from_numpy(a),
                                        torch.from_numpy(b), budget)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("roberta_style", [True, False])
def test_assemble_pair_inputs_bit_equal(roberta_style):
    tok = JaxHashTokenizer(vocab_size=512, roberta_style=roberta_style)
    ttok = HashTokenizer(vocab_size=512, roberta_style=roberta_style)
    rng = np.random.RandomState(1)
    qs = [synth.rand_text(rng, 0, 14) for _ in range(9)]
    texts = [synth.rand_text(rng, 0, 70) for _ in range(9)]
    a = [tok.raw_ids_padded(q, 16) for q in qs]
    b = [tok.raw_ids_padded(t, 64) for t in texts]
    assert [ttok.raw_ids_padded(q, 16)[1] for q in qs] == [x[1] for x in a]
    args = [np.stack([x[0] for x in a]), np.array([x[1] for x in a]),
            np.stack([x[0] for x in b]), np.array([x[1] for x in b])]
    for max_len in (48, 90):
        exp = jbeam.assemble_pair_inputs(*map(jnp.asarray, args), max_len,
                                         tok.spec)
        got = assemble_pair_inputs(*map(torch.from_numpy, args), max_len,
                                   ttok.spec)
        assert set(got) == set(exp)
        for key in exp:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(exp[key]))
        host = ttok.encode_batch_pair(list(zip(qs, texts)), max_len)
        np.testing.assert_array_equal(got["input_ids"].numpy(),
                                      host["input_ids"])


def test_hash_tokenizer_copy_matches():
    rng = np.random.RandomState(2)
    for style in (True, False):
        j = JaxHashTokenizer(vocab_size=300, roberta_style=style)
        t = HashTokenizer(vocab_size=300, roberta_style=style)
        assert t.spec == type(t.spec)(**vars(j.spec))
        texts = [synth.rand_text(rng, 0, 30) for _ in range(6)]
        for x, y in zip(texts, texts[::-1]):
            for key, val in j.encode_pair(x, y, 40).items():
                np.testing.assert_array_equal(t.encode_pair(x, y, 40)[key], val)
            for key, val in j.encode_one(x, 24).items():
                np.testing.assert_array_equal(t.encode_one(x, 24)[key], val)


# ---- engine fixtures ----------------------------------------------------

CASES = {
    # name: (roberta, index dtype, corpus docs, random emb, search kwargs);
    # pca_dims in the kwargs builds the prefilter
    "plain_fp32": (True, "float32", 48, False,
                   dict(beam_size_1=3, beam_size_2=3, topk=4, max_q_len=24,
                        max_q_sp_len=72)),
    "plain_bert": (False, "float32", 48, False,
                   dict(beam_size_1=3, beam_size_2=3, topk=4, max_q_len=24,
                        max_q_sp_len=72)),
    "buckets_uneven": (True, "float32", 48, False,
                       dict(beam_size_1=4, beam_size_2=4, topk=4,
                            max_q_len=24, max_q_sp_len=88,
                            hop2_buckets=(32, 48, 64, 88),
                            hop2_tile_fracs=(0.25, 0.375, 0.25, 0.125),
                            q_width_multiple=8)),
    "buckets_int8": (True, "int8", 48, False,
                     dict(beam_size_1=4, beam_size_2=4, topk=4, max_q_len=24,
                          max_q_sp_len=88, hop2_buckets=(32, 48, 64, 88))),
    "pca_auto_fp32": (True, "float32", 1000, False,
                      dict(beam_size_1=4, beam_size_2=4, topk=4, max_q_len=24,
                           max_q_sp_len=88, use_pca=True, pca_k_chunks=4,
                           hop2_buckets=(32, 48, 64, 88), pca_dims=32)),
    "pca_auto_random": (True, "float32", 1000, True,
                        dict(beam_size_1=4, beam_size_2=4, topk=4,
                             max_q_len=24, max_q_sp_len=88, use_pca=True,
                             pca_k_chunks=4, hop2_buckets=(32, 48, 64, 88),
                             pca_dims=16)),
    "pca_12_int8": (True, "int8", 1000, False,
                    dict(beam_size_1=2, beam_size_2=3, topk=3, max_q_len=24,
                         max_q_sp_len=88, use_pca=True, pca_k_chunks=4,
                         pca_hops="12", pca_dims=32)),
}
# beam 2 of 8 over 16 hop-2 rows: the port's engine takes the two-phase
# search at hop 2, with the chunk of config.chunk_rows (the JAX engine its
# XLA tier on the CPU; both are exact)
TWO_PHASE = {f"two_phase_{dtype}_c{chunk}": (
    True, dtype, 1000, False,
    dict(beam_size_1=2, beam_size_2=8, topk=8, max_q_len=24,
         max_q_sp_len=88, chunk_rows=chunk))
    for dtype in ("float32", "int8") for chunk in (128, 256)}
CASES.update(TWO_PHASE)


@functools.lru_cache(maxsize=None)
def _case(name):
    roberta, dtype, n_docs, random_emb, kw = CASES[name]
    kw = dict(dict(chunk_rows=128), **kw, use_pallas=False)
    pca_dims = kw.pop("pca_dims", None)
    tok = JaxHashTokenizer(vocab_size=512, roberta_style=roberta)
    rng = np.random.RandomState(40 + len(name))
    docs = synth.make_corpus(rng, n_docs, empty_every=7)
    for i, d in enumerate(docs):
        if i % 3 == 0 and d["text"]:
            d["text"] = d["text"].split()[0]     # varied lengths for buckets
    corpus = Corpus(docs)
    tc = TokenizedCorpus.build(corpus, tok, max_text_len=60)
    ekw = dict(vocab_size=512, max_position_embeddings=96,
               type_vocab_size=1 if roberta else 2,
               roberta_positions=roberta)
    if not roberta:
        ekw.update(pad_token_id=0)
    model = JaxRetriever(JaxEncoderConfig.tiny(**ekw))
    params = model.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32), method=model.encode_seq)

    def jenc(p, ids, mask, tt=None):
        return model.apply(p, ids, mask, tt, method=model.encode_seq)

    if random_emb:
        emb = rng.randn(n_docs, 32).astype(np.float32)
    else:
        enc = tok.encode_batch_pair(
            [(corpus[i]["title"], corpus.encode_text(i))
             for i in range(n_docs)], 72)
        tt = enc.get("token_type_ids")
        emb = np.asarray(jenc(params, jnp.asarray(enc["input_ids"]),
                              jnp.asarray(enc["attention_mask"]),
                              None if tt is None else jnp.asarray(tt)),
                         np.float32)
    pca = dict(pca_dims=pca_dims, pca_cand_rows=128) if pca_dims else {}
    jindex = JaxIndex.build(emb, chunk_rows=128, dtype=_JDT[dtype], **pca)
    n_pad = jindex.vectors.shape[0]
    text_ids = np.full((n_pad, 60), tok.spec.pad_id, np.int32)
    text_ids[:n_docs] = tc.text_ids
    text_lens = np.zeros(n_pad, np.int32)
    text_lens[:n_docs] = tc.text_lens
    empty = np.zeros(n_pad, bool)
    empty[:n_docs] = tc.empty

    qs = ([f"short q{i}" for i in range(4)]
          + [f"which links {synth.rand_text(rng, 2, 12)}" for _ in range(4)])
    q_inputs = tok.encode_batch_one(qs, kw["max_q_len"])
    raw = [tok.raw_ids_padded(q, kw["max_q_len"] - 2) for q in qs]
    q_raw = (np.stack([r[0] for r in raw]), np.array([r[1] for r in raw]))

    jsearch = JaxSearcher(
        encode_fn=jenc, params=params, index=jindex,
        text_ids=jnp.asarray(text_ids), text_lens=jnp.asarray(text_lens),
        empty=jnp.asarray(empty), spec=tok.spec,
        config=JaxSearchConfig(**kw), mesh=None)
    exp = jsearch.search(dict(q_inputs), *q_raw)
    fixture = dict(emb=emb, dtype=dtype, pca=pca, text=(text_ids, text_lens,
                                                        empty),
                   q_inputs=q_inputs, q_raw=q_raw, kw=kw, ekw=ekw,
                   params=params, jenc=jenc, roberta=roberta)
    return fixture, exp


@pytest.mark.parametrize("encoder", ["shared", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_search_matches_jax_engine(case, encoder):
    f, exp = _case(case)
    if encoder == "shared":
        def encode_fn(ids, mask, tt=None):
            out = f["jenc"](f["params"], jnp.asarray(ids.numpy()),
                            jnp.asarray(mask.numpy()),
                            None if tt is None else jnp.asarray(tt.numpy()))
            return torch.from_numpy(np.array(out, np.float32))
    else:
        model = MhopRetriever(EncoderConfig.tiny(**f["ekw"]))
        model.load_state_dict(retriever_state_dict_from_jax(
            jax.device_get(f["params"])))
        encode_fn = model.encode_seq
    index = DenseIndex.build(f["emb"], chunk_rows=128, dtype=f["dtype"],
                             device="cpu", **f["pca"])
    tok = HashTokenizer(vocab_size=512, roberta_style=f["roberta"])
    searcher = BeamSearcher(encode_fn=encode_fn, index=index,
                            text_ids=f["text"][0], text_lens=f["text"][1],
                            empty=f["text"][2], spec=tok.spec,
                            config=SearchConfig(**f["kw"]), device="cpu")
    got = searcher.search(dict(f["q_inputs"]), *f["q_raw"])
    assert set(got) == set(exp)
    for key in ("hop1_ids", "hop2_ids", "hop1_cand_ids", "pca_cert1",
                "pca_cert2"):
        if key in exp:
            np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
    for key in ("path_scores", "hop1_cand_scores"):
        np.testing.assert_allclose(got[key], exp[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    if "pca_cert2" in exp and not CASES[case][3]:
        # encoder-made rows certify some queries (isotropic random rows
        # honestly certify none); certified paths are then compared too
        assert any(exp[key].any() for key in ("pca_cert1", "pca_cert2")
                   if key in exp)


@pytest.mark.parametrize("case", sorted(TWO_PHASE))
def test_engine_passes_chunk_rows_to_two_phase(case, monkeypatch):
    """The engine hands config.chunk_rows to the MIPS dispatcher: hop 2
    (k = 8, B = 16) runs the two-phase search with that chunk, and the
    chains equal the JAX engine's."""
    from multihop_dense_retrieval_tpu_torch.ops import mips as tm

    f, exp = _case(case)
    calls = []
    two_phase = tm.mips_topk_two_phase
    monkeypatch.setattr(tm, "mips_topk_two_phase", lambda *a, **kw: (
        calls.append((tuple(a[1].shape), kw["chunk_rows"])),
        two_phase(*a, **kw))[1])
    model = MhopRetriever(EncoderConfig.tiny(**f["ekw"]))
    model.load_state_dict(retriever_state_dict_from_jax(
        jax.device_get(f["params"])))
    index = DenseIndex.build(f["emb"], chunk_rows=128, dtype=f["dtype"],
                             device="cpu")
    searcher = BeamSearcher(encode_fn=model.encode_seq, index=index,
                            text_ids=f["text"][0], text_lens=f["text"][1],
                            empty=f["text"][2],
                            spec=HashTokenizer(vocab_size=512).spec,
                            config=SearchConfig(**f["kw"]), device="cpu")
    got = searcher.search(dict(f["q_inputs"]), *f["q_raw"])
    assert calls == [((16, 32), f["kw"]["chunk_rows"])]
    for key in ("hop1_ids", "hop2_ids"):
        np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
    np.testing.assert_allclose(got["path_scores"], exp["path_scores"],
                               rtol=0, atol=1e-4)


def test_token_store_16_bit_widens_after_gather():
    """A uint16 token store (ids above 32767) gives the same chains as the
    int32 store: the port keeps 16 bits and widens with & 0xFFFF."""
    f, _ = _case("plain_fp32")
    text_ids, text_lens, empty = f["text"]
    wide = text_ids + 40000 * (text_ids > 3)      # ids past int16's range
    index = DenseIndex.build(f["emb"], chunk_rows=128, dtype="float32",
                             device="cpu")
    tok = HashTokenizer(vocab_size=512)
    seen = {}

    def encode_fn(ids, mask, tt=None):
        seen.setdefault("max", []).append(int(ids.max()))
        return torch.zeros((ids.shape[0], 32))

    outs = []
    for store in (wide.astype(np.int32), wide.astype(np.uint16)):
        s = BeamSearcher(encode_fn=encode_fn, index=index, text_ids=store,
                         text_lens=text_lens, empty=empty, spec=tok.spec,
                         config=SearchConfig(**f["kw"]), device="cpu")
        outs.append(s.search(dict(f["q_inputs"]), *f["q_raw"]))
    assert s.text_ids.dtype == torch.int16
    assert max(seen["max"]) > 40000
    for key in outs[0]:
        np.testing.assert_array_equal(outs[0][key], outs[1][key])


def test_unported_options_raise():
    f, _ = _case("plain_fp32")
    index = DenseIndex.build(f["emb"], chunk_rows=128, dtype="float32",
                             device="cpu")
    tok = HashTokenizer(vocab_size=512)
    base = dict(encode_fn=None, index=index, text_ids=f["text"][0],
                text_lens=f["text"][1], empty=f["text"][2], spec=tok.spec,
                device="cpu")
    # sharding is ported: a mesh shards the index (a 4-shard mesh of the
    # CPU device; tests/test_torch_sharded_engine.py holds its chains to
    # the JAX engine's); the beam-4 options are accepted, and a cascade
    # without a stop head fails as in the JAX engine
    mesh = make_mesh(index=4, devices=[torch.device("cpu")] * 4)
    sharded = BeamSearcher(config=SearchConfig(**f["kw"]), mesh=mesh, **base)
    assert sharded.index.mesh == mesh and index.mesh is None
    assert [b.shape[0] for b in sharded.index.vectors.blocks] == \
        [index.vectors.shape[0] // 4] * 4
    with pytest.raises(ValueError, match="stop_skip_threshold"):
        BeamSearcher(config=SearchConfig(**f["kw"], stop_skip_threshold=0.5),
                     **base)
    BeamSearcher(config=SearchConfig(**f["kw"], hop2_prune_margin=-0.5,
                                     stop_skip_threshold=0.5),
                 encode_qsp_fn=lambda *a: None, **base)
