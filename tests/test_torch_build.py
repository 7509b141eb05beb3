"""Corpus encoding in the port against the JAX package: ``index/build.py``
(``encode_corpus``, ``build_index``), ``MultiVectorCtxEncoder``,
``index/shards.py`` and ``cli/encode_corpus``, on the same tokenized corpus
(``tests/synth.py``, seeded) and the same weights (JAX-initialised, carried
by ``models/convert.py``).

Tolerances:
  * fp32 vectors: atol 1e-5; the frameworks sum matmul products and
    LayerNorm statistics in different orders, nothing else differs.  The
    batch plan (length sort, 32-multiple widths, super-batches) is the
    same, so each passage is encoded at the same width in both.
  * int8 codes: within 1, with at most 1% of them differing.  Both quantize
    the fp32 vectors with the same arithmetic, but vectors that differ by
    the fp32 tolerance can round a value near a half-step either way; the
    scales likewise within rtol 1e-5.
  * Token stores and id2doc.json: equal.
The downstream check runs the port's FEVER CLI on the JAX-built and on the
port-built directories: dumps equal, with the near-tie guard of
``tests/test_torch_cli.py`` on the scores of every search.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import common as jcommon
from multihop_dense_retrieval_tpu.cli import encode_corpus as jcli
from multihop_dense_retrieval_tpu.core import mesh as jmesh
from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.data import HashTokenizer as JaxHashTok
from multihop_dense_retrieval_tpu.data import \
    TokenizedCorpus as JaxTokenizedCorpus
from multihop_dense_retrieval_tpu.data import Corpus as JaxCorpus
from multihop_dense_retrieval_tpu.index import build as jbuild
from multihop_dense_retrieval_tpu.index import shards as jshards
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxRetriever
from multihop_dense_retrieval_tpu.models.retriever import \
    MultiVectorCtxEncoder as JaxMultiVector
from multihop_dense_retrieval_tpu_torch.cli import common as tcommon
from multihop_dense_retrieval_tpu_torch.cli import encode_corpus as tcli
from multihop_dense_retrieval_tpu_torch.cli import eval_mhop_fever as tfever
from multihop_dense_retrieval_tpu_torch.cli import \
    eval_mhop_retrieval as tretr
from multihop_dense_retrieval_tpu_torch.core import mesh as tmesh
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.data import (Corpus, HashTokenizer,
                                                     TokenizedCorpus)
from multihop_dense_retrieval_tpu_torch.index import DenseIndex
from multihop_dense_retrieval_tpu_torch.index import build as tbuild
from multihop_dense_retrieval_tpu_torch.index import shards as tshards
from multihop_dense_retrieval_tpu_torch.models import (
    MhopRetriever, MultiVectorCtxEncoder, retriever_state_dict_from_jax)
from multihop_dense_retrieval_tpu_torch.ops import mips as tm
from multihop_dense_retrieval_tpu_torch.search import beam as tbeam
from tests import synth

VOCAB, MAX_POS = 512, 64


def _cfg_kw(**kw):
    return dict(vocab_size=VOCAB, max_position_embeddings=MAX_POS, **kw)


def _corpus(n, seed):
    rng = np.random.RandomState(seed)
    docs = synth.make_corpus(rng, n, empty_every=7)
    jtc = JaxTokenizedCorpus.build(JaxCorpus(docs), JaxHashTok(VOCAB),
                                   max_text_len=48)
    tc = TokenizedCorpus.build(Corpus(docs), HashTokenizer(VOCAB),
                               max_text_len=48)
    for name in ("text_ids", "text_lens", "title_ids", "title_lens",
                 "empty"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jtc, name))
    return jtc, tc, HashTokenizer(VOCAB).spec


def _retrievers(seed=0, **kw):
    jmodel = JaxRetriever(JaxEncoderConfig.tiny(**_cfg_kw(**kw)))
    ids0 = jnp.ones((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ids0, ids0,
                         method=jmodel.encode_seq)
    sd = retriever_state_dict_from_jax(jax.device_get(params))
    return jmodel, params, sd


def _jax_encode_fn(model, **apply_kw):
    def encode_fn(p, ids, mask, *tt):
        return model.apply(p, ids, mask, *tt, **apply_kw)
    return encode_fn


@pytest.mark.parametrize("impl,length_sort", [("xla", True), ("xla", False),
                                              ("fused", True)])
def test_encode_corpus_matches_jax(impl, length_sort):
    """41 docs in batches of 8 and super-batches of 4: six batches (the
    last one partial) in two super-batches, the second padded with two
    count-0 batches."""
    jtc, tc, spec = _corpus(41, seed=1)
    jmodel, params, sd = _retrievers(attention_impl=impl)
    kw = dict(max_c_len=48, batch_size=8, length_sort=length_sort,
              scan_batches=4)
    exp = jbuild.encode_corpus(
        _jax_encode_fn(jmodel, method=jmodel.encode_seq), params, jtc, spec,
        **kw)
    model = MhopRetriever(EncoderConfig.tiny(**_cfg_kw(attention_impl=impl)),
                          cls_only=True)
    model.load_state_dict(sd)
    got = tbuild.encode_corpus(model.encode_seq, tc, spec, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == exp.shape == (41, 32)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)


def test_batch_plan_widths_follow_the_sorted_lengths():
    _, tc, spec = _corpus(41, seed=1)
    supers = tbuild.batch_plan(tc, spec, max_c_len=48, batch_size=8,
                               length_sort=True, scan_batches=4)
    assert [s[1] for s in supers] == [[8, 8, 8, 8], [8, 1, 0, 0]]
    assert all(len(idx) == 8 for s in supers for idx in s[0])
    # the padding batches repeat their super-batch's first batch
    assert np.array_equal(supers[1][0][2], supers[1][0][0])
    widths = [s[2] for s in supers]
    assert widths == sorted(widths) and all(w % 32 == 0 or w == 48
                                            for w in widths)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_build_index_matches_jax(dtype):
    jtc, tc, spec = _corpus(40, seed=2)
    jmodel, params, sd = _retrievers(seed=1)
    kw = dict(max_c_len=48, batch_size=16, chunk_rows=32, pca_dims=8,
              pca_cand_rows=32)
    exp = jbuild.build_index(
        _jax_encode_fn(jmodel, method=jmodel.encode_seq), params, jtc, spec,
        dtype=jnp.dtype(dtype), **kw)
    model = MhopRetriever(EncoderConfig.tiny(**_cfg_kw()))
    model.load_state_dict(sd)
    got = tbuild.build_index(model.encode_seq, tc, spec, dtype=dtype,
                             device="cpu", **kw)
    assert (got.n_docs, got.chunk_rows, got.multi_vector, got.n_passages) \
        == (exp.n_docs, exp.chunk_rows, exp.multi_vector, 40)
    assert tuple(got.vectors.shape) == exp.vectors.shape == (64, 32)
    if dtype == "int8":
        _close_int8(got.vectors.numpy(), np.asarray(exp.vectors),
                    got.scales.numpy(), np.asarray(exp.scales))
    else:
        np.testing.assert_allclose(got.vectors.numpy(),
                                   np.asarray(exp.vectors), atol=1e-5)
    assert tuple(got.pca_proj.shape) == exp.pca_proj.shape


def _close_int8(got, exp, got_scales, exp_scales):
    diff = np.abs(got.astype(np.int32) - exp.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, \
        (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(got_scales, exp_scales, rtol=1e-5)


# ---- MultiVectorCtxEncoder (mirrors tests/test_multivector.py) -----------


def _mv_pair(m, scheme, project=True, seed=0):
    cfg_kw = _cfg_kw()
    jmodel = JaxMultiVector(JaxEncoderConfig.tiny(**cfg_kw), multi_vector=m,
                            scheme=scheme, project=project)
    ids0 = jnp.ones((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ids0, ids0)
    model = MultiVectorCtxEncoder(EncoderConfig.tiny(**cfg_kw),
                                  multi_vector=m, scheme=scheme,
                                  project=project)
    model.load_state_dict(retriever_state_dict_from_jax(
        jax.device_get(params)))
    return jmodel, params, model.eval()


@pytest.mark.parametrize("m,scheme,project", [
    (1, "tokenwise", True), (3, "tokenwise", True), (3, "tokenwise", False),
    (2, "layerwise", True), (3, "layerwise", False)])
def test_multivector_encoder_matches_jax(m, scheme, project):
    jmodel, params, model = _mv_pair(m, scheme, project)
    rng = np.random.RandomState(m)
    ids = rng.randint(5, 500, (4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.int32)
    mask[1, 7:] = 0
    exp = np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == exp.shape == (4 * m, 32)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scheme,m,L", [("tokenwise", 5, 4),
                                        ("layerwise", 4, 6)])
def test_multivector_too_few_positions_or_layers_raises(scheme, m, L):
    """The tiny encoder has 2 layers (3 hidden states); a 4-token input has
    4 positions.  Fewer rows would break the doc = row // m layout."""
    what = "encoder layers" if scheme == "layerwise" else "sequence positions"
    jmodel = JaxMultiVector(JaxEncoderConfig.tiny(**_cfg_kw()),
                            multi_vector=m, scheme=scheme)
    with pytest.raises(ValueError, match=what):
        jmodel.init(jax.random.PRNGKey(0), jnp.ones((2, L), jnp.int32),
                    jnp.ones((2, L), jnp.int32))
    model = MultiVectorCtxEncoder(EncoderConfig.tiny(**_cfg_kw()),
                                  multi_vector=m, scheme=scheme)
    ids = torch.full((2, L), 7)
    with pytest.raises(ValueError, match=what), torch.no_grad():
        model(ids, torch.ones_like(ids))


def test_mv_projected_space_matches_query_encoder():
    """project=True: a multi_vector=1 corpus vector is the query encoder's
    vector, and tokenwise row 0 of each passage group is the projected
    CLS (tests/test_multivector.py)."""
    _, _, sd = _retrievers(seed=0)
    retriever = MhopRetriever(EncoderConfig.tiny(**_cfg_kw()))
    retriever.load_state_dict(sd)
    ids = torch.from_numpy(np.random.RandomState(0).randint(5, 500, (4, 12)))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        q_vec = retriever.encode_seq(ids, mask)
        for m in (1, 3):
            mv = MultiVectorCtxEncoder(EncoderConfig.tiny(**_cfg_kw()),
                                       multi_vector=m)
            mv.load_state_dict(retriever.state_dict())
            torch.testing.assert_close(mv(ids, mask)[::m], q_vec, rtol=1e-6,
                                       atol=0)


def test_mv_build_index_roundtrip(tmp_path):
    """tokenwise m=3 -> build_index (equal to JAX's) -> save/load -> a
    query equal to doc 7's second vector retrieves doc 7 first."""
    m = 3
    jtc, tc, spec = _corpus(20, seed=5)
    jmodel, params, model = _mv_pair(m, "tokenwise")
    kw = dict(max_c_len=48, batch_size=8, chunk_rows=16, multi_vector=m)
    exp = jbuild.build_index(_jax_encode_fn(jmodel), params, jtc, spec,
                             dtype=jnp.float32, **kw)
    index = tbuild.build_index(model, tc, spec, dtype="float32",
                               device="cpu", **kw)
    assert index.multi_vector == m and index.n_docs == 20 * m
    assert index.n_passages == exp.n_passages == 20
    np.testing.assert_allclose(index.vectors.numpy(),
                               np.asarray(exp.vectors), atol=1e-5)
    p = str(tmp_path / "mv.npz")
    index.save(p)
    loaded = DenseIndex.load(p, device="cpu")
    assert loaded.multi_vector == m and loaded.n_passages == 20

    emb = index.vectors.numpy()[:index.n_docs]
    q = torch.from_numpy(emb[7 * m + 1: 7 * m + 2] * 5.0)
    vals, rows = tm.mips_topk(loaded.vectors, q, 4 * m, chunk_rows=16,
                              n_valid=loaded.n_docs)
    dv, di = tm.merge_multivector(vals, rows, 4, m)
    assert int(di[0, 0]) == 7
    doc_scores = (q.numpy() @ emb.T).reshape(1, -1, m).max(axis=2)
    np.testing.assert_array_equal(
        di.numpy(), np.argsort(-doc_scores, axis=1, kind="stable")[:, :4])


def test_mv_cli_encode_then_search(tmp_path):
    """--multi-vector 3 through the port's encode_corpus CLI, then its
    eval CLI: chains resolve to documents, not rows."""
    rng = np.random.RandomState(9)
    docs = synth.make_corpus(rng, 24)
    synth.write_jsonl(tmp_path / "corpus.jsonl", docs)
    synth.write_jsonl(tmp_path / "qas.jsonl",
                      synth.make_mhop_rows(rng, docs, n_rows=6))
    out_dir = str(tmp_path / "index_mv")
    tcli.main([str(tmp_path / "corpus.jsonl"), out_dir, "--device", "cpu",
               "--tokenizer", "hash", "--model-name", "tiny",
               "--batch-size", "8", "--chunk-rows", "32", "--max-c-len", "48",
               "--multi-vector", "3", "--mv-scheme", "layerwise"])
    idx = DenseIndex.load(f"{out_dir}/index.npz", device="cpu")
    assert idx.multi_vector == 3 and idx.n_passages == 24
    _, outputs = tretr.main(
        [str(tmp_path / "qas.jsonl"), out_dir, "--device", "cpu",
         "--tokenizer", "hash", "--model-name", "tiny", "--beam-size", "3",
         "--topk", "3", "--batch-size", "6", "--chunk-rows", "32",
         "--max-q-len", "24", "--max-q-sp-len", "96",
         "--save-path", str(tmp_path / "chains.jsonl")])
    titles = {d["title"] for d in docs}
    assert len(outputs) == 6
    for o in outputs:
        for chain in o["candidate_chains"]:
            assert all(hop["title"] in titles for hop in chain)


# ---- shards (mirrors tests/test_more_cli.py) -------------------------------


def test_encode_corpus_sharded_matches_single(tmp_path):
    """Two shards and a merge give the artifacts of a single run; with
    length sort off the two encodes are bit-equal."""
    docs = synth.make_corpus(np.random.RandomState(7), 24)
    synth.write_jsonl(tmp_path / "corpus.jsonl", docs)
    corpus = str(tmp_path / "corpus.jsonl")
    base = ["--device", "cpu", "--tokenizer", "hash", "--model-name", "tiny",
            "--batch-size", "8", "--chunk-rows", "16", "--max-c-len", "32",
            "--no-length-sort"]
    single, sharded = str(tmp_path / "single"), str(tmp_path / "sharded")
    tcli.main([corpus, single] + base)
    for sid in ("0", "1"):
        tcli.main([corpus, sharded, "--num-shards", "2", "--shard-id", sid]
                  + base)
    assert os.path.exists(os.path.join(sharded, "emb_shard1-of-2.npy"))
    tcli.main([corpus, sharded, "--merge-only"] + base)
    assert not os.path.exists(os.path.join(sharded, "emb_shard0-of-2.npy"))

    a = DenseIndex.load(os.path.join(single, "index.npz"), device="cpu")
    b = DenseIndex.load(os.path.join(sharded, "index.npz"), device="cpu")
    assert a.n_docs == b.n_docs == 24
    assert torch.equal(a.vectors, b.vectors)
    ta = TokenizedCorpus.load(os.path.join(single, "tokens.npz"))
    tb = TokenizedCorpus.load(os.path.join(sharded, "tokens.npz"))
    np.testing.assert_array_equal(ta.text_ids, tb.text_ids)
    np.testing.assert_array_equal(ta.text_lens, tb.text_lens)
    with open(os.path.join(single, "id2doc.json")) as f, \
            open(os.path.join(sharded, "id2doc.json")) as g:
        assert json.load(f) == json.load(g)


def _shard_arrays(n, width=6):
    tc = TokenizedCorpus(np.ones((n, width), np.int32),
                         np.full(n, width, np.int32),
                         np.ones((n, 3), np.int32), np.full(n, 3, np.int32),
                         np.zeros(n, bool))
    return tc, Corpus([{"title": f"t{i}", "text": f"x{i}"} for i in range(n)])


def test_merge_shards_fails_loud(tmp_path):
    emb = np.ones((4, 8), np.float32)
    tc, corpus = _shard_arrays(4)
    tshards.save_shard(str(tmp_path), 0, 3, emb, tc, corpus)
    with pytest.raises(FileNotFoundError, match="missing embedding shards"):
        tshards.merge_shards(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="no shard artifacts"):
        tshards.merge_shards(str(tmp_path / "empty"), device="cpu")
    tshards.save_shard(str(tmp_path), 0, 2, emb, tc, corpus)
    with pytest.raises(ValueError, match="mixed shard counts"):
        tshards.detect_num_shards(str(tmp_path))
    assert tshards.shard_bounds(10, 3, 2) == jshards.shard_bounds(10, 3, 2) \
        == (6, 10)
    with pytest.raises(ValueError):
        tshards.shard_bounds(10, 3, 3)


def test_shards_merge_like_jax(tmp_path):
    """Shard artifacts the JAX package writes merge in the port to the
    same index, token store and id2doc as the JAX merge."""
    rng = np.random.RandomState(3)
    for i, n in enumerate((5, 7)):
        tc, corpus = _shard_arrays(n)
        emb = rng.randn(n, 16).astype(np.float32)
        for d in ("j", "t"):
            jshards.save_shard(str(tmp_path / d), i, 2, emb,
                               JaxTokenizedCorpus(tc.text_ids, tc.text_lens,
                                                  tc.title_ids,
                                                  tc.title_lens, tc.empty),
                               JaxCorpus(corpus.docs))
    kw = dict(chunk_rows=16, dtype="int8")
    exp = jshards.merge_shards(str(tmp_path / "j"), **kw)
    got = tshards.merge_shards(str(tmp_path / "t"), device="cpu", **kw)
    assert got.n_docs == exp.n_docs == 12
    assert np.array_equal(got.vectors.numpy(), np.asarray(exp.vectors))
    for name in ("tokens.npz", "id2doc.json"):
        with open(tmp_path / "j" / name, "rb") as f, \
                open(tmp_path / "t" / name, "rb") as g:
            if name.endswith(".json"):
                assert json.load(f) == json.load(g)
            else:
                za, zb = np.load(f), np.load(g)
                for key in za.files:
                    np.testing.assert_array_equal(za[key], zb[key])
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))


# ---- the CLI against the JAX CLI -------------------------------------------

CLI_SEED = 4


def _tiny_fp32(cls):
    return lambda **kw: cls.tiny(vocab_size=50265, max_position_embeddings=514,
                                 **dict(kw, dtype="float32"))


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """One corpus and one .pt, encoded by both packages' CLIs into int8
    directories with --export-npy (512 docs, 128-row chunks)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jcommon.MODEL_PRESETS, "tiny", _tiny_fp32(JaxEncoderConfig))
    mp.setitem(tcommon.MODEL_PRESETS, "tiny", _tiny_fp32(EncoderConfig))
    tmp = tmp_path_factory.mktemp("torch_encode_cli")
    rng = np.random.RandomState(CLI_SEED)
    docs = synth.make_corpus(rng, 512, empty_every=50)
    synth.write_jsonl(tmp / "corpus.jsonl", docs)
    claims = [{"id": i, "claim": synth.rand_text(rng, 3, 12)}
              for i in range(8)]
    synth.write_jsonl(tmp / "claims.jsonl", claims)
    model = JaxRetriever(jcommon.resolve_encoder_config("tiny"))
    params = model.init(jax.random.PRNGKey(CLI_SEED),
                        jnp.ones((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32), method=model.encode_seq)
    ckpt = str(tmp / "retriever.pt")
    torch.save(retriever_state_dict_from_jax(jax.device_get(params)), ckpt)
    flags = ["--tokenizer", "hash", "--model-name", "tiny", "--checkpoint",
             ckpt, "--batch-size", "64", "--chunk-rows", "128",
             "--max-c-len", "64", "--index-dtype", "int8", "--export-npy"]
    dirs = {"jax": str(tmp / "jax"), "torch": str(tmp / "torch")}
    jcli.main([str(tmp / "corpus.jsonl"), dirs["jax"]] + flags)
    tcli.main([str(tmp / "corpus.jsonl"), dirs["torch"], "--device", "cpu"]
              + flags)
    yield dict(tmp=tmp, ckpt=ckpt, dirs=dirs)
    mp.undo()


def test_cli_artifacts_match_jax(cli_dirs):
    j, t = cli_dirs["dirs"]["jax"], cli_dirs["dirs"]["torch"]
    for name in ("tokens.npz",):
        za, zb = np.load(os.path.join(j, name)), np.load(os.path.join(t, name))
        assert za.files == zb.files
        for key in za.files:
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)
    with open(os.path.join(j, "id2doc.json")) as f, \
            open(os.path.join(t, "id2doc.json")) as g:
        assert json.load(f) == json.load(g)
    ja, ta = np.load(os.path.join(j, "index.npz")), \
        np.load(os.path.join(t, "index.npz"))
    for key in ("n_docs", "chunk_rows", "multi_vector", "dtype"):
        assert ja[key] == ta[key], key
    assert int(ta["n_docs"]) == 512
    np.testing.assert_allclose(np.load(os.path.join(t, "wiki_index.npy")),
                               np.load(os.path.join(j, "wiki_index.npy")),
                               rtol=0, atol=1e-5)
    _close_int8(ta["payload"], ja["payload"], ta["scales"], ja["scales"])


def test_fever_cli_on_port_built_index_matches_jax_built(cli_dirs,
                                                         monkeypatch):
    """The port's FEVER CLI dumps the same rows over the directory the port
    built as over the one the JAX package built; at every pair of adjacent
    ranks the score gap exceeds the two runs' score differences."""
    tmp = cli_dirs["tmp"]
    seen = {}
    search = tbeam.BeamSearcher.search
    for name, index_dir in cli_dirs["dirs"].items():
        calls = seen[name] = []

        def recording(self, *a, **kw):
            out = search(self, *a, **kw)
            calls.append(out)
            return out

        monkeypatch.setattr(tbeam.BeamSearcher, "search", recording)
        with contextlib.redirect_stdout(io.StringIO()):
            tfever.main([str(tmp / "claims.jsonl"), index_dir, "--device",
                         "cpu", "--tokenizer", "hash", "--model-name",
                         "tiny", "--checkpoint", cli_dirs["ckpt"],
                         "--chunk-rows", "128", "--beam-size-1", "2",
                         "--beam-size-2", "4", "--topk", "4",
                         "--batch-size", "4",
                         "--save-path", str(tmp / f"{name}.jsonl")])
        monkeypatch.setattr(tbeam.BeamSearcher, "search", search)
    with open(tmp / "jax.jsonl") as f, open(tmp / "torch.jsonl") as g:
        jrows, trows = f.read(), g.read()
    assert len(jrows.splitlines()) == 8 and trows == jrows
    assert len(seen["jax"]) == len(seen["torch"]) == 2
    for j, t in zip(seen["jax"], seen["torch"]):
        for key in ("hop1_ids", "hop2_ids", "hop1_cand_ids"):
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        for key in ("path_scores", "hop1_cand_scores"):
            diff = np.abs(t[key] - j[key])
            gaps = -np.diff(j[key], axis=1)
            assert (gaps > diff[:, :-1] + diff[:, 1:]).all(), key


# ---- no fallback, unported options -----------------------------------------


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    _, tc, spec = _corpus(8, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild.encode_corpus(lambda *a: None, tc, spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild.build_index(lambda *a: None, tc, spec)
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main([missing + ".jsonl", missing, "--tokenizer", "hash",
                   "--model-name", "tiny"])
    assert not os.path.exists(missing)


def test_single_device_encode_never_copies_the_encoder(monkeypatch):
    """Encoding on the encoder's own device, alone or as a data mesh that
    repeats it, uses the caller's module itself: no copy is made."""
    _, tc, spec = _corpus(9, seed=4)
    _, _, sd = _retrievers()
    model = MhopRetriever(EncoderConfig.tiny(**_cfg_kw()), cls_only=True)
    model.load_state_dict(sd)

    def refuse(_):
        raise AssertionError("the encoder was copied")

    monkeypatch.setattr(tbuild.copy, "deepcopy", refuse)
    kw = dict(max_c_len=48, batch_size=8, scan_batches=2)
    one = tbuild.encode_corpus(model.encode_seq, tc, spec, device="cpu", **kw)
    two = tbuild.encode_corpus(
        model.encode_seq, tc, spec, **kw,
        mesh=tmesh.make_mesh(data=2, index=1, devices=["cpu"] * 2))
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-6)
    assert tbuild._replicas(model, ["cpu"]) == [model]


def test_unported_options_raise(tmp_path):
    """Data-parallel encoding and the row-sharded build are ported (the JAX
    package's ``mesh=``, ``n_shards=`` and ``--data-parallel``): each batch
    split over a 2-device data mesh (the CPU device twice) gives the rows
    of the single-device encode (fp32 within 1e-6: the halves' products
    are the same, only the GEMM's blocking may differ) and of the JAX
    package's 2-device encode (1e-5, as above); build_index(n_shards=2)
    pads to chunk_rows x 2 and, with a 2-shard mesh, places a row block on
    each shard; ``encode_corpus --data-parallel 2`` writes the single run's
    artifacts.  A batch that does not split over the data devices raises,
    and the --export-npy combinations still exit."""
    jtc, tc, spec = _corpus(19, seed=3)
    jmodel, params, sd = _retrievers()
    model = MhopRetriever(EncoderConfig.tiny(**_cfg_kw()), cls_only=True)
    model.load_state_dict(sd)
    cpu = torch.device("cpu")
    dp = tmesh.make_mesh(data=2, index=1, devices=[cpu] * 2)
    kw = dict(max_c_len=48, batch_size=8, scan_batches=2)
    one = tbuild.encode_corpus(model.encode_seq, tc, spec, device="cpu", **kw)
    two = tbuild.encode_corpus(model.encode_seq, tc, spec, mesh=dp, **kw)
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-6)
    exp = jbuild.encode_corpus(
        _jax_encode_fn(jmodel, method=jmodel.encode_seq), params, jtc, spec,
        mesh=jmesh.make_mesh(data=2, index=1, devices=jax.devices()[:2]),
        **kw)
    np.testing.assert_allclose(two, exp, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="does not split"):
        tbuild.encode_corpus(model.encode_seq, tc, spec, mesh=dp,
                             max_c_len=48, batch_size=7)
    # data devices the encoder does not live on get a copy of its module
    # ("cpu:0" is a device of its own name): the same rows, to the GEMM's
    # blocking (1e-6)
    other = tmesh.make_mesh(data=2, index=1,
                            devices=[cpu, torch.device("cpu", 0)])
    fns = tbuild._replicas(model.encode_seq, other.data_devices())
    assert fns[0] == model.encode_seq and fns[1].__self__ is not model
    np.testing.assert_allclose(
        tbuild.encode_corpus(model.encode_seq, tc, spec, mesh=other, **kw),
        two, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="nn.Module"):
        tbuild._replicas(lambda *a: None, other.data_devices())
    bkw = dict(max_c_len=48, batch_size=8, chunk_rows=16, dtype="float32")
    index = tbuild.build_index(model.encode_seq, tc, spec, n_shards=2,
                               device="cpu", **bkw)
    assert index.vectors.shape[0] == 32 and index.mesh is None
    sharded = tbuild.build_index(
        model.encode_seq, tc, spec, n_shards=2,
        mesh=tmesh.make_mesh(index=2, devices=[cpu] * 2), **bkw)
    assert [b.shape[0] for b in sharded.vectors.blocks] == [16, 16]
    assert torch.equal(sharded.vectors.gather(), index.vectors)

    docs = synth.make_corpus(np.random.RandomState(5), 20)
    synth.write_jsonl(tmp_path / "c.jsonl", docs)
    base = [str(tmp_path / "c.jsonl"), str(tmp_path / "out"), "--device",
            "cpu"]
    run = ["--tokenizer", "hash", "--model-name", "tiny", "--batch-size",
           "8", "--chunk-rows", "16", "--max-c-len", "32", "--index-dtype",
           "float32"]
    tcli.main(base + run + ["--data-parallel", "2"])
    tcli.main([str(tmp_path / "c.jsonl"), str(tmp_path / "one"), "--device",
               "cpu"] + run)
    a = DenseIndex.load(str(tmp_path / "out" / "index.npz"), device="cpu")
    b = DenseIndex.load(str(tmp_path / "one" / "index.npz"), device="cpu")
    assert a.n_docs == b.n_docs == 20
    np.testing.assert_allclose(a.vectors.numpy(), b.vectors.numpy(),
                               rtol=0, atol=1e-6)
    for flags in (["--export-npy", "--num-shards", "2"],
                  ["--export-npy", "--multi-vector", "2"]):
        with pytest.raises(SystemExit):
            tcli.main(base + flags)
