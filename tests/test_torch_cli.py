"""The port's retrieval-eval CLIs against the JAX package's, on index
directories that the JAX package's ``cli/encode_corpus`` builds from a
2,048-doc synthetic corpus (``tests/synth.py``), with the same weights.

Set-up, shared by the module (so ``--dist loadfile`` keeps it on one
worker):
  * one tiny retriever, initialised in JAX and written as a reference
    ``.pt`` with the port's ``retriever_state_dict_from_jax``; both CLIs
    load it with ``--checkpoint``;
  * the ``tiny`` preset runs in fp32 in both packages for these tests (the
    CLIs' own default is bf16, whose encodes differ between the two
    frameworks by far more than the score gaps; fp32 encodes agree to
    1e-5, tests/test_torch_encoder.py);
  * two index directories with ``--chunk-rows 128 --pca-cand-rows 128``:
    bf16 with a 16-dim PCA prefilter, and int8.  2,048 rows are 16 chunks,
    so a hop-2 top-10 rescans 10 of them.
The FEVER runs (beam 2 / 10, batch 4) search hop 2 at B=8, k=10, the
two-phase route in the port; the JAX package takes its XLA tier on the
CPU.  Both are exact, so dumps must be equal row for row and the metrics
JSON equal.  ``--hop2-prune-margin`` runs (fixed and ``auto``) compare the
same way, and the pruned chains' NEG_INF scores must sit in the same
places.  The ``*_shards*`` runs pass ``--index-shards 2`` or ``4`` to
both CLIs: the JAX one shards over its virtual CPU devices, the port's
over the CPU device repeated; every shard of the port takes the
two-phase search at hop 2.

The variable-hop runs use a second set-up (``unified_env``): a tiny
UnifiedRetriever written as a reference-layout ``.pt`` (the JAX package's
``unified_flax_to_ckpt``) and a 512-doc corpus, encoded by both packages'
``encode_corpus --unified`` (fp32 rows, so the two encoders' 1e-5 stays
below the hop-1 score gaps).  Both ``eval_mhop_retrieval
--unified`` CLIs then run over the JAX-built directory, with and without
``--stop-skip``; the thresholds lie halfway between two adjacent stop
probabilities of a JAX run, so no chain sits on one.  Dumps must be
equal apart from the stop probabilities they carry (rtol 1e-5, atol
1e-6).  ``--hnsw``: the JAX CLI builds ``index.hnsw`` in a copy of the
int8 directory and the port loads it; dumps and metrics equal.

Tolerance for the scores beside the dumps: SCORE_TOL = 5e-3.  The fp32
encodes agree to 1e-5, but each query is cast to the index dtype, and an
encode that differs by 1e-5 can round a component to the neighbouring bf16
or int8 value: one step (~2^-8 of a component of norm ~1) times a row
component.  Equal ids could then be luck of a near-tie, so at every pair
of adjacent ranks the tests check that the JAX gap exceeds the two
packages' score differences at those ranks: the order follows from the
values.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import common as jcommon
from multihop_dense_retrieval_tpu.cli import encode_corpus
from multihop_dense_retrieval_tpu.cli import eval_mhop_fever as jfever
from multihop_dense_retrieval_tpu.cli import eval_mhop_retrieval as jretr
from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxRetriever
from multihop_dense_retrieval_tpu.models import UnifiedRetriever as JaxUnified
from multihop_dense_retrieval_tpu.models.export import unified_flax_to_ckpt
from multihop_dense_retrieval_tpu.search import beam as jbeam
from multihop_dense_retrieval_tpu_torch.cli import common as tcommon
from multihop_dense_retrieval_tpu_torch.cli import encode_corpus as tencode
from multihop_dense_retrieval_tpu_torch.cli import eval_mhop_fever as tfever
from multihop_dense_retrieval_tpu_torch.cli import eval_mhop_retrieval as tretr
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.models import \
    retriever_state_dict_from_jax
from multihop_dense_retrieval_tpu_torch.ops import mips as tm
from multihop_dense_retrieval_tpu_torch.ops.mips import NEG_INF
from multihop_dense_retrieval_tpu_torch.search import beam as tbeam
from tests import synth

SCORE_TOL = 5e-3
WIDEN = 4.0
SEED = 2


def _tiny_fp32(cls):
    return lambda **kw: cls.tiny(vocab_size=50265, max_position_embeddings=514,
                                 **dict(kw, dtype="float32"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(jcommon.MODEL_PRESETS, "tiny", _tiny_fp32(JaxEncoderConfig))
    mp.setitem(tcommon.MODEL_PRESETS, "tiny", _tiny_fp32(EncoderConfig))
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.RandomState(SEED)
    docs = synth.make_corpus(rng, 2048)
    synth.write_jsonl(tmp / "corpus.jsonl", docs)
    rows = synth.make_mhop_rows(rng, docs, n_rows=12)
    synth.write_jsonl(tmp / "qas.jsonl", rows)
    claims = [{"id": 1000 + i, "claim": synth.rand_text(rng, 3, 12)}
              for i in range(10)]
    for c, r in zip(claims[:6], rows):          # some rows carry gold titles
        c["sp"] = r["sp"]
    synth.write_jsonl(tmp / "claims.jsonl", claims)

    model = JaxRetriever(jcommon.resolve_encoder_config("tiny"))
    params = model.init(jax.random.PRNGKey(SEED), jnp.ones((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32), method=model.encode_seq)
    # a wider init than Flax's default spreads the random model's vectors,
    # whose scores would otherwise crowd within the tolerance
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * WIDEN if "kernel" in jax.tree_util.keystr(path)
        else x, params)
    ckpt = str(tmp / "retriever.pt")
    torch.save(retriever_state_dict_from_jax(jax.device_get(params)), ckpt)

    dirs = {}
    for name, flags in (("bf16", ["--index-dtype", "bfloat16",
                                  "--pca-dims", "16"]),
                        ("int8", ["--index-dtype", "int8"])):
        dirs[name] = str(tmp / name)
        encode_corpus.main([str(tmp / "corpus.jsonl"), dirs[name],
                            "--tokenizer", "hash", "--model-name", "tiny",
                            "--checkpoint", ckpt, "--batch-size", "256",
                            "--chunk-rows", "128", "--pca-cand-rows", "128",
                            "--max-c-len", "64"] + flags)
    yield dict(tmp=tmp, ckpt=ckpt, dirs=dirs)
    mp.undo()


def _run(main, searcher_cls, args, monkeypatch):
    """Run a CLI main; return (its return value, the last stdout line,
    every search() result of the run)."""
    seen = []
    search = searcher_cls.search

    def recording(self, *a, **kw):
        out = search(self, *a, **kw)
        seen.append({k: np.asarray(v) for k, v in out.items()})
        return out

    monkeypatch.setattr(searcher_cls, "search", recording)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(args)
    monkeypatch.setattr(searcher_cls, "search", search)
    lines = buf.getvalue().strip().splitlines()
    return ret, lines[-1] if lines else "", seen


def _check_results(jseen, tseen, topk):
    """Ids and certificates equal; scores within SCORE_TOL, each adjacent
    pair's JAX gap above the two differences (pairs of pruned chains, both
    NEG_INF, aside: equal scores, and their ids already compared)."""
    assert len(jseen) == len(tseen) > 0
    for j, t in zip(jseen, tseen):
        assert set(j) == set(t)
        for key in ("hop1_ids", "hop2_ids", "hop1_cand_ids", "pca_cert1",
                    "pca_cert2"):
            if key in j:
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        for key in ("path_scores", "hop1_cand_scores"):
            dead = j[key] <= NEG_INF / 2
            np.testing.assert_array_equal(t[key][dead], j[key][dead])
            np.testing.assert_allclose(t[key], j[key], rtol=0,
                                       atol=SCORE_TOL, err_msg=key)
            diff = np.abs(t[key] - j[key])
            gaps = -np.diff(j[key], axis=1)
            ok = (gaps > diff[:, :-1] + diff[:, 1:]) | dead[:, 1:]
            assert ok.all(), key
        for key in ("stop_probs", "top_stop_probs"):
            if key in j:
                np.testing.assert_allclose(t[key], j[key], rtol=1e-5,
                                           atol=1e-6, err_msg=key)
        assert j["path_scores"].shape[1] == topk


def _record_pruning(monkeypatch):
    """The port engine's prune masks of a run."""
    kept = []
    prune = tbeam.BeamSearcher._prune_active

    def recording(self, *a):
        out = prune(self, *a)
        kept.append(out)
        return out

    monkeypatch.setattr(tbeam.BeamSearcher, "_prune_active", recording)
    return kept


def _check_pruned(kept, extra):
    """With a margin, some candidates (never all) were pruned."""
    if "--hop2-prune-margin" not in extra:
        assert all(k is None for k in kept)
        return
    mask = torch.cat(kept)
    assert not bool(mask.all()) and bool(mask.any())


FEVER = {"bf16": ("bf16", []), "bf16_pca": ("bf16", ["--pca"]),
         "int8": ("int8", []),
         "bf16_shards2": ("bf16", ["--index-shards", "2"]),
         "bf16_pca_shards2": ("bf16", ["--pca", "--index-shards", "2"]),
         "int8_shards4_prune": ("int8", ["--index-shards", "4",
                                         "--hop2-prune-margin", "0.5"]),
         "int8_prune_auto": ("int8", ["--hop2-prune-margin", "auto"]),
         "bf16_pca_prune_fixed": ("bf16", ["--pca", "--hop2-prune-margin",
                                           "0.5"])}


@pytest.mark.parametrize("case", sorted(FEVER))
def test_eval_mhop_fever_matches_jax(env, case, monkeypatch):
    index, extra = FEVER[case]
    tmp = env["tmp"]
    args = [str(tmp / "claims.jsonl"), env["dirs"][index], "--tokenizer",
            "hash", "--model-name", "tiny", "--checkpoint", env["ckpt"],
            "--chunk-rows", "128", "--beam-size-1", "2", "--beam-size-2",
            "10", "--topk", "10", "--batch-size", "4"] + extra
    jpath, tpath = str(tmp / f"j_{case}.jsonl"), str(tmp / f"t_{case}.jsonl")
    _, jline, jseen = _run(jfever.main, jbeam.BeamSearcher,
                           args + ["--save-path", jpath], monkeypatch)
    tcalls = []
    two_phase = tm.mips_topk_two_phase
    monkeypatch.setattr(tm, "mips_topk_two_phase", lambda *a, **kw: (
        tcalls.append(tuple(a[1].shape)), two_phase(*a, **kw))[1])
    kept = _record_pruning(monkeypatch)
    _, tline, tseen = _run(tfever.main, tbeam.BeamSearcher,
                           args + ["--save-path", tpath, "--device", "cpu"],
                           monkeypatch)
    with open(jpath) as f:
        jrows = [json.loads(l) for l in f]
    with open(tpath) as f:
        trows = [json.loads(l) for l in f]
    assert len(jrows) == 10 and trows == jrows
    assert json.loads(tline) == json.loads(jline)       # the metrics JSON
    _check_results(jseen, tseen, 10)
    # hop 2 (B = batch 4 x beam 2 = 8, k = 10) took the two-phase search
    # (on every shard) unless the prefilter served it
    pca = "--pca" in extra
    shards = int(extra[extra.index("--index-shards") + 1]) \
        if "--index-shards" in extra else 1
    assert tcalls == ([] if pca else [(8, 32)] * len(tseen) * shards)
    if pca:
        assert any(r["pca_cert2"].any() for r in tseen)
    _check_pruned(kept, extra)


RETRIEVAL = {"bf16_pca": ("bf16", ["--pca"]), "int8": ("int8", []),
             "int8_shards2": ("int8", ["--index-shards", "2"]),
             "bf16_pca_shards2": ("bf16", ["--pca", "--index-shards", "2"]),
             "int8_prune_auto": ("int8", ["--hop2-prune-margin", "auto"]),
             "bf16_pca_prune_q9": ("bf16", ["--pca", "--hop2-prune-margin",
                                            "auto:0.9"])}


@pytest.mark.parametrize("case", sorted(RETRIEVAL))
def test_eval_mhop_retrieval_matches_jax(env, case, monkeypatch):
    index, extra = RETRIEVAL[case]
    tmp = env["tmp"]
    args = [str(tmp / "qas.jsonl"), env["dirs"][index], "--tokenizer",
            "hash", "--model-name", "tiny", "--checkpoint", env["ckpt"],
            "--chunk-rows", "128", "--beam-size", "3", "--topk", "3",
            "--batch-size", "4"] + extra
    jpath, tpath = str(tmp / f"jr_{case}.jsonl"), str(tmp / f"tr_{case}.jsonl")
    (jagg, jout), _, jseen = _run(jretr.main, jbeam.BeamSearcher,
                                  args + ["--save-path", jpath], monkeypatch)
    kept = _record_pruning(monkeypatch)
    (tagg, tout), _, tseen = _run(
        tretr.main, tbeam.BeamSearcher,
        args + ["--save-path", tpath, "--device", "cpu"], monkeypatch)
    _check_pruned(kept, extra)
    assert tout == jout and len(tout) == 12
    assert tagg == jagg and set(tagg) >= {"overall", "bridge", "comparison"}
    with open(jpath) as f, open(tpath) as g:
        assert f.read() == g.read()
    _check_results(jseen, tseen, 3)


@pytest.mark.parametrize("name", ["roberta-base", "bert-base-uncased", "tiny",
                                  "mini"])
def test_model_presets_match_jax(name):
    import dataclasses

    j = jcommon.MODEL_PRESETS[name](dtype="bfloat16")
    t = tcommon.MODEL_PRESETS[name](dtype="bfloat16")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("layout", ["array", "jsonl"])
def test_load_json_flex_matches_jax(tmp_path, layout):
    rows = [{"_id": "a", "question": "q?"}, {"_id": "b", "question": "r"}]
    path = tmp_path / f"rows.{layout}"
    path.write_text("  " + json.dumps(rows) if layout == "array"
                    else "\n".join(json.dumps(r) for r in rows) + "\n\n")
    got = tcommon.load_json_flex(str(path))
    assert got == jcommon.load_json_flex(str(path)) == rows


def test_unported_options_raise(tmp_path):
    """Sharding, the beam-4 options and --hnsw are ported; their flag
    combinations fail as in the JAX CLI.  --index-shards N builds the mesh
    of N shards over the named device (the CPU here, repeated), and over
    the visible cards for the bare cuda, raising the JAX error where they
    are fewer than N (none here); the sharded runs themselves are the
    *_shards cases above."""
    cpu = torch.device("cpu")
    assert tcommon.index_mesh(1, "cpu") is None
    mesh = tcommon.index_mesh(2, "cpu")
    assert mesh.shape == {"data": 1, "index": 2}
    assert mesh.shard_devices() == [cpu, cpu]
    with pytest.raises(ValueError, match="does not fit the 0"):
        tcommon.index_mesh(2, "cuda")
    base = [str(tmp_path / "q.jsonl"), str(tmp_path), "--device", "cpu"]
    for flags in (["--stop-skip", "0.5"], ["--hnsw", "--pca"],
                  ["--hnsw", "--unified"], ["--hop2-prune-margin", "-1"],
                  ["--hop2-prune-margin", "auto:1.5"]):
        with pytest.raises(SystemExit):
            tretr.main(base + flags)
    # electra-large is ported (the reader's preset) and no longer raises
    assert tcommon.resolve_encoder_config("electra-large") == \
        EncoderConfig.electra_large()
    with pytest.raises(NotImplementedError, match="orbax"):
        tcommon.load_retriever_params(str(tmp_path))


def test_reference_checkpoint_names_load(env, tmp_path):
    """A reference-style .pt (DataParallel ``module.`` prefixes, an HF
    pooler) loads into the port's retriever."""
    sd = torch.load(env["ckpt"], weights_only=True)
    sd = {f"module.{k}": v for k, v in sd.items()}
    sd["module.encoder.pooler.dense.weight"] = torch.zeros(32, 32)
    sd["module.encoder.pooler.dense.bias"] = torch.zeros(32)
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    cfg = tcommon.resolve_encoder_config("tiny")
    a = tcommon.init_retriever(cfg, checkpoint=path, device="cpu")
    b = tcommon.init_retriever(cfg, checkpoint=env["ckpt"], device="cpu")
    ids = torch.randint(4, 500, (3, 12), generator=torch.Generator()
                        .manual_seed(0))
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        assert torch.equal(a.encode_seq(ids, mask), b.encode_seq(ids, mask))


# ---- --hnsw ---------------------------------------------------------------


def test_eval_hnsw_loads_the_jax_built_graph(env, monkeypatch):
    """The JAX CLI builds <dir>/index.hnsw (M 32, ef_construction 200)
    from the int8 rows and their scales; the port's CLI loads that file and
    gives the same chains, dumps and metrics."""
    tmp = env["tmp"]
    index_dir = str(tmp / "hnsw")
    shutil.copytree(env["dirs"]["int8"], index_dir)
    args = [str(tmp / "qas.jsonl"), index_dir, "--tokenizer", "hash",
            "--model-name", "tiny", "--checkpoint", env["ckpt"],
            "--beam-size", "3", "--topk", "3", "--batch-size", "4",
            "--hnsw", "--ef-search", "64"]
    jpath, tpath = str(tmp / "jh.jsonl"), str(tmp / "th.jsonl")
    (jagg, jout), _, jseen = _run(jretr.main, jretr._HnswBeamSearcher,
                                  args + ["--save-path", jpath], monkeypatch)
    graph = os.path.join(index_dir, "index.hnsw")
    stamp = os.stat(graph).st_mtime_ns
    (tagg, tout), _, tseen = _run(
        tretr.main, tretr.HnswBeamSearcher,
        args + ["--save-path", tpath, "--device", "cpu"], monkeypatch)
    assert os.stat(graph).st_mtime_ns == stamp        # loaded, not rebuilt
    assert tout == jout and len(tout) == 12 and tagg == jagg
    with open(jpath) as f, open(tpath) as g:
        assert f.read() == g.read()
    _check_results(jseen, tseen, 3)


# ---- --unified, --stop-skip ------------------------------------------------


@pytest.fixture(scope="module")
def unified_env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(jcommon.MODEL_PRESETS, "tiny", _tiny_fp32(JaxEncoderConfig))
    mp.setitem(tcommon.MODEL_PRESETS, "tiny", _tiny_fp32(EncoderConfig))
    tmp = tmp_path_factory.mktemp("torch_cli_unified")
    rng = np.random.RandomState(SEED + 1)
    docs = synth.make_corpus(rng, 512, empty_every=37)
    synth.write_jsonl(tmp / "corpus.jsonl", docs)
    synth.write_jsonl(tmp / "qas.jsonl",
                      synth.make_mhop_rows(rng, docs, n_rows=16))
    model = JaxUnified(jcommon.resolve_encoder_config("tiny"),
                       stop_on_pooled=True)
    ids = jnp.ones((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(SEED), ids, ids,
                        method=model.encode_qsp)
    # a wider stop head spreads the random model's stop probabilities
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * WIDEN if "stop_head" in jax.tree_util.keystr(path)
        else x, params)
    ckpt = str(tmp / "unified.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                unified_flax_to_ckpt(jax.device_get(params)["params"]).items()},
               ckpt)
    flags = ["--tokenizer", "hash", "--model-name", "tiny", "--checkpoint",
             ckpt, "--unified", "--batch-size", "128", "--chunk-rows", "128",
             "--max-c-len", "64", "--index-dtype", "float32"]
    dirs = {"jax": str(tmp / "jax"), "torch": str(tmp / "torch")}
    encode_corpus.main([str(tmp / "corpus.jsonl"), dirs["jax"]] + flags)
    tencode.main([str(tmp / "corpus.jsonl"), dirs["torch"], "--device",
                  "cpu"] + flags)
    yield dict(tmp=tmp, ckpt=ckpt, dirs=dirs)
    mp.undo()


def test_encode_corpus_unified_matches_jax(unified_env):
    """tokens.npz, id2doc.json and the index layout bit-equal; the fp32
    rows within atol 1e-5 (the frameworks' fp32 encodes differ by that
    much: summation order)."""
    j, t = unified_env["dirs"]["jax"], unified_env["dirs"]["torch"]
    za, zb = (np.load(os.path.join(d, "tokens.npz")) for d in (j, t))
    assert za.files == zb.files
    for key in za.files:
        np.testing.assert_array_equal(za[key], zb[key], err_msg=key)
    with open(os.path.join(j, "id2doc.json")) as f, \
            open(os.path.join(t, "id2doc.json")) as g:
        assert json.load(f) == json.load(g)
    ja, ta = (np.load(os.path.join(d, "index.npz")) for d in (j, t))
    assert ja.files == ta.files
    for key in ("n_docs", "chunk_rows", "multi_vector", "dtype"):
        assert ja[key] == ta[key], key
    assert str(ja["dtype"]) == "float32"
    np.testing.assert_allclose(ta["payload"], ja["payload"], rtol=0,
                               atol=1e-5)


def _between(values, share):
    """A threshold halfway between two adjacent values, with about
    ``share`` of them above it (the widest gap within 15 points)."""
    p = np.sort(np.asarray(values).ravel())[::-1]
    n = len(p)
    lo = max(1, int(round((share - 0.15) * n)))
    hi = min(n - 1, int(round((share + 0.15) * n)))
    m = max(range(lo, hi + 1), key=lambda i: p[i - 1] - p[i])
    assert p[m - 1] - p[m] > 1e-4, "stop probabilities tie"
    return float((p[m - 1] + p[m]) / 2)


def _strip_stop_probs(rows):
    return [{k: v for k, v in r.items() if k != "stop_probs"} for r in rows]


def test_eval_unified_stop_skip_matches_jax(unified_env, monkeypatch):
    tmp = unified_env["tmp"]
    base = [str(tmp / "qas.jsonl"), unified_env["dirs"]["jax"],
            "--tokenizer", "hash", "--model-name", "tiny", "--checkpoint",
            unified_env["ckpt"], "--unified", "--beam-size", "4", "--topk",
            "4", "--batch-size", "8", "--max-q-sp-len", "96",
            "--hop2-buckets", "32,48,64,96", "--hop2-tile-fracs",
            "0.25,0.375,0.25,0.125"]
    _, _, probe = _run(jretr.main, jbeam.BeamSearcher, base, monkeypatch)
    p_top = np.concatenate([r["stop_probs"][np.arange(len(r["stop_probs"])),
                                            r["hop1_cand_scores"].argmax(1)]
                            for r in probe])
    top = np.concatenate([r["top_stop_probs"] for r in probe])
    thresholds = ["--stop-threshold", str(_between(top, 0.5)),
                  "--stop-skip", str(_between(p_top, 0.6))]
    for name, extra in (("unified", thresholds[:2]),
                        ("stop_skip", thresholds),
                        ("stop_skip_prune", thresholds
                         + ["--hop2-prune-margin", "auto:0.9"])):
        args = base + extra
        jpath, tpath = (str(tmp / f"{p}_{name}.jsonl") for p in "jt")
        (jagg, jout), _, jseen = _run(jretr.main, jbeam.BeamSearcher,
                                      args + ["--save-path", jpath],
                                      monkeypatch)
        (tagg, tout), _, tseen = _run(
            tretr.main, tbeam.BeamSearcher,
            args + ["--save-path", tpath, "--device", "cpu"], monkeypatch)
        assert tagg == jagg and len(tout) == len(jout) == 16
        assert _strip_stop_probs(tout) == _strip_stop_probs(jout)
        np.testing.assert_allclose([r["stop_probs"] for r in tout],
                                   [r["stop_probs"] for r in jout],
                                   rtol=1e-5, atol=1e-6)
        _check_results(jseen, tseen, 4)
        sizes = {len(c) for r in tout for c in r["candidate_chains"]}
        assert sizes == {1, 2}, (name, sizes)
        if name != "unified":
            # stopped questions' other rows were skipped (stop prob 0.5)
            assert any((r["stop_probs"] == 0.5).any() for r in tseen)
