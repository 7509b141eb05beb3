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
JSON equal.

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
from multihop_dense_retrieval_tpu.search import beam as jbeam
from multihop_dense_retrieval_tpu_torch.cli import common as tcommon
from multihop_dense_retrieval_tpu_torch.cli import eval_mhop_fever as tfever
from multihop_dense_retrieval_tpu_torch.cli import eval_mhop_retrieval as tretr
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.models import \
    retriever_state_dict_from_jax
from multihop_dense_retrieval_tpu_torch.ops import mips as tm
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
    assert len(jseen) == len(tseen) > 0
    for j, t in zip(jseen, tseen):
        assert set(j) == set(t)
        for key in ("hop1_ids", "hop2_ids", "hop1_cand_ids", "pca_cert1",
                    "pca_cert2"):
            if key in j:
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        for key in ("path_scores", "hop1_cand_scores"):
            np.testing.assert_allclose(t[key], j[key], rtol=0,
                                       atol=SCORE_TOL, err_msg=key)
            diff = np.abs(t[key] - j[key])
            gaps = -np.diff(j[key], axis=1)
            assert (gaps > diff[:, :-1] + diff[:, 1:]).all(), key
        assert j["path_scores"].shape[1] == topk


FEVER = {"bf16": ("bf16", []), "bf16_pca": ("bf16", ["--pca"]),
         "int8": ("int8", [])}


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
    # unless the prefilter served it
    assert tcalls == ([] if extra else [(8, 32)] * len(tseen))
    if extra:
        assert any(r["pca_cert2"].any() for r in tseen)


RETRIEVAL = {"bf16_pca": ("bf16", ["--pca"]), "int8": ("int8", [])}


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
    (tagg, tout), _, tseen = _run(
        tretr.main, tbeam.BeamSearcher,
        args + ["--save-path", tpath, "--device", "cpu"], monkeypatch)
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
    base = [str(tmp_path / "q.jsonl"), str(tmp_path), "--device", "cpu"]
    for flags in (["--hnsw"], ["--unified"], ["--stop-skip", "0.5"],
                  ["--index-shards", "2"], ["--hop2-prune-margin", "auto"]):
        with pytest.raises(NotImplementedError, match="ROADMAP item"):
            tretr.main(base + flags)
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        tfever.main(base + ["--hop2-prune-margin", "0.5"])
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
