"""The port's single-hop ``cli/eval_retrieval`` against the JAX package's,
on index directories that the JAX ``cli/encode_corpus`` builds from one
600-doc synthetic corpus (``tests/synth.py``), with the same weights.

Set-up, shared by the module (``--dist loadfile`` keeps it on one worker):
  * one tiny retriever, initialised in JAX (its kernels widened 4x, as in
    ``tests/test_torch_cli.py``, so the random model's scores spread) and
    written as a reference ``.pt`` with the port's
    ``retriever_state_dict_from_jax``; both CLIs load it with
    ``--checkpoint``;
  * the ``tiny`` preset runs in fp32 in both packages (fp32 encodes agree
    to 1e-5, tests/test_torch_encoder.py);
  * three directories at ``--chunk-rows 128`` (600 rows pad to 640, five
    chunks): bf16; int8 with a 32-dim PCA prefilter over 128-row candidate
    chunks; bf16 with two vectors a document (``--multi-vector 2``);
  * 13 questions whose answers are planted in 40 documents each: list
    and bare-string answers, ``sp`` titles on some rows, a FEVER ``claim``
    row, a trailing "?" on most; batch 8, so the last batch is padded.

The port runs with ``--device cpu`` (each kernel's plain twin): at
``--topk 20`` its bf16 and int8 searches take the two-phase route (B=8,
k=20, 128-row chunks), at ``--topk 5`` the scans; ``--pca`` runs kernels
3 then 4's twins, at top 20 (no query certifies) and at top 1 (11 of 13
do).  The JAX package takes its XLA tier on the CPU, and its
PCA search in interpret mode.  Both are exact, so the metrics JSON must be
equal apart from ``qps``, the ``--save-path`` dumps equal row for row, and
a ``--pca`` run's certificates equal query for query.
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
from multihop_dense_retrieval_tpu.cli import eval_retrieval as jeval
from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxRetriever
from multihop_dense_retrieval_tpu.ops import mips as jmips
from multihop_dense_retrieval_tpu_torch.cli import common as tcommon
from multihop_dense_retrieval_tpu_torch.cli import eval_retrieval as teval
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.models import \
    retriever_state_dict_from_jax
from tests import synth

SEED = 3
WIDEN = 4.0
N_DOCS = 600


def _tiny_fp32(cls):
    return lambda **kw: cls.tiny(vocab_size=50265, max_position_embeddings=514,
                                 **dict(kw, dtype="float32"))


def _questions(rng, docs):
    """Questions whose answers are phrases planted in 40 documents each
    (so that a random model's top 20 holds one about three times in four)."""
    rows = []
    for i in range(13):
        for d in rng.choice(N_DOCS, 40, replace=False):
            docs[d]["text"] = f"{docs[d]['text']} answer{i} zone{i} ."
        row = {"question": f"{synth.rand_text(rng, 3, 10)} answer{i}?",
               "answer": [f"Answer{i} zone{i}", "never-said"]}
        if i % 3 == 0:
            row["answer"] = f"answer{i}"            # a bare string
        if i % 2 == 0:
            row["sp"] = [f"Title {t}" for t in rng.choice(N_DOCS, 2)]
        if i == 5:
            row = {"claim": row["question"][:-1], "answer": row["answer"]}
        rows.append(row)
    return rows


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(jcommon.MODEL_PRESETS, "tiny", _tiny_fp32(JaxEncoderConfig))
    mp.setitem(tcommon.MODEL_PRESETS, "tiny", _tiny_fp32(EncoderConfig))
    tmp = tmp_path_factory.mktemp("torch_eval_retrieval")
    rng = np.random.RandomState(SEED)
    docs = synth.make_corpus(rng, N_DOCS)
    qas = _questions(rng, docs)
    synth.write_jsonl(tmp / "corpus.jsonl", docs)
    synth.write_jsonl(tmp / "qas.jsonl", qas)
    synth.write_jsonl(tmp / "strings.jsonl",
                      [dict(r, answer=r["answer"] if isinstance(
                          r["answer"], str) else r["answer"][0])
                       for r in qas])

    model = JaxRetriever(jcommon.resolve_encoder_config("tiny"))
    params = model.init(jax.random.PRNGKey(SEED), jnp.ones((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32), method=model.encode_seq)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * WIDEN if "kernel" in jax.tree_util.keystr(path)
        else x, params)
    ckpt = str(tmp / "retriever.pt")
    torch.save(retriever_state_dict_from_jax(jax.device_get(params)), ckpt)

    dirs = {}
    for name, flags in (("bf16", ["--index-dtype", "bfloat16"]),
                        ("int8_pca", ["--index-dtype", "int8",
                                      "--pca-dims", "32",
                                      "--pca-cand-rows", "128"]),
                        ("multi_vector", ["--index-dtype", "bfloat16",
                                          "--multi-vector", "2"])):
        dirs[name] = str(tmp / name)
        encode_corpus.main([str(tmp / "corpus.jsonl"), dirs[name],
                            "--tokenizer", "hash", "--model-name", "tiny",
                            "--checkpoint", ckpt, "--batch-size", "200",
                            "--chunk-rows", "128", "--max-c-len", "48"]
                           + flags)
    yield dict(tmp=tmp, ckpt=ckpt, dirs=dirs)
    mp.undo()


def _run(main, args, pca_module, monkeypatch):
    """Run a CLI main; return (its metrics, its stdout's last line parsed,
    the certificates of its PCA searches)."""
    certs = []
    pca = pca_module.mips_topk_pca

    def recording(*a, **kw):
        out = pca(*a, **kw)
        certs.append(np.asarray(out[2]))
        return out

    monkeypatch.setattr(pca_module, "mips_topk_pca", recording)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(args)
    monkeypatch.setattr(pca_module, "mips_topk_pca", pca)
    return ret, json.loads(buf.getvalue().strip().splitlines()[-1]), certs


CASES = {"bf16_two_phase": ("bf16", "qas", ["--topk", "20"]),
         "bf16_scan": ("bf16", "qas", ["--topk", "5"]),
         "int8_exact": ("int8_pca", "qas", ["--topk", "20"]),
         "int8_pca": ("int8_pca", "qas", ["--topk", "20", "--pca",
                                          "--pca-k-chunks", "3"]),
         "int8_pca_top1": ("int8_pca", "qas", ["--topk", "1", "--pca",
                                               "--pca-k-chunks", "3"]),
         "multi_vector": ("multi_vector", "qas", ["--topk", "20"]),
         "string_answers": ("multi_vector", "strings", ["--topk", "10"])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_retrieval_matches_jax(env, case, monkeypatch):
    index, qas, extra = CASES[case]
    tmp = env["tmp"]
    args = [str(tmp / f"{qas}.jsonl"), env["dirs"][index], "--tokenizer",
            "hash", "--model-name", "tiny", "--checkpoint", env["ckpt"],
            "--batch-size", "8", "--max-q-len", "16", "--chunk-rows", "128",
            "--num-workers", "2"] + extra
    jpath, tpath = str(tmp / f"j_{case}.jsonl"), str(tmp / f"t_{case}.jsonl")
    jret, jline, jcerts = _run(jeval.main, args + ["--save-path", jpath],
                               jmips, monkeypatch)
    tret, tline, tcerts = _run(teval.main, args + ["--save-path", tpath,
                                                   "--device", "cpu"],
                               teval, monkeypatch)
    for out in (jret, jline, tret, tline):
        assert out.pop("qps") > 0
    assert tret == jret and tline == jline == jret
    k = int(extra[1])
    assert f"answer_recall@{k}" in tret and f"sp_recall@{k}" in tret
    if k >= 10:               # the planted phrases make recall non-trivial
        assert 0 < tret[f"answer_recall@{k}"] < 1
    jrows = [json.loads(l) for l in open(jpath)]
    trows = [json.loads(l) for l in open(tpath)]
    assert trows == jrows and len(trows) == 13
    assert all(len(r["retrieved"]) == k for r in trows)
    if "--pca" in extra:
        assert len(tcerts) == len(jcerts) == 2
        for j, t in zip(jcerts, tcerts):
            np.testing.assert_array_equal(t[:8], j[:8])
        if k == 1:                      # the top 20 certify no query
            assert 0 < np.concatenate(tcerts)[:13].sum()
    else:
        assert not tcerts and not jcerts


def test_eval_retrieval_refuses_pca_without_prefilter(env):
    with pytest.raises(SystemExit):
        teval.main([str(env["tmp"] / "qas.jsonl"), env["dirs"]["bf16"],
                    "--tokenizer", "hash", "--model-name", "tiny",
                    "--checkpoint", env["ckpt"], "--pca", "--device", "cpu"])
