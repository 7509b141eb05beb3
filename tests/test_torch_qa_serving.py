"""The port's question-answering CLIs against the JAX package's:
``cli/end2end``, ``cli/demo --question``, the ``cli/serve`` endpoints
(tests/test_serve.py's cases, on an ephemeral port) and ``cli/parity``
(tests/test_parity_cli.py's cases).

Set-up, shared by the module (``--dist loadfile`` keeps it on one worker):
a 32-doc synthetic corpus encoded by the JAX package's
``cli/encode_corpus`` into an fp32 index (an fp32 index keeps the query
vectors, equal to 1e-5 across the frameworks, off bf16 rounding
boundaries), and two reference-format ``.pt`` checkpoints written from
JAX parameters through the port's ``convert``: a tiny retriever and a
tiny reader, their kernels scaled by 4 to spread the random models'
scores.  Both packages load the same files; the tiny retriever runs in
fp32 in both (the CLIs' own default is bf16), the tiny reader is fp32.

Answers, supporting facts, chains and EM/F1 must be equal; timings are
not compared.

The variable-hop runs (``--unified``) use a tiny UnifiedRetriever written
as a reference-layout ``.pt`` and its own fp32 index directory (the JAX
package's ``encode_corpus --unified``); ``--stop-threshold`` lies halfway
between two adjacent stop probabilities of a JAX run, so some chains are
one passage and none sits on the threshold.
"""

import argparse
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import common as jcommon
from multihop_dense_retrieval_tpu.cli import demo as jdemo
from multihop_dense_retrieval_tpu.cli import encode_corpus
from multihop_dense_retrieval_tpu.cli import end2end as jend2end
from multihop_dense_retrieval_tpu.cli import eval_mhop_retrieval as jretr
from multihop_dense_retrieval_tpu.cli import parity as jparity
from multihop_dense_retrieval_tpu.cli import train_qa as jtrain_qa
from multihop_dense_retrieval_tpu.core.config import \
    EncoderConfig as JaxEncoderConfig
from multihop_dense_retrieval_tpu.models import MhopRetriever as JaxRetriever
from multihop_dense_retrieval_tpu.models import UnifiedRetriever as JaxUnified
from multihop_dense_retrieval_tpu.models.export import unified_flax_to_ckpt
from multihop_dense_retrieval_tpu_torch.cli import common as tcommon
from multihop_dense_retrieval_tpu_torch.cli import demo as tdemo
from multihop_dense_retrieval_tpu_torch.cli import end2end as tend2end
from multihop_dense_retrieval_tpu_torch.cli import parity as tparity
from multihop_dense_retrieval_tpu_torch.cli import serve as tserve
from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
from multihop_dense_retrieval_tpu_torch.models import (
    reader_state_dict_from_jax, retriever_state_dict_from_jax)
from tests import synth

WIDEN = 4.0
PIPE = dict(tokenizer="hash", retriever_model="tiny", reader_model="tiny",
            beam_size=2, topk=2, max_q_len=16, max_q_sp_len=48,
            max_seq_len=96, max_ans_len=6, chunk_rows=16, lam=0.8,
            question="")


def _tiny_fp32(cls):
    return lambda **kw: cls.tiny(vocab_size=50265, max_position_embeddings=514,
                                 **dict(kw, dtype="float32"))


def _widen(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * WIDEN if "kernel" in jax.tree_util.keystr(path)
        else x, params)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(jcommon.MODEL_PRESETS, "tiny", _tiny_fp32(JaxEncoderConfig))
    mp.setitem(tcommon.MODEL_PRESETS, "tiny", _tiny_fp32(EncoderConfig))
    tmp = tmp_path_factory.mktemp("torch_qa")
    rng = np.random.RandomState(0)
    docs = synth.make_corpus(rng, 32)
    synth.write_jsonl(tmp / "corpus.jsonl", docs)
    rows = synth.make_mhop_rows(rng, docs, n_rows=6)
    for i, r in enumerate(rows):
        r["answer"] = [docs[i]["text"].split()[0]] if i % 2 else ["yes"]
    synth.write_jsonl(tmp / "qas.jsonl", rows)

    rmodel = JaxRetriever(jcommon.resolve_encoder_config("tiny"))
    rparams = _widen(rmodel.init(jax.random.PRNGKey(1),
                                 jnp.ones((1, 8), jnp.int32),
                                 jnp.ones((1, 8), jnp.int32),
                                 method=rmodel.encode_seq))
    retriever = str(tmp / "retriever.pt")
    torch.save(retriever_state_dict_from_jax(jax.device_get(rparams)),
               retriever)
    _, _, qparams = jtrain_qa.init_reader("tiny", "", sp_pred=True, seed=2)
    reader = str(tmp / "reader.pt")
    torch.save(reader_state_dict_from_jax(jax.device_get(_widen(qparams))),
               reader)
    index_dir = str(tmp / "index")
    encode_corpus.main([str(tmp / "corpus.jsonl"), index_dir,
                        "--tokenizer", "hash", "--model-name", "tiny",
                        "--checkpoint", retriever, "--batch-size", "16",
                        "--chunk-rows", "16", "--max-c-len", "32",
                        "--index-dtype", "float32"])
    umodel = JaxUnified(jcommon.resolve_encoder_config("tiny"),
                        stop_on_pooled=True)
    uparams = _widen(umodel.init(jax.random.PRNGKey(3),
                                 jnp.ones((1, 8), jnp.int32),
                                 jnp.ones((1, 8), jnp.int32),
                                 method=umodel.encode_qsp))
    unified = str(tmp / "unified.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                unified_flax_to_ckpt(jax.device_get(uparams)["params"])
                .items()}, unified)
    unified_dir = str(tmp / "unified_index")
    encode_corpus.main([str(tmp / "corpus.jsonl"), unified_dir,
                        "--tokenizer", "hash", "--model-name", "tiny",
                        "--checkpoint", unified, "--unified",
                        "--batch-size", "16", "--chunk-rows", "16",
                        "--max-c-len", "32", "--index-dtype", "float32"])
    yield dict(tmp=tmp, index_dir=index_dir, retriever=retriever,
               reader=reader, rows=rows, unified=unified,
               unified_dir=unified_dir)
    mp.undo()


def _e2e_args(env, *extra):
    return [str(env["tmp"] / "qas.jsonl"), env["index_dir"],
            "--tokenizer", "hash", "--retriever-model", "tiny",
            "--retriever-checkpoint", env["retriever"],
            "--reader-model", "tiny", "--reader-checkpoint", env["reader"],
            "--beam-size", "2", "--topk", "2", "--batch-size", "4",
            "--max-q-len", "24", "--max-q-sp-len", "64",
            "--max-seq-len", "128", "--chunk-rows", "16",
            "--max-ans-len", "8", *extra]


def _lines(path):
    with open(path) as f:
        return [json.loads(l) for l in f]


@pytest.mark.parametrize("extra", [[], ["--rank-topm", "1", "--rank-width",
                                        "64"], ["--reader-fp32-scores"]])
def test_end2end_matches_jax(env, extra, capsys):
    tmp = env["tmp"]
    exp = jend2end.main(_e2e_args(env, *extra, "--save-path",
                                  str(tmp / "j.jsonl")))
    got = tend2end.main(_e2e_args(env, *extra, "--device", "cpu",
                                  "--save-path", str(tmp / "t.jsonl")))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "n"] == 6
    for key in ("n", "answer_em", "answer_f1"):
        assert got[key] == exp[key], key
    assert got["answer_em"] is not None
    assert _lines(tmp / "t.jsonl") == _lines(tmp / "j.jsonl")


def test_end2end_refuses_unported_options(env, capsys):
    """end2end has no --index-shards, as the JAX CLI has none (it loads
    its engine without a mesh): both refuse the flag as an unknown
    argument, before any work (--unified is served below)."""
    for main, extra in ((jend2end.main, ()), (tend2end.main,
                                              ("--device", "cpu"))):
        with pytest.raises(SystemExit) as err:
            main(_e2e_args(env, *extra, "--unified", "--index-shards", "2"))
        assert err.value.code == 2
        assert "unrecognized arguments: --index-shards 2" in \
            capsys.readouterr().err


@pytest.fixture(scope="module")
def stop_threshold(env):
    """Halfway between two adjacent top_stop_probs of the JAX engine at
    end2end's settings, with about half of the chains above it."""
    _, rows = jretr.main([str(env["tmp"] / "qas.jsonl"), env["unified_dir"],
                          "--tokenizer", "hash", "--model-name", "tiny",
                          "--checkpoint", env["unified"], "--unified",
                          "--beam-size", "2", "--topk", "2",
                          "--batch-size", "4", "--max-q-len", "24",
                          "--max-q-sp-len", "64", "--chunk-rows", "16"])
    p = np.sort([x for r in rows for x in r["stop_probs"]])[::-1]
    m = max(range(3, len(p) - 3), key=lambda i: p[i - 1] - p[i])
    assert p[m - 1] - p[m] > 1e-4, "stop probabilities tie"
    return str((p[m - 1] + p[m]) / 2)


def _unified_args(env, thr):
    return ["--retriever-checkpoint", env["unified"], "--unified",
            "--stop-threshold", thr]


def test_end2end_unified_matches_jax(env, stop_threshold, monkeypatch):
    """Chains whose stop probability exceeds the threshold reach the
    reader as one passage, in both packages alike."""
    tmp = env["tmp"]
    chains = []
    retrieve = tend2end.retrieve_chains
    monkeypatch.setattr(tend2end, "retrieve_chains", lambda *a, **kw: (
        chains.append(retrieve(*a, **kw)), chains[-1])[1])
    args = [a if a != env["index_dir"] else env["unified_dir"]
            for a in _e2e_args(env)]
    args += _unified_args(env, stop_threshold)
    exp = jend2end.main(args + ["--save-path", str(tmp / "ju.jsonl")])
    got = tend2end.main(args + ["--device", "cpu", "--save-path",
                                str(tmp / "tu.jsonl")])
    for key in ("n", "answer_em", "answer_f1"):
        assert got[key] == exp[key], key
    assert _lines(tmp / "tu.jsonl") == _lines(tmp / "ju.jsonl")
    sizes = {len(c) for q in chains[0] for c in q}
    assert sizes == {1, 2}, sizes


def _demo_args(env, *extra):
    return [env["index_dir"], "--tokenizer", "hash",
            "--retriever-model", "tiny", "--retriever-checkpoint",
            env["retriever"], "--reader-model", "tiny",
            "--reader-checkpoint", env["reader"], "--beam-size", "2",
            "--topk", "2", "--max-q-len", "16", "--max-q-sp-len", "48",
            "--max-seq-len", "96", "--max-ans-len", "6", "--chunk-rows",
            "16", *extra]


def _strip_times(out):
    return {k: v for k, v in out.items() if not k.endswith("_s")}


@pytest.mark.parametrize("extra", [[], ["--rank-topm", "1", "--rank-width",
                                        "48"]])
def test_demo_question_matches_jax(env, extra, capsys):
    q = ["--question", "which thing links w3 w10?"]
    exp = jdemo.main(_demo_args(env, *extra, *q))
    got = tdemo.main(_demo_args(env, *extra, *q, "--device", "cpu"))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _strip_times(printed) == _strip_times(got)
    assert _strip_times(got) == _strip_times(exp)
    assert isinstance(got["answer"], str) and len(got["chains"]) == 2
    assert got["retrieval_s"] > 0 and got["reading_s"] > 0


def test_demo_unified_matches_jax(env, stop_threshold, capsys):
    extra = ["--question", "which thing links w3 w10?",
             *_unified_args(env, stop_threshold)]
    args = [a if a != env["index_dir"] else env["unified_dir"]
            for a in _demo_args(env, *extra)]
    exp = jdemo.main(args)
    got = tdemo.main(args + ["--device", "cpu"])
    assert _strip_times(got) == _strip_times(exp)
    assert len(got["chains"]) == 2


# ---- the HTTP server ------------------------------------------------------


def _namespace(env, **kw):
    return argparse.Namespace(**dict(
        PIPE, index_dir=env["index_dir"],
        retriever_checkpoint=env["retriever"],
        reader_checkpoint=env["reader"], **kw))


@pytest.fixture(scope="module")
def served(env):
    pipe = tdemo.DemoPipeline(_namespace(env, device="cpu"))
    srv = tserve.make_server(pipe, "127.0.0.1", 0, max_batch=4,
                             batch_wait_ms=25)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}", pipe, \
        jdemo.DemoPipeline(_namespace(env))
    srv.shutdown()
    srv.engine_worker.stop()
    t.join(timeout=30)
    assert not t.is_alive() and not srv.engine_worker.is_alive()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_healthz(served):
    url, pipe, _ = served
    code, out = _get(f"{url}/healthz")
    assert code == 200 and out["status"] == "ok"
    assert out["n_docs"] == pipe.searcher.index.n_docs == 32


def test_answer_and_retrieve_match_jax(served):
    url, _, jpipe = served
    for q in ("what links things?", "which thing links w3 w10?"):
        code, out = _post(f"{url}/answer", {"question": q})
        assert code == 200
        exp = jpipe.answer_batch([q], pad_to=4)[0]
        assert _strip_times(out) == _strip_times(exp)
        assert isinstance(out["answer"], str) and len(out["chains"]) == 2
        code, out = _post(f"{url}/retrieve", {"question": q})
        assert code == 200 and "reading_s" not in out
        assert out["chains"] == jpipe.retrieve_batch([q], pad_to=4)[0][
            "chains"]


def test_retrieve_topk_and_errors(served):
    url = served[0]
    code, out = _post(f"{url}/retrieve",
                      {"question": "another question?", "topk": 1})
    assert code == 200 and len(out["chains"]) == 1
    code, out = _post(f"{url}/retrieve",
                      {"question": "another question?", "topk": 50})
    assert code == 200 and out["topk_capped"] == 2
    code, out = _post(f"{url}/retrieve", {"question": "x?", "topk": 0})
    assert code == 400
    code, out = _post(f"{url}/answer", {})
    assert code == 400 and "question" in out["error"]
    assert _post(f"{url}/nope", {"question": "x"})[0] == 404
    assert _post(f"{url}/nope", {})[0] == 404
    code, out = _post(f"{url}/answer", [1, 2, 3])
    assert code == 400 and "object" in out["error"]
    assert _post(f"{url}/delete_doc", {"doc_id": "not-a-number"})[0] == 400


def test_live_document_updates_match_jax(served):
    """/add_doc (the index grows: 32 docs fill their two 16-row chunks)
    and /delete_doc on the running server: the same ids, moves and
    chains as the JAX pipeline given the same updates; the added
    document's own vector retrieves it at hop 1."""
    url, pipe, jpipe = served
    doc = {"title": "brand new topic",
           "text": "some fresh words about the new topic"}
    code, out = _post(f"{url}/add_doc", doc)
    assert code == 200
    assert out["doc_id"] == jpipe.add_document(doc["title"], doc["text"]) \
        == 32
    assert out["n_docs"] == 33 and pipe.searcher.index.vectors.shape[0] == 48
    vec = pipe.encode_passage(doc["title"], doc["text"])
    _, ids = pipe.searcher._mips(torch.from_numpy(vec), 1, pca=False)[:2]
    assert int(ids[0, 0]) == 32
    q = "brand new topic?"
    code, out = _post(f"{url}/retrieve", {"question": q})
    assert code == 200
    assert out["chains"] == jpipe.retrieve_batch([q], pad_to=4)[0]["chains"]

    code, out = _post(f"{url}/delete_doc", {"doc_id": 5})
    assert code == 200 and out == {"moved_doc_id": 32, "n_docs": 32}
    assert jpipe.delete_document(5) == 32
    assert pipe.corpus.docs == jpipe.corpus.docs
    for q in (q, "what links things?"):
        code, out = _post(f"{url}/answer", {"question": q})
        assert code == 200
        assert _strip_times(out) == _strip_times(
            jpipe.answer_batch([q], pad_to=4)[0])
    assert _post(f"{url}/delete_doc", {"doc_id": 10**6})[0] == 400
    assert _post(f"{url}/add_doc", {"text": "no title"})[0] == 400
    code, out = _post(f"{url}/retrieve", {"question": "still alive?"})
    assert code == 200 and len(out["chains"]) == 2


def test_concurrent_requests_micro_batch(served):
    url = served[0]
    before = _get(f"{url}/healthz")[1]
    results = [None] * 6

    def fire(i):
        results[i] = _post(f"{url}/answer",
                           {"question": f"concurrent question {i}?"})

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(code == 200 and isinstance(out["answer"], str)
               for code, out in results)
    after = _get(f"{url}/healthz")[1]
    assert after["questions_run"] - before["questions_run"] == 6
    assert after["batches_run"] - before["batches_run"] <= 6


class _FakePipe:
    def __init__(self, fail_on=None):
        self.batches, self.adds, self.fail_on = [], [], fail_on
        self.searcher = type("S", (), {
            "index": type("I", (), {"n_docs": 101})()})()

    def answer_batch(self, qs, pad_to=None):
        self.batches.append(list(qs))
        if self.fail_on in qs:
            raise RuntimeError("engine fault")
        return [{"answer": q, "chains": [], "supporting": [],
                 "retrieval_s": 0.0, "reading_s": 0.0} for q in qs]

    def retrieve_batch(self, qs, pad_to=None):
        self.batches.append(list(qs))
        return [{"chains": [], "retrieval_s": 0.0} for _ in qs]

    def add_document(self, title, text):
        self.adds.append(title)
        return 100 + len(self.adds)


def test_engine_worker_batches_and_serializes_updates():
    """Pre-queued questions form one batch; an update between questions
    flushes the batch first and runs in arrival order; a failing batch
    fails its own requests only; stop() ends the thread."""
    pipe = _FakePipe(fail_on="bad")
    w = tserve.EngineWorker(pipe, max_batch=8, batch_wait_ms=50)
    futs = [w.submit("answer", {"question": f"q{i}"}) for i in range(5)]
    w.start()
    assert [f.result(timeout=10)["answer"] for f in futs] == \
        [f"q{i}" for i in range(5)]
    assert pipe.batches == [["q0", "q1", "q2", "q3", "q4"]]

    f1 = w.submit("answer", {"question": "a"})
    fu = w.submit("add", {"title": "t", "text": "x"})
    f2 = w.submit("answer", {"question": "b"})
    assert fu.result(timeout=10)["doc_id"] == 101
    assert f1.result(timeout=10)["answer"] == "a"
    assert f2.result(timeout=10)["answer"] == "b"
    assert pipe.batches[1] == ["a"] and ["b"] in pipe.batches[2:]

    bad = w.submit("answer", {"question": "bad"})
    with pytest.raises(RuntimeError, match="engine fault"):
        bad.result(timeout=10)
    assert w.submit("answer", {"question": "c"}).result(timeout=10)[
        "answer"] == "c"
    w.stop(timeout=10)
    assert not w.is_alive()


# ---- the parity CLI -------------------------------------------------------


def test_parity_tables_match_jax():
    assert tparity.EXPECTED_RETRIEVAL == jparity.EXPECTED_RETRIEVAL
    assert tparity.EXPECTED_QA == jparity.EXPECTED_QA
    assert tparity.EXPECTED_RETRIEVAL["overall"]["n"] == 7405
    assert abs(tparity.EXPECTED_QA["joint_f1"] - 0.6631669237532106) < 1e-12


def test_parity_missing_artifacts_exit_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        tparity.main(["--data-dir", str(tmp_path)])
    assert e.value.code == 2
    out = capsys.readouterr().out
    for name in ["checkpoint", "wiki_index", "id2doc", "qas_val",
                 "download_hotpot"]:
        assert name in out


def test_parity_compare_block_matches_jax():
    exp = {"n": 7405, "avg_pr": 0.8428089128966915,
           "avg_p_em": 0.6592842673869007}
    for got in ({"n": 7405, "avg_pr": 0.8432, "avg_p_em": 0.70}, {},
                {"n": 7404, "avg_pr": 0.83, "avg_p_em": 0.66}):
        assert tparity.compare_block(got, exp, 0.01, "o") == \
            jparity.compare_block(got, exp, 0.01, "o")


def test_parity_prepare_index_dir_matches_jax(tmp_path):
    import logging

    from multihop_dense_retrieval_tpu.data.tokenization import \
        HashTokenizer as JaxHashTokenizer
    from multihop_dense_retrieval_tpu_torch.data.tokenization import \
        HashTokenizer

    rng = np.random.RandomState(3)
    id2doc = {str(i): [f"Title {i}", f"text of document {i} body", True]
              for i in range(37)}
    (tmp_path / "wiki_id2doc.json").write_text(json.dumps(id2doc))
    np.save(tmp_path / "wiki_index.npy", rng.randn(37, 16).astype(np.float32))
    paths = {"id2doc": str(tmp_path / "wiki_id2doc.json"),
             "wiki_index": str(tmp_path / "wiki_index.npy")}
    log = logging.getLogger("t")
    jparity.prepare_index_dir(paths, str(tmp_path / "j"),
                              JaxHashTokenizer(vocab_size=512), 32, log)
    for _ in range(2):                       # the second call reuses it
        tparity.prepare_index_dir(paths, str(tmp_path / "t"),
                                  HashTokenizer(vocab_size=512), 32, log,
                                  device="cpu")
    for name in ("index.npz", "tokens.npz"):
        j, t = np.load(tmp_path / "j" / name), np.load(tmp_path / "t" / name)
        assert set(j.files) == set(t.files)
        for key in j.files:
            np.testing.assert_array_equal(t[key], j[key])
    assert json.loads((tmp_path / "t" / "id2doc.json").read_text()) == \
        json.loads((tmp_path / "j" / "id2doc.json").read_text())


def test_parity_qa_block_matches_jax(env, tmp_path):
    """The QA block through the port's predict: the same metrics as the
    JAX block on the same checkpoint and chains file."""
    import logging
    from types import SimpleNamespace

    rows = []
    for i in range(3):
        sp = [{"title": f"G{i}a", "sents": ["the answer is paris ."],
               "sp_sent_ids": [0]},
              {"title": f"G{i}b", "sents": ["another sentence here ."],
               "sp_sent_ids": []}]
        neg = [{"title": f"N{i}a", "sents": ["noise text one ."]},
               {"title": f"N{i}b", "sents": ["noise text two ."]}]
        rows.append({"question": f"where is it {i}?", "_id": f"q{i}",
                     "answer": ["paris"], "type": "bridge", "sp": sp,
                     "candidate_chains": [sp, neg]})
    pred = tmp_path / "retrieved_sp.json"
    pred.write_text(json.dumps(rows))
    kw = dict(tokenizer="hash", qa_checkpoint=env["reader"],
              qa_predict_file=str(pred), qa_model="tiny")
    log = logging.getLogger("t")
    exp = jparity.run_qa_block(SimpleNamespace(**kw), log)
    got = tparity.run_qa_block(SimpleNamespace(device="cpu", **kw), log)
    assert set(got) == set(tparity.EXPECTED_QA)
    assert got == exp


def test_serve_unified_answers(env, stop_threshold):
    """serve --unified: the server starts over the unified pipeline and
    answers as the JAX pipeline does."""
    ns = dict(PIPE, index_dir=env["unified_dir"],
              retriever_checkpoint=env["unified"],
              reader_checkpoint=env["reader"], unified=True,
              stop_threshold=float(stop_threshold))
    pipe = tdemo.DemoPipeline(argparse.Namespace(device="cpu", **ns))
    jpipe = jdemo.DemoPipeline(argparse.Namespace(**ns))
    srv = tserve.make_server(pipe, "127.0.0.1", 0, max_batch=4,
                             batch_wait_ms=25)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}"
        sizes = set()
        for q in ("what links things?", "which thing links w3 w10?",
                  "another question about w7?"):
            code, out = _post(f"{url}/answer", {"question": q})
            assert code == 200
            assert _strip_times(out) == _strip_times(
                jpipe.answer_batch([q], pad_to=4)[0])
            sizes.update(len(c) for c in out["chains"])
        assert sizes <= {1, 2}
    finally:
        srv.shutdown()
        srv.engine_worker.stop()
        t.join(timeout=30)
    assert not t.is_alive() and not srv.engine_worker.is_alive()
