"""The port's data-preparation and offline-eval copies against the JAX
package's, on the CPU: ``cli/prep`` (its three subcommands and their
alignment errors), ``cli/eval_reranked``, ``data/prep``, ``eval/analysis``,
``utils/docdb``, ``utils/profiling`` and ``utils/text``.

Every comparison is exact: the modules are host-side Python, and the
port's copies must write the same files, return the same dicts and raise
the same errors.  The tokenizer is held to the JAX one (which uses the
third-party ``regex`` package; the port builds its classes from
``unicodedata``) on 2,000 seeded strings drawn from ASCII, Latin-1,
Greek and Cyrillic letters, combining marks, other scripts' digits, CJK,
Zs spaces, Cc/Cf controls and punctuation: code points whose category is
the same in every Unicode version since 5.0, so the two libraries' tables
agree on them.
"""

import glob
import json
import os
import time
import unicodedata

import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu.cli import eval_reranked as jreranked
from multihop_dense_retrieval_tpu.cli import prep as jprep_cli
from multihop_dense_retrieval_tpu.data import prep as jprep
from multihop_dense_retrieval_tpu.eval import analysis as janalysis
from multihop_dense_retrieval_tpu.utils import docdb as jdocdb
from multihop_dense_retrieval_tpu.utils import profiling as jprofiling
from multihop_dense_retrieval_tpu.utils import text as jtext
from multihop_dense_retrieval_tpu_torch import eval as teval_pkg
from multihop_dense_retrieval_tpu_torch import utils as tutils
from multihop_dense_retrieval_tpu_torch.cli import eval_reranked as treranked
from multihop_dense_retrieval_tpu_torch.cli import prep as tprep_cli
from multihop_dense_retrieval_tpu_torch.data import prep as tprep
from multihop_dense_retrieval_tpu_torch.eval import analysis as tanalysis
from multihop_dense_retrieval_tpu_torch.utils import docdb as tdocdb
from multihop_dense_retrieval_tpu_torch.utils import profiling as tprofiling
from multihop_dense_retrieval_tpu_torch.utils import text as ttext
from tests import synth

# ---- cli/prep ---------------------------------------------------------------

RAW = [{
    "_id": "x1", "question": "who did what?", "answer": "alice",
    "type": "bridge",
    "context": [["T1", ["s one.", "s two."]], ["T2", ["s three."]],
    ["T3", ["filler."]]],
    "supporting_facts": [["T1", 1], ["T2", 0]],
}, {
    "_id": "x2", "question": "which is older?", "answer": ["yes"],
    "type": "comparison",
    "context": [["T4", ["mystery a."]], ["T5", ["mystery b.", "more."]]],
    "supporting_facts": [["T4", 0], ["T5", 1], ["T5", 0]],
}, {
    "_id": "x3", "question": "the ambiguous bridge?", "answer": "mystery",
    "type": "bridge",
    "context": [["T6", ["the mystery word."]], ["T7", ["also mystery."]]],
    "supporting_facts": [["T6", 0], ["T7", 0]],
}]
RETRIEVED = [{
    "_id": "x2", "question": "which is older?",
    "candidate_chains": [[{"title": "T4", "text": "mystery a."},
                          {"title": "T5", "text": "mystery b. more."}]],
}, {
    "_id": "x1", "question": "who did what?",
    "candidate_chains": [[{"title": "T1", "text": "s one. s two."},
                          {"title": "T3", "text": "filler."}]],
}]


def _both(tmp_path, argv, name, extra=()):
    """Run both prep CLIs with ``argv``, an OUT file ``name`` and ``extra``
    options; return their two output files' contents."""
    outs = []
    for pkg, main in (("j", jprep_cli.main), ("t", tprep_cli.main)):
        out = tmp_path / f"{pkg}_{name}"
        main(argv + [str(out)] + list(extra))
        outs.append(out.read_text())
    return outs


@pytest.mark.parametrize("links", ["none", "json_map", "jsonl_rows"])
def test_prep_cli_writes_jax_files(tmp_path, links):
    (tmp_path / "raw.json").write_text(json.dumps(RAW))
    synth.write_jsonl(tmp_path / "raw.jsonl", RAW)
    synth.write_jsonl(tmp_path / "retr.jsonl", RETRIEVED)
    # add-sp-label from a JSON array and from JSONL (load_json_flex)
    for raw in ("raw.json", "raw.jsonl"):
        j, t = _both(tmp_path, ["add-sp-label", str(tmp_path / raw),
                                str(tmp_path / "retr.jsonl")], "sp.jsonl")
        assert t == j and len(t.splitlines()) == 2
    rows = [json.loads(l) for l in t.splitlines()]
    assert {s["title"]: s["sp_sent_ids"] for s in rows[0]["sp"]} == \
        {"T4": [0], "T5": [1, 0]}

    extra = []
    if links == "json_map":
        (tmp_path / "links").write_text(json.dumps({"T7": ["T6"]}))
        extra = ["--linked-abstracts", str(tmp_path / "links")]
    elif links == "jsonl_rows":
        synth.write_jsonl(tmp_path / "links", [
            {"title": "T7", "hyperlinks": ["T6"]},
            {"title": "T1", "linked": ["T2"]}])
        extra = ["--linked-abstracts", str(tmp_path / "links")]
    j, t = _both(tmp_path, ["hotpot-to-mhop", str(tmp_path / "raw.json")],
                 "mhop.jsonl", extra)
    assert t == j
    bridge = json.loads(t.splitlines()[2])["bridge"]
    assert bridge == ("T7" if links == "none" else "T6")

    (tmp_path / "id2doc.json").write_text(json.dumps(
        {"abc": ["T1", "text", True], "def": ["T2", "text", True]}))
    j, t = _both(tmp_path, ["index-id-map", str(tmp_path / "id2doc.json")],
                 "idmap.json")
    assert t == j and json.loads(t) == {"0": "abc", "1": "def"}


ALIGNMENT = {
    "absent": ([RAW[0]], [{"question": "unrelated?", "candidate_chains": []}]),
    "duplicate": ([RAW[0], RAW[0]], RETRIEVED[1:]),
    "missing_title": ([dict(RAW[0], supporting_facts=[["T1", 0],
                                                      ["GONE", 0]])],
                      RETRIEVED[1:]),
}


@pytest.mark.parametrize("case", sorted(ALIGNMENT))
def test_prep_cli_alignment_errors_match_jax(tmp_path, case):
    raw, retrieved = ALIGNMENT[case]
    (tmp_path / "raw.json").write_text(json.dumps(raw))
    synth.write_jsonl(tmp_path / "retr.jsonl", retrieved)
    argv = ["add-sp-label", str(tmp_path / "raw.json"),
            str(tmp_path / "retr.jsonl"), str(tmp_path / "o.jsonl")]
    with pytest.raises(ValueError) as jerr:
        jprep_cli.main(argv)
    with pytest.raises(ValueError) as terr:
        tprep_cli.main(argv)
    assert str(terr.value) == str(jerr.value)


def test_data_prep_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    titles = [f"T{i}" for i in range(6)]
    for _ in range(300):
        pair = list(rng.choice(titles, 2, replace=False))
        title2doc = {t: synth.rand_text(rng, 1, 4) for t in titles}
        links = {t: list(rng.choice(titles, rng.randint(3), replace=False))
                 for t in titles}
        answer = synth.rand_text(rng, 1, 2)
        assert tprep.pick_bridge(links, title2doc, pair, answer) == \
            jprep.pick_bridge(links, title2doc, pair, answer)
    assert tprep.hotpot_to_mhop_rows(RAW, {"T7": ["T6"]}) == \
        jprep.hotpot_to_mhop_rows(RAW, {"T7": ["T6"]})
    sents = {t: s for r in RAW for t, s in r["context"]}
    assert tprep.add_sp_labels(RAW[:2], RETRIEVED[::-1], sents) == \
        jprep.add_sp_labels(RAW[:2], RETRIEVED[::-1], sents)
    with pytest.raises(ValueError, match="not in title2sents"):
        tprep.add_sp_labels(RAW[:1], RETRIEVED[1:], {"T1": ["x"]})
    (tmp_path / "id2doc.json").write_text(json.dumps({"a": 1, "b": 2}))
    jprep.gen_index_id_map(str(tmp_path / "id2doc.json"), str(tmp_path / "j"))
    tprep.gen_index_id_map(str(tmp_path / "id2doc.json"), str(tmp_path / "t"))
    assert (tmp_path / "t").read_text() == (tmp_path / "j").read_text()


# ---- cli/eval_reranked --------------------------------------------------------

RERANKED = {
    # tests/test_more_cli.py::test_eval_reranked_cli
    "lists": ([{"_id": "q0", "pred_answer": "paris", "pred_sp": [["A", 0]]},
               {"_id": "q1", "pred_answer": "wrong", "pred_sp": []}],
              [{"_id": "q0", "answer": ["Paris"], "type": "bridge",
                "sp_gold": [["A", 0]]},
               {"_id": "q1", "answer": ["right"], "type": "comparison",
                "sp_gold": [["B", 1]]}]),
    # tests/test_more_cli.py::test_eval_reranked_string_answers_and_sp_scoping
    "strings_sp_scoping": (
        [{"_id": "q0", "pred_answer": "paris", "pred_sp": [["A", 0]]},
         {"_id": "q1", "pred_answer": "rome", "pred_sp": []}],
        [{"_id": "q0", "answer": "Paris", "type": "bridge",
          "sp_gold": [["A", 0]]},
         {"_id": "q1", "answer": "Rome", "type": "comparison"}]),
    # SP gold built from sp / sp_sent_ids, a gold row without a prediction
    "sp_sent_ids": (
        [{"_id": "q0", "pred_answer": "the cat", "pred_sp": [["A", 1],
                                                             ["B", 0]]},
         {"_id": "q1", "pred_answer": "no", "pred_sp": [["C", 2]]}],
        [{"_id": "q0", "answer": ["cat"], "type": "bridge",
          "sp": [{"title": "A", "sp_sent_ids": [1, 2]},
                 {"title": "B", "sp_sent_ids": [0]}]},
         {"_id": "q1", "answer": [], "sp": [{"title": "C",
                                              "sp_sent_ids": [2]}]},
         {"_id": "q9", "answer": ["x"]}]),
}


@pytest.mark.parametrize("case", sorted(RERANKED))
def test_eval_reranked_matches_jax(tmp_path, case):
    preds, gold = RERANKED[case]
    synth.write_jsonl(tmp_path / "p.jsonl", preds)
    synth.write_jsonl(tmp_path / "g.jsonl", gold)
    argv = [str(tmp_path / "p.jsonl"), str(tmp_path / "g.jsonl")]
    out = treranked.main(argv)
    assert out == jreranked.main(argv)
    assert all(np.isfinite(v) for d in out.values() for v in d.values())


def test_eval_reranked_disjoint_files_raise(tmp_path):
    synth.write_jsonl(tmp_path / "p.jsonl", RERANKED["lists"][0])
    synth.write_jsonl(tmp_path / "g.jsonl", [{"_id": "zzz", "answer": ["x"]}])
    argv = [str(tmp_path / "p.jsonl"), str(tmp_path / "g.jsonl")]
    with pytest.raises(ValueError, match="no gold _id") as terr:
        treranked.main(argv)
    with pytest.raises(ValueError) as jerr:
        jreranked.main(argv)
    assert str(terr.value) == str(jerr.value)


# ---- eval/analysis --------------------------------------------------------------


def test_error_decomposition_matches_jax():
    rng = np.random.RandomState(1)
    titles = [f"T{i}" for i in range(6)]
    jrows, trows = [], []
    for _ in range(400):
        gold = list(rng.choice(titles, 2, replace=False))
        qtype = ["bridge", "comparison"][rng.randint(2)]
        paths = [list(rng.choice(titles, 2, replace=False))
                 for _ in range(rng.randint(4))]
        hop1 = list(rng.choice(titles, rng.randint(4), replace=False))
        bridge = [None, gold[1], gold[0], "T9"][rng.randint(4)]
        args = (gold, qtype, paths, hop1, bridge)
        jrows.append(janalysis.decompose_errors(*args))
        trows.append(tanalysis.decompose_errors(*args))
        assert trows[-1] == jrows[-1]
    assert tanalysis.aggregate_errors(trows) == \
        janalysis.aggregate_errors(jrows)
    assert tanalysis.aggregate_errors([]) == janalysis.aggregate_errors([])


# ---- utils/docdb, utils/profiling -------------------------------------------------


def test_docdb_files_read_across_packages(tmp_path):
    rows = [("Caf\u00e9", "coffee place", "[[0, 5]]"),
            ("Zo\u00eb", "a name", ""), ("plain", "text", "[]")]
    for writer, reader, name in ((jdocdb, tdocdb, "j.db"),
                                 (tdocdb, jdocdb, "t.db")):
        with writer.DocDB.create(str(tmp_path / name)) as db:
            db.insert_many(rows[:2])
            db.insert(*rows[2])
        with reader.DocDB(str(tmp_path / name)) as db:
            assert sorted(db.get_doc_ids()) == sorted(
                unicodedata.normalize("NFD", r[0]) for r in rows)
            for title, text, spans in rows:
                assert db.get_doc_text(title) == text
                assert db.get_sentence_spans(title) == spans
            assert db.get_doc_text("absent") is None
            assert db.get_sentence_spans("absent") is None
    assert tutils.DocDB is tdocdb.DocDB


def test_stage_timers_and_device_trace(tmp_path):
    jt, tt = jprofiling.StageTimers(), tprofiling.StageTimers()
    for timers in (jt, tt):
        for name in ("a", "b", "a"):
            with timers.span(name):
                time.sleep(0.001)
    jrep, trep = jt.report(), tt.report()
    assert {k: v["count"] for k, v in trep.items()} == \
        {k: v["count"] for k, v in jrep.items()} == {"a": 2, "b": 1}
    assert all(v["mean_ms"] >= 1.0 and v["total_s"] > 0
               for v in trep.values())
    tt.dump(str(tmp_path / "timers.json"))
    assert json.load(open(tmp_path / "timers.json")) == trep

    with tprofiling.device_trace(""):
        pass
    with tprofiling.device_trace(None):
        pass
    log_dir = tmp_path / "trace"
    with tprofiling.device_trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "aten::mm" in names


# ---- utils/text -------------------------------------------------------------------

POOL = ([chr(c) for c in range(0x20, 0x7F)]                    # ASCII
        + [chr(c) for c in range(0xA1, 0x100)]                 # Latin-1
        + [chr(c) for c in range(0x3B1, 0x3CA)]                # Greek
        + [chr(c) for c in range(0x410, 0x450)]                # Cyrillic
        + ["\u0301", "\u0300", "\u0308", "\u0327"]             # Mn marks
        + [chr(c) for c in range(0x660, 0x66A)]                # Arabic-Indic
        + [chr(c) for c in range(0x966, 0x970)]                # Devanagari
        + [chr(c) for c in range(0xFF10, 0xFF1A)]              # fullwidth
        + [chr(c) for c in range(0x4E00, 0x4E30)]              # CJK
        + ["\u00a0", "\u2003", "\u3000", " ", " ", " "]        # Zs
        + ["\u0007", "\t", "\n", "\u200b", "\u00ad"]           # Cc, Cf
        + ["\u2014", "\u201c", "\u201d", "\u3002", "\u2026"])  # Pd, Pi, Pf, Po


def _strings(rng, n):
    return ["".join(rng.choice(POOL, rng.randint(0, 40))) for _ in range(n)]


def test_simple_tokenizer_matches_jax():
    rng = np.random.RandomState(7)
    jtok, ttok = jtext.SimpleTokenizer(), tutils.SimpleTokenizer()
    for s in _strings(rng, 2000):
        assert ttok.tokenize(s) == jtok.tokenize(s), repr(s)
        assert ttok.words(s) == jtok.words(s), repr(s)
        assert ttok.words(s, uncased=False) == jtok.words(s, uncased=False)
    # the class semantics the port builds from unicodedata
    assert ttok.tokenize("Café ٣٤x​y!!") == \
        ["Café", "٣٤x", "y", "!", "!"]


def test_para_has_answer_matches_jax():
    rng = np.random.RandomState(8)
    jtok, ttok = jtext.SimpleTokenizer(), ttext.SimpleTokenizer()
    paras = _strings(rng, 2000)
    hits = 0
    for i, para in enumerate(paras):
        toks = jtok.tokenize(para)
        answers = _strings(rng, rng.randint(0, 3))
        if toks and i % 2:                   # a token span of the passage
            a = rng.randint(len(toks))
            answers.append(" ".join(toks[a:a + rng.randint(1, 4)]).upper())
        got = ttext.para_has_answer(answers, para, ttok)
        assert got == jtext.para_has_answer(answers, para, jtok), \
            (answers, para)
        hits += got
    assert 400 < hits < 1600
    assert teval_pkg.normalize_answer("The  Cat!") == "cat"
