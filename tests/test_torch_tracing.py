"""The port's span recorder (``utils/profiling.py``) and the spans and
counters the program records with it: the recorder's three states, span
nesting, steps and counters, the span clock against the profiler's, the
hop-2 and reader token counters against hand counts, and outputs that do
not depend on whether a recorder is on."""

import json

import numpy as np
import pytest
import torch

from multihop_dense_retrieval_tpu_torch.core.config import (EncoderConfig,
                                                            SearchConfig)
from multihop_dense_retrieval_tpu_torch.data import HashTokenizer
from multihop_dense_retrieval_tpu_torch.data.qa_dataset import QADataset
from multihop_dense_retrieval_tpu_torch.eval import qa_eval
from multihop_dense_retrieval_tpu_torch.index import DenseIndex
from multihop_dense_retrieval_tpu_torch.models import MhopRetriever, QAReader
from multihop_dense_retrieval_tpu_torch.search import BeamSearcher
from multihop_dense_retrieval_tpu_torch.train.qa import make_qa_predict_step
from multihop_dense_retrieval_tpu_torch.utils import profiling
from multihop_dense_retrieval_tpu_torch.utils.profiling import (
    StageTimers, count, recorder, recording, span)


def _names(timers, parent):
    return [s.name for s in timers.spans if s.parent == parent]


# ---- the recorder ----------------------------------------------------------

def test_recorder_off_is_one_shared_no_op():
    assert not recording()
    a, b = span("a"), span("b")
    assert a is b is profiling._NOOP
    with span("a"):
        count("x", 3)
    assert profiling._active is None
    timers = StageTimers()
    with recorder(timers):
        pass
    with span("c"):
        count("x", 1)
    assert timers.spans == [] and dict(timers.counters) == {}


def test_spans_nest_share_their_step_and_counters_add_up():
    with recorder() as t:
        assert recording()
        with span("a"):
            with span("b"):
                count("x", 2)
            with span("c"):
                count("y", 1)
        with span("d"):
            count("x", 3)
            with recorder() as inner:
                with span("e"):
                    count("x", 100)
            assert profiling._active is t
    assert not recording()
    assert [(s.name, s.parent, s.step) for s in t.spans] == [
        ("a", -1, 1), ("b", 0, 1), ("c", 0, 1), ("d", -1, 2)]
    assert dict(t.counters) == {"x": 5, "y": 1}
    assert [(s.name, s.step) for s in inner.spans] == [("e", 1)]
    a, b, c, d = t.spans
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= c.end_ns \
        <= a.end_ns <= d.start_ns <= d.end_ns
    rep = t.report()
    assert {k: v["count"] for k, v in rep.items()} == \
        {"a": 1, "b": 1, "c": 1, "d": 1}
    assert rep["a"]["total_s"] == pytest.approx(
        (a.end_ns - a.start_ns) * 1e-9)


def test_spans_and_profiler_ranges_share_one_clock(tmp_path):
    """A span and the ``record_function`` range it opens lie at the same
    place once the trace's ``ts`` is put on Unix time with
    ``baseTimeNanoseconds``; with the recorder off the range is still
    there."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder() as t:
            for _ in range(3):
                with span("probe"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
        with span("unrecorded"):
            torch.ones(8)
    assert not recording()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    chrome = json.load(open(path))
    base = chrome["baseTimeNanoseconds"]
    ranges = [e for e in chrome["traceEvents"]
              if e.get("cat") == "user_annotation"]
    probes = sorted(e["ts"] for e in ranges if e["name"] == "probe")
    assert len(probes) == 3
    assert [e["name"] for e in ranges].count("unrecorded") == 1
    for s, e in zip(t.spans, sorted(
            (e for e in ranges if e["name"] == "probe"),
            key=lambda e: e["ts"])):
        start = e["ts"] * 1e3 + base
        end = (e["ts"] + e["dur"]) * 1e3 + base
        assert abs(start - s.start_ns) < 1e6 and abs(end - s.end_ns) < 1e6


# ---- hop 2 -----------------------------------------------------------------

N_DOCS, Q_LEN, SP_LEN, BUCKETS = 256, 24, 88, (32, 48, 64, 88)


def _searcher(margin):
    torch.manual_seed(0)
    tok = HashTokenizer(vocab_size=512, roberta_style=True)
    model = MhopRetriever(EncoderConfig.tiny(
        vocab_size=512, max_position_embeddings=96, type_vocab_size=1,
        roberta_positions=True)).eval()
    rng = np.random.RandomState(3)
    words = [f"w{i}" for i in range(400)]
    texts = [" ".join(rng.choice(words, rng.randint(0, 60)))
             for _ in range(N_DOCS)]
    raw = [tok.raw_ids_padded(t, 60) for t in texts]
    text_ids = np.stack([r[0] for r in raw]).astype(np.int32)
    text_lens = np.array([r[1] for r in raw], np.int32)
    emb = rng.randn(N_DOCS, 32).astype(np.float32)
    index = DenseIndex.build(emb, chunk_rows=128, dtype="float32",
                             device="cpu")
    cfg = SearchConfig(beam_size_1=4, beam_size_2=2, topk=2,
                       max_q_len=Q_LEN, max_q_sp_len=SP_LEN, chunk_rows=128,
                       use_pallas=False, hop2_buckets=BUCKETS,
                       hop2_prune_margin=margin)
    calls = []

    def encode(ids, mask, tt=None):
        calls.append(mask.clone())
        return model.encode_seq(ids, mask, tt)

    engine = BeamSearcher(encode_fn=encode, index=index, text_ids=text_ids,
                          text_lens=text_lens, empty=text_lens == 0,
                          spec=tok.spec, config=cfg, device="cpu")
    qs = [" ".join(rng.choice(words, rng.randint(1, 18))) for _ in range(8)]
    q_inputs = tok.encode_batch_one(qs, Q_LEN)
    q_raw = [tok.raw_ids_padded(q, Q_LEN - 2) for q in qs]
    args = (q_inputs, np.stack([r[0] for r in q_raw]),
            np.array([r[1] for r in q_raw]))
    return engine, args, calls, text_lens


def _pair_len(a, b, budget=SP_LEN - 4):
    while a + b > budget:          # longest-first truncation, token by token
        if a > b:
            a -= 1
        else:
            b -= 1
    return a + b + 4


@pytest.mark.parametrize("margin", [0.0, 1e-4])
def test_hop2_counters_equal_a_hand_count(margin, monkeypatch):
    """Real tokens are the active q + p rows' lengths; the tokens run are
    rows × width of each tile the encoder saw; the tiles run and skipped
    add up to the tiling.  The search returns the same chains with the
    recorder on, and reads the card no more often."""
    engine, args, calls, text_lens = _searcher(margin)
    reads = {"n": 0}
    for name in ("tolist", "item", "cpu"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **kw):
            reads["n"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    off = engine.search(*args)
    reads_off, n_off = reads["n"], len(calls)
    calls.clear()
    with recorder() as t:
        on = engine.search(*args)
    assert reads["n"] - reads_off == reads_off
    assert set(on) == set(off)
    for k in off:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    assert len(calls) == n_off

    tiles = calls[1:]                       # calls[0] is hop 1
    q_lens = args[2]
    d1, cand = off["hop1_cand_scores"], off["hop1_cand_ids"]
    top1 = d1.max(axis=1, keepdims=True)
    active = (d1 >= top1 - margin) if margin else np.ones_like(d1, bool)
    real = sum(_pair_len(int(q_lens[b]), int(text_lens[cand[b, j]]))
               for b in range(d1.shape[0]) for j in range(d1.shape[1])
               if active[b, j])
    assert t.counters["hop2.tokens_real"] == real
    assert t.counters["hop2.tokens_run"] == sum(m.numel() for m in tiles)
    assert t.counters["hop2.tiles_run"] == len(tiles)
    assert t.counters["hop2.tiles_run"] + t.counters["hop2.tiles_skipped"] \
        == len(BUCKETS)
    # without pruning every row is active and fits its tile's width
    assert (t.counters["hop2.tiles_skipped"] > 0) == bool(margin)
    assert (t.counters["hop2.tokens_real"] == sum(
        int(m.sum()) for m in tiles)) or margin

    assert _names(t, -1) == ["search"]
    assert _names(t, 0) == ["hop1_encode", "hop1_mips", "hop2_assemble",
                            "hop2_encode", "hop2_mips", "chain_topk",
                            "search_fetch"]
    hop2 = next(i for i, s in enumerate(t.spans) if s.name == "hop2_encode")
    assert _names(t, hop2) == ["hop2_tile_widths"] + ["hop2_tile"] * len(
        tiles)
    forwards = [s for s in t.spans if s.name == "encoder_forward"]
    assert [t.spans[s.parent].name for s in forwards] == \
        ["hop1_encode"] + ["hop2_tile"] * len(tiles)
    assert {s.step for s in t.spans} == {1}


# ---- the reader ------------------------------------------------------------

def _qa_rows(n=3, chains=4):
    rng = np.random.RandomState(5)

    def sents(k):
        return [" ".join(f"w{x}" for x in rng.randint(0, 300, rng.randint(
            2, 12))) + " ." for _ in range(k)]

    rows = []
    for i in range(n):
        cands = [[{"title": f"T{i}{j}{p}", "sents": sents(rng.randint(1, 4))}
                  for p in range(2)] for j in range(chains)]
        rows.append({"question": f"where is it {i}?", "_id": f"q{i}",
                     "answer": ["paris"], "candidate_chains": cands})
    return rows


def test_predict_records_its_steps_and_token_counts():
    torch.manual_seed(1)
    model = QAReader(EncoderConfig.tiny(
        vocab_size=512, max_position_embeddings=128, type_vocab_size=2,
        pad_token_id=0, roberta_positions=False), sp_pred=True).eval()
    ds = QADataset(HashTokenizer(vocab_size=512, roberta_style=False),
                   _qa_rows(), max_seq_len=96, max_q_len=12,
                   num_answer_slots=4, max_sents=8, train=False)
    step = make_qa_predict_step(model, max_ans_len=8)
    seen = []

    def predict_step(net):
        seen.append(net["attention_mask"].shape)
        return step(net)

    kw = dict(batch_size=5, lambdas=[0.0, 0.8], width_multiple=16)
    off = qa_eval.predict(predict_step, ds, **kw)
    n_batches = len(seen)
    with recorder() as t:
        on = qa_eval.predict(predict_step, ds, **kw)
    assert on == off
    assert n_batches == 3                   # 12 chains: 5, 5, 2 + 3 pad rows

    assert _names(t, -1) == ["read"]
    batch = ["read_featurize"] * 5 + ["read_collate", "read_step",
                                      "read_fetch", "read_decode"]
    assert _names(t, 0) == batch * 3 + ["read_rank"]
    forwards = [s for s in t.spans if s.name == "encoder_forward"]
    assert [t.spans[s.parent].name for s in forwards] == ["read_step"] * 3
    assert {s.step for s in t.spans} == {1}

    real = sum(int(ds[i]["features"]["attention_mask"].sum())
               for i in range(len(ds)))
    assert t.counters["read.tokens_real"] == real
    assert t.counters["read.tokens_run"] == sum(
        r * w for r, w in seen[n_batches:])
    assert all(r == 5 for r, _ in seen)
    assert t.counters["read.tokens_run"] > real
