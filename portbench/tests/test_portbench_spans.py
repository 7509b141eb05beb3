"""The card's idle time by program span (``portbench/spans.py``): the
overlap attribution on a hand-written trace, and a recorded segment of
each driver at small sizes on the CPU."""

import time

import pytest
import torch

import small
from portbench import harness, spans as S
from portbench.trace import Trace
from multihop_dense_retrieval_tpu_torch.utils.profiling import Span

BASE_NS = 1_790_000_000_000_000_000


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "args": {"correlation": ts}}


def _span(name, start_us, end_us, parent):
    return Span(name, BASE_NS + int(start_us * 1000),
                BASE_NS + int(end_us * 1000), parent)


def test_idle_is_cut_along_the_innermost_span():
    """Kernels at [0, 10], [30, 40], [100, 110] µs in a window [0, 130]:
    the gap [40, 100] crosses hop2_encode, hop2_tile, encoder_forward,
    hop2_tile again, hop2_encode, search and search_fetch."""
    trace = Trace({"traceEvents": [_kernel(0, 10), _kernel(30, 10),
                                   _kernel(100, 10)],
                   "baseTimeNanoseconds": BASE_NS})
    spans = S.on_trace([_span("search", 5, 120, -1),
                        _span("hop2_encode", 20, 90, 0),
                        _span("hop2_tile", 45, 60, 1),
                        _span("encoder_forward", 50, 58, 2),
                        _span("search_fetch", 95, 118, 0)], BASE_NS)
    assert spans[2][:2] == pytest.approx((45.0, 60.0))
    idle = S.idle_by_span(trace.ops, spans, 0.0, 130.0)
    got = {k: pytest.approx(v) for k, v in S.by_name(idle, spans).items()}
    assert got == {"search": 10 + 5 + 2, "hop2_encode": 10 + 5 + 30,
                   "hop2_tile": 5 + 2, "encoder_forward": 8,
                   "search_fetch": 5 + 8, S.NONE: 10}
    assert sum(idle.values()) == pytest.approx(
        130 - trace.busy_us(0.0, 130.0))
    assert S.under(idle, spans, {"encoder_forward"}) == pytest.approx(8)
    assert S.under(idle, spans, {"search"}, {"encoder_forward"}) == \
        pytest.approx(17 + 45 + 7 + 13)
    seg = {"spans": spans, "idle": idle, "steps": 2, "work": 4,
           "counters": {"hop2.tokens_real": 30, "hop2.tokens_run": 40}}
    assert S.readings(seg, "batch") == pytest.approx(
        {"idle_encode_ms.retrieve": 8e-3 / 2,
         "idle_search_ms.retrieve": 82e-3 / 2,
         "hop2_pad_share.retrieve": 25.0})


def test_spans_meeting_at_an_instant_hand_over_in_order():
    """Siblings that meet, and a child opening with its parent: the
    innermost span changes at their edges and nothing is charged twice."""
    spans = [(0.0, 10.0, -1, "a"), (0.0, 4.0, 0, "b"), (4.0, 10.0, 0, "c"),
             (10.0, 12.0, -1, "d")]
    assert S.innermost(spans) == [(0.0, 1), (4.0, 2), (10.0, 3), (12.0, -1)]
    idle = S.idle_by_span([(2.0, 3.0, "k", None)], spans, 0.0, 14.0)
    assert S.by_name(idle, spans) == {"b": 3.0, "c": 6.0, "d": 2.0,
                                      S.NONE: 2.0}


CELLS = {"mhop.beam1.b192": {"idle_encode_ms.retrieve",
                             "idle_search_ms.retrieve",
                             "hop2_pad_share.retrieve"},
         "single.top100.b256": {"idle_encode_ms.retrieve"},
         "read.top5.q64": {"idle_featurize_ms.read", "idle_decode_ms.read",
                           "reader_pad_share.read"}}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_recorded_segment_reads_its_cell_s_readings(name):
    """On the CPU the segment profiles the host (there is no device
    operation), so every idle µs is the window's and is charged."""
    import importlib

    # 128 hop-2 rows: the smallest batch the hop-2 encode splits in tiles
    more = {"batch_size": 128} if name.startswith("mhop") else {}
    wl, cfg, tr, args = small.cell(name, "float32", **more)
    mod = importlib.import_module(f"portbench.drivers.{tr['driver']}")
    harness.Clock.t0 = time.perf_counter()
    drv = mod.Driver(cfg, tr, 2 ** 31 + 77, torch.device("cpu"), **args)
    drv.setup()
    drv.warmup()
    plain = S.segment(drv, tr["check_from"], 1, record=False)
    assert "spans" not in plain and plain["work"] > 0
    seg = S.segment(drv, tr["check_from"] + 1, 1)
    got = S.readings(seg, drv.unit)
    assert set(got) == CELLS[name]
    assert all(v >= 0 for v in got.values())
    idle = sum(seg["idle"].values()) * 1e-6
    assert idle == pytest.approx(seg["window_s"] - seg["busy_s"], abs=1e-6)
    assert {s[3] for s in seg["spans"]} >= {"encoder_forward"}
    check = S.clock_check(seg)
    assert check["straddling"] == 0
