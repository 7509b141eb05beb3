"""The card's idle time by the program's own spans, at the host's untraced
cadence.

A segment of a cell's steps is profiled on the device alone (no host
operations, so the host keeps its untraced pace) with the program's span
recorder on (``utils/profiling.py``: spans on ``time.time_ns()``, put on
the trace's time base with its ``baseTimeNanoseconds``).  Each idle
interval of the device's timeline in the segment is cut along the
innermost program span open over each part of it and the part charged to
that span; idle time outside every span goes to ``host:none``.  The
charges add up to the segment's window less its busy time.

    python3 -m portbench.spans --workload NAME --seed N [--steps K]
                               [--rounds R]

sets the cell up and warms it up as ``run.py`` does, then runs R rounds,
each of the same K steps (default: the traffic's ``trace_steps``) twice,
the recorder off and on in turns, each profiled on the device alone
(the recorder off, such a segment is the harness's), and prints
one JSON line: the card, each segment's ``window_s`` and ``busy_s``, the
last recorded segment's idle by innermost span (the top ten), its
counters, the readings below, and the clock check.  The harness's result
line carries none of this.

Readings, per step (``batch``) for retrieval, per question answered for
reading:

  * ``idle_encode_ms``: idle under ``encoder_forward`` (the host launching
    the encoder more slowly than the card runs it);
  * ``idle_search_ms``: idle under ``search`` outside ``encoder_forward``
    (assembly, the tile-width read, tile slicing, the fetch);
  * ``hop2_pad_share``: 100 × (1 - ``hop2.tokens_real`` /
    ``hop2.tokens_run``), %;
  * ``idle_featurize_ms``: idle under ``read_featurize`` and
    ``read_collate``;
  * ``idle_decode_ms``: idle under ``read_fetch``, ``read_decode`` and
    ``read_rank``;
  * ``reader_pad_share``: 100 × (1 - ``read.tokens_real`` /
    ``read.tokens_run``), %.

The clock check: a span that ends in a device→host read
(``hop2_tile_widths``, ``search_fetch``, ``read_fetch``) returns after
every operation queued before it has ended, so on one time base no
device operation starts before such a span's end and ends after it
(``straddling``, ``overshoot_us`` the most one ends after), and the
read's own copy ends a little before the span does (``slack_us``: the
least and the median of span end - the last operation's end before it).
"""

import contextlib
import importlib
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

import torch

from .trace import Trace

NONE = "host:none"
SYNCS = ("hop2_tile_widths", "search_fetch", "read_fetch")
# (reading, the spans whose idle it sums, the spans it leaves out)
IDLE = {"batch": [("idle_encode_ms.retrieve", ("encoder_forward",), ()),
                  ("idle_search_ms.retrieve", ("search",),
                   ("encoder_forward",))],
        "call": [("idle_featurize_ms.read",
                  ("read_featurize", "read_collate"), ()),
                 ("idle_decode_ms.read",
                  ("read_fetch", "read_decode", "read_rank"), ())]}
PADS = {"batch": ("hop2_pad_share.retrieve", "hop2"),
        "call": ("reader_pad_share.read", "read")}

# a span on the trace's time base: (start µs, end µs, parent index, name)
SpanUs = Tuple[float, float, int, str]


def on_trace(spans, base_ns: int) -> List[SpanUs]:
    """The recorder's ``Span`` records on a trace's time base (µs after
    its ``baseTimeNanoseconds``)."""
    return [((s.start_ns - base_ns) * 1e-3, (s.end_ns - base_ns) * 1e-3,
             s.parent, s.name) for s in spans]


def idle_intervals(ops: Sequence, lo: float, hi: float) -> List[Tuple]:
    """The gaps in [lo, hi] in which no operation of ``ops`` (sorted by
    start; (start, end, ...) in µs) runs."""
    out, end = [], lo
    for op in ops:
        s, e = op[0], op[1]
        if s > end and end < hi:
            out.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        out.append((end, hi))
    return out


def innermost(spans: Sequence[SpanUs]) -> List[Tuple[float, int]]:
    """The innermost open span as a step function of time: the times at
    which it changes and the span's index after each (-1: none open).
    Spans nest (one recorder, one thread): at one instant, spans that end
    close before spans that start open, the deeper ones first."""
    depth = []
    for _, _, parent, _ in spans:
        depth.append(0 if parent < 0 else depth[parent] + 1)
    events = sorted([(s, 1, d, i) for i, ((s, _, _, _), d)
                     in enumerate(zip(spans, depth))]
                    + [(e, 0, -d, i) for i, ((_, e, _, _), d)
                       in enumerate(zip(spans, depth))])
    stack: List[int] = []
    points: List[Tuple[float, int]] = []
    for t, opens, _, i in events:
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        owner = stack[-1] if stack else -1
        if points and points[-1][0] == t:
            points[-1] = (t, owner)
        else:
            points.append((t, owner))
    return points


def idle_by_span(ops: Sequence, spans: Sequence[SpanUs], lo: float,
                 hi: float) -> Dict[int, float]:
    """Idle µs in [lo, hi] charged to the innermost span open over each
    part of it, by span index (-1: outside every span)."""
    points = innermost(spans)
    tot: Dict[int, float] = {}
    j, cur = 0, -1
    for a, b in idle_intervals(ops, lo, hi):
        while j < len(points) and points[j][0] <= a:
            cur = points[j][1]
            j += 1
        t = a
        while j < len(points) and points[j][0] < b:
            tot[cur] = tot.get(cur, 0.0) + points[j][0] - t
            t, cur = points[j]
            j += 1
        tot[cur] = tot.get(cur, 0.0) + b - t
    return tot


def by_name(idle: Dict[int, float], spans: Sequence[SpanUs]
            ) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for i, us in idle.items():
        name = spans[i][3] if i >= 0 else NONE
        out[name] = out.get(name, 0.0) + us
    return out


def under(idle: Dict[int, float], spans: Sequence[SpanUs], names,
          leave_out=()) -> float:
    """Idle µs charged to spans inside (or being) a span of ``names``, with
    no span of ``leave_out`` between them."""
    total = 0.0
    for i, us in idle.items():
        while i >= 0 and spans[i][3] not in names:
            if spans[i][3] in leave_out:
                i = -1
                break
            i = spans[i][2]
        if i >= 0:
            total += us
    return total


@contextlib.contextmanager
def device_profile():
    """Profile the body on the device alone (the host's operations where
    there is no card); yields a holder whose ``trace`` (a ``Trace``) and
    ``base_ns`` (the trace's ``baseTimeNanoseconds``) are set once the
    body has ended."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None, "base_ns": 0})()
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            chrome = json.load(f)
    finally:
        os.remove(path)
    holder.trace = Trace(chrome)
    holder.base_ns = int(chrome.get("baseTimeNanoseconds", 0))


def segment(drv, first: int, steps: int, record: bool = True) -> Dict:
    """Run the driver's steps ``first`` .. ``first + steps - 1`` profiled
    on the device alone, the program's recorder on if ``record``; returns
    the segment's ``window_s``, ``busy_s`` and ``work``, and when recorded
    its ``spans`` (``SpanUs``), ``counters`` and ``idle`` (µs by span
    index) on the trace's time base."""
    from multihop_dense_retrieval_tpu_torch.utils.profiling import recorder

    cuda = torch.cuda.is_available()
    with device_profile() as held:
        if cuda:
            torch.cuda.synchronize()
        lo_ns = time.time_ns()
        with (recorder() if record else contextlib.nullcontext()) as timers:
            work = sum(drv.step(first + j) for j in range(steps))
        if cuda:
            torch.cuda.synchronize()
        hi_ns = time.time_ns()
    base = held.base_ns
    lo, hi = (lo_ns - base) * 1e-3, (hi_ns - base) * 1e-3
    out = {"steps": steps, "work": work, "window_s": (hi - lo) * 1e-6,
           "busy_s": held.trace.busy_us(lo, hi) * 1e-6}
    if record:
        spans = on_trace(timers.spans, base)
        out.update(spans=spans, counters=dict(timers.counters),
                   idle=idle_by_span(held.trace.ops, spans, lo, hi),
                   ops=held.trace.ops)
    return out


def readings(seg: Dict, unit: str) -> Dict[str, float]:
    """The readings of a recorded segment (see the module's docstring)
    that it has something to read for."""
    out: Dict[str, float] = {}
    spans, idle = seg["spans"], seg["idle"]
    per = seg["steps"] if unit == "batch" else seg["work"]
    names = {s[3] for s in spans}
    for name, inside, leave_out in IDLE.get(unit, []):
        if names & set(inside) and per:
            out[name] = under(idle, spans, inside, leave_out) * 1e-3 / per
    if unit in PADS:
        name, key = PADS[unit]
        real = seg["counters"].get(f"{key}.tokens_real")
        run = seg["counters"].get(f"{key}.tokens_run")
        if run:
            out[name] = 100.0 * (1.0 - real / run)
    return out


def clock_check(seg: Dict) -> Dict:
    """How the device operations of a recorded segment lie against the
    ends of its spans that end in a device→host read: how many start
    before such an end and end after it, by how much at most, and the
    least and median slack from the last operation's end to the span's."""
    ops = seg["ops"]
    ends = sorted(e for _, e, _, n in seg["spans"] if n in SYNCS)
    over, slack = [], []
    for t in ends:
        before = [e for s, e, _, _ in ops if s < t]
        over += [e - t for e in before if e > t]
        done = [e for e in before if e <= t]
        if done:
            slack.append(t - max(done))
    return {"syncs": len(ends), "straddling": len(over),
            "overshoot_us": max(over, default=0.0),
            "slack_us": [min(slack), statistics.median(slack)]
            if slack else None}


def main(argv=None) -> int:
    import argparse

    from . import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    with open(harness.HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = harness.load_json("configs", wl["config"])
    traffic = harness.load_json("traffic", wl["traffic"])
    mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    drv = mod.Driver(cfg, traffic, args.seed, torch.device("cuda"))
    drv.setup()
    drv.warmup()
    torch.cuda.synchronize()
    steps = args.steps or drv.trace_steps
    first = traffic["check_from"]     # the check samples steps before it
    segs = {False: [], True: []}
    for r in range(args.rounds):
        # each round runs the same steps both ways, in turns first
        for record in ((False, True) if r % 2 == 0 else (True, False)):
            segs[record].append(segment(drv, first, steps, record))
        first += steps
    last = segs[True][-1]
    idle = by_name(last["idle"], last["spans"])
    line = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0), "unit": drv.unit,
        "steps": steps, "work": last["work"],
        "window_s": {k: [s["window_s"] for s in segs[v]]
                     for k, v in (("off", False), ("on", True))},
        "busy_s": {k: [s["busy_s"] for s in segs[v]]
                   for k, v in (("off", False), ("on", True))},
        "idle_s": last["window_s"] - last["busy_s"],
        "idle_charged_s": sum(idle.values()) * 1e-6,
        "idle_by_span": [[k, v * 1e-6] for k, v in sorted(
            idle.items(), key=lambda x: -x[1])[:10]],
        "counters": last["counters"],
        "readings": readings(last, drv.unit),
        "clock": clock_check(last),
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
