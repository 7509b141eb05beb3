"""Tracing / profiling (the JAX package's ``utils/profiling.py``, grown into
the port's span recorder).

Two tools:
  * `StageTimers`  — named host spans and counters.  ``report()`` sums the
                     wall-clock seconds of each span name (host-side;
                     device work must be synced by the caller).  Each span
                     is also kept in memory as a `Span`: name, start and
                     end, the span it opened under, and its step;
  * `device_trace` — a ``torch.profiler`` trace in place of the JAX copy's
                     ``jax.profiler`` one: CPU activity, and CUDA activity
                     when a card is present, written as a Chrome trace
                     (``*.pt.trace.json``, TensorBoard-loadable) into
                     ``log_dir``.

The program marks its steps with the module's `span(name)` and `count(name,
n)`, which act in one of three states:
  * a recorder is on (``with recorder() as timers``): every span lands in
    ``timers`` and counters add up by name in ``timers.counters``;
  * a ``torch.profiler`` profile is on: ``span`` also opens a
    ``record_function`` range of its name, which the trace holds where the
    profiler records the host's activity;
  * neither: ``span`` returns one shared no-op context and ``count``
    returns at once; nothing is allocated and nothing waits for the card.

A span opened with no span open around it starts a new step; the spans
inside it share its step id (one ``BeamSearcher.search`` or one reader
``predict`` call).  A recorder follows the nesting of one thread.

Clock: spans read ``time.time_ns()`` (CLOCK_REALTIME), the clock of the
profiler's Chrome trace, whose events lie at ``ts * 1e3 +
baseTimeNanoseconds`` ns of Unix time (``ts`` in µs, the base at the top
level of the exported JSON).  A span at ``start_ns`` lies at
``(start_ns - baseTimeNanoseconds) / 1e3`` on the trace's ``ts`` axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int = 0
    parent: int = -1       # index of the enclosing span in ``spans``, or -1
    step: int = 0


class StageTimers:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self._open: List[int] = []
        self._steps = 0

    def span(self, name: str):
        return _SpanContext(self, name, _profiler_on())

    def _enter(self, name: str) -> None:
        parent = self._open[-1] if self._open else -1
        if parent < 0:
            self._steps += 1
            step = self._steps
        else:
            step = self.spans[parent].step
        self._open.append(len(self.spans))
        self.spans.append(Span(name, time.time_ns(), 0, parent, step))

    def _exit(self) -> None:
        s = self.spans[self._open.pop()]
        s.end_ns = time.time_ns()
        self.totals[s.name] += (s.end_ns - s.start_ns) * 1e-9
        self.counts[s.name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_ms": 1e3 * self.totals[name] / self.counts[name]}
                for name in self.totals}

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


class _SpanContext:
    __slots__ = ("timers", "name", "range")

    def __init__(self, timers: Optional[StageTimers], name: str,
                 ranges: bool):
        self.timers, self.name = timers, name
        self.range = torch.profiler.record_function(name) if ranges else None

    def __enter__(self):
        if self.timers is not None:
            self.timers._enter(self.name)
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.timers is not None:
            self.timers._exit()
        return False


_active: Optional[StageTimers] = None
_NOOP = contextlib.nullcontext()


def _profiler_on() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """A context marking one step of the program (see the module's
    docstring for its three states)."""
    ranges = _profiler_on()
    if _active is None and not ranges:
        return _NOOP
    return _SpanContext(_active, name, ranges)


def count(name: str, n: int) -> None:
    """Add the host number ``n`` to the recorder's counter ``name``."""
    if _active is not None:
        _active.counters[name] += n


def recording() -> bool:
    """Whether a recorder is on: counters that cost work to compute are
    computed only then."""
    return _active is not None


@contextlib.contextmanager
def recorder(timers: Optional[StageTimers] = None):
    """Turn the recorder on for the body, into ``timers`` (a new
    ``StageTimers`` by default), which it yields; the recorder that was on
    before comes back after."""
    global _active
    before = _active
    _active = timers if timers is not None else StageTimers()
    try:
        yield _active
    finally:
        _active = before


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace into ``log_dir`` (no-op when it is empty).  The
    card's queue is drained before the trace stops, so every kernel the
    body launched is in it."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
