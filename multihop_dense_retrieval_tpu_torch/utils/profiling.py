"""Tracing / profiling harness (the JAX package's ``utils/profiling.py``).

Two tools:
  * `StageTimers`  — named wall-clock spans accumulated into a report
                     (host-side; device work must be synced by the caller),
                     copied as it is;
  * `device_trace` — a ``torch.profiler`` trace in place of the JAX copy's
                     ``jax.profiler`` one: CPU activity, and CUDA activity
                     when a card is present, written as a Chrome trace
                     (``*.pt.trace.json``, TensorBoard-loadable) into
                     ``log_dir``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class StageTimers:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_ms": 1e3 * self.totals[name] / self.counts[name]}
                for name in self.totals}

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


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
