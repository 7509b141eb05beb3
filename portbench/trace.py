"""Reading a ``torch.profiler`` trace: device operations, the host ranges
that launched them, busy time, and the idle gaps by what the host was
doing.

The profiler's Chrome trace is written to a temporary file (under
``TMPDIR``), read back and deleted.  Device operations are the kernel,
memcpy and memset events; each is tied to its launch on the host by the
``correlation`` id, and a host range (``record_function``, the program's
and the benchmark's) owns the operations launched inside it.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


@contextlib.contextmanager
def profiled(host: bool = True):
    """Profile the body (the host's operations and ranges unless ``host``
    is false, and the device's); yields a holder whose ``.trace`` is the
    parsed ``Trace`` once the body has ended."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None})()
    cuda = torch.cuda.is_available()
    acts = (([ProfilerActivity.CPU] if host else [])
            + ([ProfilerActivity.CUDA] if cuda else []))
    with profile(activities=acts) as prof:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    from .harness import Clock

    Clock.log("profiled")
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        Clock.log(f"trace written: {os.path.getsize(path) >> 20} MiB")
        with open(path) as f:
            holder.trace = Trace(json.load(f))
    finally:
        os.remove(path)


class Trace:
    def __init__(self, chrome: Dict):
        events = [e for e in chrome.get("traceEvents", [])
                  if e.get("ph") == "X"]
        self.ops: List[Tuple[float, float, str, Optional[int]]] = []
        launches: Dict[int, float] = {}
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in events:
            cat = e.get("cat", "")
            args = e.get("args", {}) or {}
            if cat in DEVICE_CATS:
                self.ops.append((float(e["ts"]), float(e["ts"] + e["dur"]),
                                 e.get("name", "?"), args.get("correlation")))
            elif cat == "cuda_runtime" or cat == "cuda_driver":
                if "correlation" in args:
                    launches[args["correlation"]] = float(e["ts"])
            elif cat == "user_annotation":
                self.ranges[e["name"]].append(
                    (float(e["ts"]), float(e["ts"] + e["dur"])))
        self.ops.sort()
        for spans in self.ranges.values():
            spans.sort()
        self.launch_ts = [launches.get(c) for _, _, _, c in self.ops]

    # ---- device time -------------------------------------------------------

    def busy_us(self, lo: float = float("-inf"),
                hi: float = float("inf")) -> float:
        """Microseconds in [lo, hi] in which some device operation ran."""
        total, end = 0.0, lo
        for s, e, _, _ in self.ops:
            s, e = max(s, end), min(e, hi)
            if e > s:
                total += e - s
                end = e
        return total

    def _inside(self, name: str, ts: Optional[float]) -> bool:
        spans = self.ranges.get(name)
        if ts is None or not spans:
            return False
        # ranges of one name follow each other (none nests in another)
        i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= ts <= spans[i][1]

    def device_us_in(self, names) -> float:
        """Device microseconds of the operations launched inside any host
        range of ``names``."""
        names = [names] if isinstance(names, str) else list(names)
        return sum(e - s for (s, e, _, _), ts in zip(self.ops, self.launch_ts)
                   if any(self._inside(n, ts) for n in names))

    # ---- breakdown ---------------------------------------------------------

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for s, e, name, _ in self.ops:
            tot[name[:160]] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]

    def idle_gaps(self, lo: float, hi: float, n: int = 10,
                  short_us: float = 20.0) -> List[List]:
        """The device's idle time in [lo, hi], summed by the innermost host
        range open at each gap's start ("host:none" outside every range);
        gaps under ``short_us`` go to "launch" (the host issuing the next
        operation).  The largest ``n`` sums."""
        flat = sorted((s, e, name) for name, spans in self.ranges.items()
                      for s, e in spans)
        starts = [s for s, _, _ in flat]
        tot: Dict[str, float] = defaultdict(float)
        end = lo
        for s, e, _, _ in self.ops + [(hi, hi, "", None)]:
            if s > end and end < hi:
                gap = min(s, hi) - end
                key = ("launch" if gap < short_us
                       else self._innermost(flat, starts, end))
                tot[key] += gap * 1e-6
            end = max(end, e)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]

    @staticmethod
    def _innermost(flat, starts, ts: float, look: int = 4096) -> str:
        best, width = "host:none", float("inf")
        i = bisect.bisect_right(starts, ts)
        for s, e, name in flat[max(0, i - look):i]:
            if e >= ts and e - s < width:
                best, width = "host:" + name, e - s
        return best
