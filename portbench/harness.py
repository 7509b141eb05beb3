"""The run of one cell: set-up, warm-up, the measured window, the traced
segment, the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric lives
in files of its own, found by name:

  * ``configs/<config>.json``: the configuration (widths, corpus);
  * ``traffic/<traffic>.json``: the traffic mix, its ``driver`` (a module
    of ``drivers/``) and the limits of its check;
  * ``metrics/<metric>.py``: a reader ``read(r) -> float | None`` of one
    metric from the run's readings ``r`` (a ``Readings``).

A driver (``drivers/<driver>.py``, class ``Driver``) has ``setup()``,
``warmup()``, ``step(i) -> work done``, ``window_done(n)`` (after the
window's n steps: its ``attempted`` and ``failed``), ``readings(r)`` (its
own entries of ``r.extra``) and ``check() -> [(name, value, limit)]``;
``unit`` names a step ("batch", "call"), ``trace_steps`` how many each
traced segment profiles.  The window lasts at least the traffic's
``check_from`` steps, the steps the check samples from.

With ``--trace 1`` two segments follow the window: one profiled with the
host's operations and ranges (the per-range metrics and the breakdown),
then one profiled on the device alone, whose busy and window seconds
(``device``'s ``busy_s`` / ``window_s``, the idle share) keep the
untraced cadence: profiling the host's operations slows the host that
launches the work.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multihop_dense_retrieval_tpu")
H100_BF16_FLOPS = 989e12


class Readings:
    """What a run measured, for the metric readers.  ``window`` holds the
    (seconds, work) of each timed step, ``trace`` the traced segment's
    ``Trace`` (``--trace 1``), ``extra`` the driver's own entries."""

    def __init__(self):
        self.setup_s: float = 0.0
        self.window: List = []
        self.elapsed: float = 0.0
        self.trace = None
        self.trace_lo = self.trace_hi = 0.0
        self.trace_steps: int = 0
        self.trace_work: int = 0
        self.busy_s: Optional[float] = None
        self.busy_window_s: Optional[float] = None
        self.extra: Dict = {}

    @property
    def work(self) -> int:
        return sum(w for _, w in self.window)


class Clock:
    """Set-up phases on standard error: seconds since the process start."""

    t0 = time.perf_counter()

    @classmethod
    def log(cls, what: str) -> None:
        print(f"[{time.perf_counter() - cls.t0:8.2f} s] {what}",
              file=sys.stderr, flush=True)


def load_json(kind: str, name: str) -> Dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(bench: Dict, wl: Dict, seed: int, seconds: float, trace: bool,
             t0: float, device=None, driver_args: Optional[Dict] = None,
             cfg: Optional[Dict] = None, traffic: Optional[Dict] = None,
             inspect=None):
    """Run one cell; returns (result dict, [(name, value, limit)]).
    ``cfg`` / ``traffic`` replace the cell's files (the CPU tests' small
    sizes); ``driver_args`` go to the driver; ``inspect(driver)`` is
    called once the check is done (the calibration's control)."""
    cfg = cfg or load_json("configs", wl["config"])
    traffic = traffic or load_json("traffic", wl["traffic"])
    device = torch.device(device or "cuda")
    mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    drv = mod.Driver(cfg, traffic, seed, device, **(driver_args or {}))
    r = Readings()
    Clock.t0 = t0
    drv.setup()
    Clock.log("set up")
    drv.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    r.setup_s = time.perf_counter() - t0
    Clock.log("warmed up")

    start = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        work = drv.step(i)
        b = time.perf_counter()
        r.window.append((b - a, work))
        i += 1
        if b - start >= seconds and i >= traffic["check_from"]:
            break
    r.elapsed = b - start
    drv.window_done(i)
    Clock.log(f"window: {i} steps")

    if trace:
        from .trace import profiled

        with profiled() as holder:
            for j in range(drv.trace_steps):
                with record_function(drv.unit):
                    r.trace_work += drv.step(i + j)
        r.trace = holder.trace
        r.trace_steps = drv.trace_steps
        Clock.log(f"traced {drv.trace_steps} steps")
        units = r.trace.ranges.get(drv.unit, [])
        r.trace_lo = units[0][0]
        r.trace_hi = max([units[-1][1]] + [e for _, e, _, _ in r.trace.ops])
        if device.type == "cuda":
            with profiled(host=False) as held:
                torch.cuda.synchronize()
                a = time.perf_counter()
                for j in range(drv.trace_steps):
                    drv.step(i + drv.trace_steps + j)
                torch.cuda.synchronize()
                b = time.perf_counter()
            r.busy_s = held.trace.busy_us() * 1e-6
            r.busy_window_s = b - a
            Clock.log(f"traced {drv.trace_steps} steps on the device alone")
        else:
            r.busy_s = r.trace.busy_us(r.trace_lo, r.trace_hi) * 1e-6
            r.busy_window_s = (r.trace_hi - r.trace_lo) * 1e-6

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    drv.readings(r)
    checks = drv.check()
    Clock.log("checked")
    if inspect is not None:
        inspect(drv)
    correct = all(v <= lim for _, v, lim in checks)

    metrics = {}
    for m in metrics_of(bench, wl["name"], trace):
        value = metric_reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(drv.attempted),
           "failed": int(drv.failed), "metrics": metrics, "device": dev}
    if trace:
        lo, hi = r.trace_lo, r.trace_hi
        dev["busy_s"] = r.busy_s
        dev["window_s"] = r.busy_window_s
        out["breakdown"] = {"device_ops": r.trace.top_ops(),
                            "idle_gaps": r.trace.idle_gaps(lo, hi)}
    out["check"] = {name: {"value": float(v), "limit": float(lim)}
                    for name, v, lim in checks}
    return out, checks
