"""The readings a cell's limits are set from: for each seed, the numbers
the check compares for the program, and for the control, the plain
reference put in the program's place at the next lower precision (float8
e4m3 products for the bf16 configurations), judged the same way.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 2] [--fault NAME] [--out FILE]

Each seed is a run of the cell (``harness.run_cell``) with a short window
(at least the traffic's ``check_from`` steps, the steps the check samples
from); the control is judged on the same driver, on the same sampled
steps, once the program's check is done.  ``--fault`` plants a fault in
the program for every seed instead (``FAULTS``): the readings a limit
has to stay below.  A line of JSON per seed goes to standard output (and
to ``--out``).  One process reads every seed.  Needs a card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def skip_best():
    """The PCA search returns each query's second-best rows, with their
    true scores, and certifies none."""
    import torch
    from multihop_dense_retrieval_tpu_torch.search.beam import BeamSearcher

    orig = BeamSearcher._mips

    def mips(self, queries, k, pca=True):
        if not pca or not self.config.use_pca:
            return orig(self, queries, k, pca)
        vals, docs, _ = orig(self, queries, k + 1, pca)
        none = torch.zeros(len(queries), dtype=torch.bool,
                           device=queries.device)
        return vals[:, 1:], docs[:, 1:], none

    BeamSearcher._mips = mips


FAULTS = {"skip_best": skip_best}


def readings(bench, wl, seed: int, control: bool, seconds: float) -> dict:
    import importlib

    import torch

    from portbench import harness
    from portbench.reference.encoder import Encoder

    found = {}

    def judge_control(drv):
        found["info"] = getattr(drv, "info", {})
        if not control:
            return
        mod = importlib.import_module(type(drv).__module__)
        ref = Encoder(drv.weights, drv.cfg, device=drv.dev)
        enc = Encoder(drv.weights, drv.cfg, precision="fp8", device=drv.dev)
        worst = {}
        for c in drv.captured:
            rows = c[1]
            got = mod.judge(drv, ref, rows, mod.control_outputs(drv, enc,
                                                                 rows))
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
        found["control_fp8"] = worst

    out, checks = harness.run_cell(bench, wl, seed, seconds, False,
                                   time.perf_counter(), inspect=judge_control)
    torch.cuda.empty_cache()
    return dict({"seed": seed, "correct": out["correct"],
                 "setup_s": out["metrics"]["setup_s"]["value"],
                 "program": {k: v for k, v, _ in checks}}, **found)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default="", choices=[""] + sorted(FAULTS))
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    if args.fault:
        FAULTS[args.fault]()
    for s in seeds + sorted(ctrl - set(seeds)):
        line = json.dumps(dict(readings(bench, wl, s, s in ctrl,
                                        args.seconds),
                               workload=args.workload, fault=args.fault))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
