"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``portbench/configs/``) and a traffic mix (``portbench/traffic/``, whose
``driver`` is a module of ``portbench/drivers/``).  The run makes its
inputs and weights on the card from ``--seed``, warms up, measures for
``--seconds`` (with ``--trace 1`` it then profiles a short segment for the
per-layer metrics), checks what the timed path produced against the plain
reference (``portbench/reference/``), and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when traced), ``check`` last.
The numbers compared, each beside its limit, are also the last lines of
standard error.  Without a card, or with fewer than the cell asks for, it
exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"unknown workload {args.workload}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from portbench import harness

    out, checks = harness.run_cell(bench, wl, args.seed, args.seconds,
                                   bool(args.trace), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
