"""Grid-search launcher (the JAX package's ``cli/launch.py``; the
reference's submitit/submitit_train.py).

The reference grid-searches lr × temperature × warmup over SLURM jobs
(submitit_train.py:70-105) and picks the best run by returned MRR.  This
launcher runs the lr × warmup × seed grid as sequential
``cli/train_retriever`` runs in one process, each with its own output
directory and preemption-safe state, then prints the argmax line.  On a
preemption requeue, grid points already recorded in sweep_results.jsonl
are skipped (their result lines are reused), and unfinished points resume
through the trainer's own checkpoint state.

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.launch \
      --train-file t.jsonl --predict-file d.jsonl --output-dir sweeps \
      --grid-lr 1e-5,2e-5,5e-5 --grid-warmup 0.1,0.2 [base train args...]

The base arguments are ``cli/train_retriever``'s, ``--device`` and
``--data-parallel`` included: each grid point trains on that data mesh.
"""

import argparse
import itertools
import json
import os

from . import common
from . import train_retriever


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grid-lr", default="2e-5")
    p.add_argument("--grid-warmup", default="0.1")
    p.add_argument("--grid-seed", default="3")
    args, rest = p.parse_known_args(argv)

    base = argparse.ArgumentParser()
    train_retriever.add_train_args(base)
    base_args = base.parse_args(rest)
    logger = common.setup_logging(base_args.output_dir or None)

    lrs = [float(x) for x in args.grid_lr.split(",")]
    warmups = [float(x) for x in args.grid_warmup.split(",")]
    seeds = [int(x) for x in args.grid_seed.split(",")]

    root = base_args.output_dir or "sweep_out"
    # requeue support: reuse completed grid points (one JSONL line each,
    # written AFTER the trainer returns) instead of re-running AND
    # re-appending them — duplicate lines with divergent best_mrr for the
    # same run dir would corrupt the sweep record
    results_path = os.path.join(root, "sweep_results.jsonl")
    done = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    done[r["dir"]] = r

    results = []
    for lr, wu, seed in itertools.product(lrs, warmups, seeds):
        run_dir = os.path.join(root, f"lr{lr}_wu{wu}_seed{seed}")
        if run_dir in done:
            logger.info("grid point %s already complete, skipping", run_dir)
            results.append(done[run_dir])
            continue
        run_argv = list(rest)
        # override the grid fields
        for flag, val in (("--learning-rate", lr), ("--warmup-ratio", wu),
                          ("--seed", seed), ("--output-dir", run_dir)):
            if flag in run_argv:
                i = run_argv.index(flag)
                run_argv[i + 1] = str(val)
            else:
                run_argv += [flag, str(val)]
        logger.info("launching grid point lr=%s warmup=%s seed=%s", lr, wu, seed)
        res, _ = train_retriever.main(run_argv)
        results.append({"lr": lr, "warmup": wu, "seed": seed,
                        "best_mrr": res["best_mrr"], "dir": run_dir})
        with open(results_path, "a") as f:
            f.write(json.dumps(results[-1]) + "\n")

    best = max(results, key=lambda r: r["best_mrr"])
    logger.info("best grid point: %s", best)
    print(json.dumps(best))
    return best


if __name__ == "__main__":
    main()
