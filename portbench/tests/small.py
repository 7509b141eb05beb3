"""Small sizes of the benchmark's cells for the CPU tests: the same
drivers, references and checks, with narrow encoders and a small corpus.
``dtype`` float32 makes the program's arithmetic comparable with the
reference's to rounding."""

import json
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
SMALL_CORPUS = {"n_pad": 16384, "n_docs": 16000, "pca_dims": 64}


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(name):
    return next(w for w in bench()["workloads"] if w["name"] == name)


def cell(name, dtype="bfloat16", **traffic):
    """(workload entry, config, traffic, driver args) of a small cell."""
    wl = workload(name)
    cfg = harness.load_json("configs", wl["config"])
    tr = harness.load_json("traffic", wl["traffic"])
    if cfg["model"] == "retriever":
        cfg = dict(cfg, hidden_size=128, num_attention_heads=4,
                   intermediate_size=256, num_hidden_layers=2, dtype=dtype)
        tr = dict(tr, batch_size=16, question_pool=64, warmup_batches=1,
                  trace_steps=1, check_from=2, check_batches=1,
                  topk=min(tr["topk"], 20))
        if tr["limits"]["planted_miss"]:
            # the small PCA index certifies few hop-2 queries: a quarter
            # of a batch's planted chains may go unfound
            tr["limits"] = dict(tr["limits"], planted_miss=4)
        args = {"sizes": SMALL_CORPUS}
    else:
        cfg = dict(cfg, hidden_size=64, num_attention_heads=4,
                   intermediate_size=128, num_hidden_layers=2, dtype=dtype)
        tr = dict(tr, questions=4, question_pool=12, warmup_calls=1,
                  trace_steps=1, check_from=2, check_calls=1)
        args = {}
    tr.update(traffic)
    return wl, cfg, tr, args
