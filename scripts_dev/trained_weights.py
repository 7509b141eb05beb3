"""chip_smoke.py's leg p alone: the trained-weight measurements on the
card.  p1 runs scripts_dev/prune_sweep_torch.py at its defaults (the mini
retriever over 65,536 docs, kernel 2 at both hops), p2 trains a
roberta-base retriever on the same data and serves its int8 + PCA index
at batch 192 and beam 4 (kernels 1, 3 and 4: certified shares unsharded
and over 4 row shards, pruning at auto and auto:0.9, the kernels' times
on the trained launches), p3 runs scripts_dev/fidelity_trained_torch.py
at its defaults.  Every launch is held to the exact scan or its plain
version.

Run on a GPU host from the repository root:
  python3 scripts_dev/trained_weights.py
  python3 scripts_dev/trained_weights.py --lr-sweep 1e-3,1e-4 --epochs 4
  python3 scripts_dev/trained_weights.py --reader-seeds 42,1,2 --epochs 6 \
      [--reader-init READER.pt]
The second form only trains p2's roberta-base retriever at each learning
rate (p1's data and recipe) and prints its best train MRR and loss, the
figures that chose p2's learning rate.  The third runs p3's script,
fidelity_trained_torch, at each training seed (cli/train_qa's --seed,
which seeds the sampler and, without --reader-init, the reader's
weights; the script leaves it at 42) for the given epochs, with the rank
widths cut to 128: each epoch's train loss and answer EM, the script's
result or the check it failed, and, on the reader it trained, the
one-stage read's answer EM on the questions whose answer was a training
answer and on those whose was not, and that read beside the two-stage
read with the length-bucketed rank pass at rank_topm 9, which keeps all
9 chains of every question and so must equal it.  --reader-init starts every seed from one reader .pt (a
reference QAModel state dict, such as the JAX package's cli/export_ckpt
writes).
"""

import argparse
import importlib
import json
import logging
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def lr_sweep(lrs, epochs, smi, tmp):
    ps = chip_smoke.load_script("prune_sweep_torch")
    paths, _, _ = ps.make_data(tmp, np.random.RandomState(0),
                               n_docs=chip_smoke.P_DOCS,
                               n_train=chip_smoke.P_Q,
                               n_key_docs=chip_smoke.P_KEYS)
    for lr in lrs:
        t0 = time.perf_counter()
        res = chip_smoke.train_p2_retriever(paths, f"{tmp}/lr{lr}", lr,
                                            epochs, torch.device("cuda", 0))
        chip_smoke.say(f"roberta-base at lr {lr}, {epochs} epochs: best "
                       f"train MRR {res['best_mrr']:.4f}, final loss "
                       f"{res['final_loss']:.4f}, "
                       f"{time.perf_counter() - t0:.1f} s [{smi}]")


def reader_seeds(seeds, epochs, init, smi, tmp, device):
    """p3's script at each training seed (see the module's docstring);
    fails if a two-stage read that keeps every chain differs from the
    one-stage read."""
    fs = chip_smoke.load_script("fidelity_trained_torch")
    from multihop_dense_retrieval_tpu_torch.cli import common, train_qa
    from multihop_dense_retrieval_tpu_torch.data.qa_dataset import QADataset
    from multihop_dense_retrieval_tpu_torch.eval.qa_eval import predict
    from multihop_dense_retrieval_tpu_torch.train import qa as tqa

    class Epochs(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("epoch "):
                losses.append(float(msg.split(" loss=")[1].split()[0]))
                ems.append(float(msg.split(" em=")[1].split()[0]))

    logging.getLogger("mdr_torch").addHandler(Epochs())
    train, mkdtemp = train_qa.main, tempfile.mkdtemp
    for seed in seeds:
        work = Path(tmp) / f"seed{seed}"
        work.mkdir()
        losses, ems = [], []
        extra = ["--seed", seed] + (["--checkpoint", init] if init else [])
        train_qa.main = lambda argv: train(argv + extra)
        tempfile.mkdtemp = lambda prefix="": str(work)
        t0 = time.perf_counter()
        with chip_smoke.scoped_env(FIDELITY_EPOCHS=str(epochs),
                                   FIDELITY_WIDTHS="128",
                                   FIDELITY_DEVICE=str(device),
                                   FIDELITY_OUT=str(work / "result.json")):
            try:
                res = fs.main()
                outcome = {"one_stage_em": {
                    o: r["em"] for o, r in res["one_stage"].items()},
                    "bucketed_agreement": {
                        o: r["agreement"]
                        for o, r in res["matrix"]["bucketed"].items()}}
            except AssertionError as e:
                outcome = {"failed": str(e)}
            finally:
                train_qa.main, tempfile.mkdtemp = train, mkdtemp
        cfg = common.READER_PRESETS[os.environ.get("FIDELITY_MODEL",
                                                   "mini")]()
        model = load_reader(cfg, work / "reader" / "checkpoint_best.pt",
                            device)
        tok = common.resolve_reader_tokenizer("hash", cfg)
        rows = [json.loads(x) for x in
                (work / "eval.jsonl").read_text().splitlines()]
        ds = QADataset(tok, rows, max_seq_len=fs.MAX_SEQ, max_q_len=16,
                       num_answer_slots=4, max_sents=8, train=False)
        pred = tqa.make_qa_predict_step(model, max_ans_len=4)
        one = predict(pred, ds, batch_size=8)
        every = predict(pred, ds, batch_size=8,
                        rank_step=tqa.make_qa_rank_step(model), rank_topm=9,
                        rank_width=None)
        same = sum(every["best"]["answers"][q] == a
                   for q, a in one["best"]["answers"].items())
        # eval answers are ans((i + 13) % 97): those past the train rows'
        # ans0..ans(FIDELITY_NQ - 1) were never a training answer
        taught = {json.loads(x)["answer"][0] for x in
                  (work / "train.jsonl").read_text().splitlines()}
        hits = {False: [], True: []}
        for r in rows:
            hits[r["answer"][0] in taught].append(
                one["best"]["answers"][r["_id"]] == r["answer"][0])
        chip_smoke.say(f"reader seed {seed}{' from ' + init if init else ''}"
                       f", {epochs} epochs, {time.perf_counter() - t0:.1f} "
                       f"s: train loss by epoch {losses}, answer EM "
                       f"{ems}; "
                       f"{json.dumps(outcome)}; one-stage answer EM "
                       f"{_mean(hits[True]):.4f} on the {len(hits[True])}"
                       f" questions whose answer was a training answer, "
                       f"{_mean(hits[False]):.4f} on the "
                       f"{len(hits[False])} whose was not; rank_topm 9 "
                       f"bucketed = "
                       f"one-stage on {same} of {len(rows)} answers, chain "
                       f"EM {every['chain_em']:.4f} vs {one['chain_em']:.4f}"
                       f" [{smi}]")
        assert same == len(rows), "rank_topm 9 must read every chain"


def _mean(xs):
    return float(np.mean(xs)) if xs else float("nan")


def load_reader(cfg, path, device):
    from multihop_dense_retrieval_tpu_torch.core import checkpoint
    from multihop_dense_retrieval_tpu_torch.models.reader import QAReader

    model = QAReader(cfg, sp_pred=True)
    model.load_state_dict(checkpoint.restore_pytree(str(path)))
    return model.to(device).eval()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr-sweep", default=None,
                    help="comma-separated learning rates: train p2's "
                         "retriever at each and stop")
    ap.add_argument("--reader-seeds", default=None,
                    help="comma-separated training seeds: run p3's script "
                         "at each and stop")
    ap.add_argument("--reader-init", default="",
                    help="with --reader-seeds: the reader .pt every seed "
                         "starts from")
    ap.add_argument("--epochs", type=int, default=chip_smoke.P_EPOCHS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trained_weights: CUDA is not available", file=sys.stderr)
        return 2
    from multihop_dense_retrieval_tpu_torch.ops import _build, mips

    smi = chip_smoke.nvidia_smi()
    if args.lr_sweep:
        with tempfile.TemporaryDirectory() as tmp:
            lr_sweep(args.lr_sweep.split(","), args.epochs, smi, tmp)
        return 0
    if args.reader_seeds:
        with tempfile.TemporaryDirectory() as tmp:
            reader_seeds(args.reader_seeds.split(","), args.epochs,
                         args.reader_init, smi, tmp, torch.device("cuda", 0))
        return 0
    chip_smoke.track_routes(mips, importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.ops.fused_attention"))
    chip_smoke.say(f"card: {smi}; build {_build.build_all():.1f} s")
    subs = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            subs = chip_smoke.start_p_sub_legs(smi, tmp)
            launches = chip_smoke.run_trained_weights(
                mips, torch.device("cuda", 0), smi, tmp, subs)
        finally:
            chip_smoke.stop_processes(subs)
    for leg, counts in launches.items():
        for name in chip_smoke.MMA_KERNELS:
            taken = counts["routes"].get(name, [])
            assert counts[name] == 0 or taken == ["mma"], \
                f"{name} took {taken} on leg {leg}"
    chip_smoke.say(f"leg p: ok [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
