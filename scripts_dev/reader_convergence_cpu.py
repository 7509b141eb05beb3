"""The fidelity reader's training in both packages on the CPU: how far two
runs of cli/train_qa drift apart, and what a run reaches.

  python scripts_dev/reader_convergence_cpu.py steps [N]
      Both packages' cli/train_qa at scripts_dev/fidelity_trained.py's
      recipe and training rows, from one JAX-made mini reader (seed 42,
      exported to .pt), and the JAX package again from those weights
      times (1 + 1e-7 N(0, 1)): the relative gap of the port's and of the
      perturbed JAX run's loss from the JAX run's, step by step, and
      its median over windows of steps (N steps, 420 by default: two
      epochs).
  python scripts_dev/reader_convergence_cpu.py train SEED [jax|port]
      One package's cli/train_qa at the recipe for 6 epochs with --seed
      SEED (its own seeded weights), then the one-stage read of the
      script's 280 eval questions: answer EM overall, on the questions
      whose answer was a training answer and on those whose was not.

CPU only: the JAX package on its CPU backend, the port with --device cpu.
A train run takes 15-20 minutes, a steps run about as long.  Like the
tests, this script imports both packages.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts_dev"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import fidelity_trained_torch as PF  # noqa: E402
from multihop_dense_retrieval_tpu.cli import export_ckpt as jexport  # noqa: E402
from multihop_dense_retrieval_tpu.cli import train_qa as jtrain_qa  # noqa: E402
from multihop_dense_retrieval_tpu.core import checkpoint as jckpt  # noqa: E402
from multihop_dense_retrieval_tpu.train import qa as jqa  # noqa: E402
from multihop_dense_retrieval_tpu_torch.cli import train_qa as ttrain_qa  # noqa: E402
from multihop_dense_retrieval_tpu_torch.train import qa as tqa  # noqa: E402

NQ, NQ_EVAL, EPOCHS = 48, 40, 6


def make_data(work):
    """The fidelity script's training and eval rows (its seeds and sizes)
    as train.jsonl and eval.jsonl in ``work``."""
    rng = np.random.RandomState(0)
    train = [r for off in PF.OFFSETS
             for r in PF.make_qa_rows(rng, NQ, off, qid_prefix="t")]
    rng.shuffle(train)
    erng = np.random.RandomState(1)
    evals = [r for off in PF.OFFSETS
             for r in PF.make_qa_rows(erng, NQ_EVAL, off, qid_prefix="e",
                                      key_prefix="t", ans_shift=13)]
    PF.write_jsonl(f"{work}/train.jsonl", train)
    PF.write_jsonl(f"{work}/eval.jsonl", evals)
    return train, evals


def recipe(work, seed, epochs):
    """cli/train_qa's arguments in scripts_dev/fidelity_trained.py."""
    return ["--train-file", f"{work}/train.jsonl",
            "--predict-file", f"{work}/eval.jsonl", "--tokenizer", "hash",
            "--model-name", "mini", "--batch-size", "8",
            "--predict-batch-size", "8", "--num-epochs", str(epochs),
            "--learning-rate", "2e-3", "--max-seq-len", str(PF.MAX_SEQ),
            "--max-q-len", "16", "--num-answer-slots", "4",
            "--max-sents", "8", "--neg-num", "4", "--max-ans-len", "4",
            "--warmup-ratio", "0.0", "--seed", str(seed)]


class Enough(Exception):
    pass


def step_losses(qa, cli, argv, n):
    """The loss of each of the first ``n`` steps of ``cli.main(argv)``."""
    make, losses = qa.make_qa_train_step, []

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            if len(losses) == n:
                raise Enough
            state, loss = step(state, batch)
            losses.append(float(loss))
            return state, loss

        return run

    qa.make_qa_train_step = recording
    try:
        cli.main(argv)
    except Enough:
        pass
    finally:
        qa.make_qa_train_step = make
    return np.array(losses)


def steps(work, n):
    make_data(work)
    _, _, params = jtrain_qa.init_reader("mini", "", True, seed=42)
    jckpt.save_pytree(f"{work}/init", params)
    jexport.main(["--checkpoint", f"{work}/init", "--arch", "reader",
                  "--out", f"{work}/init.pt"])
    sd = torch.load(f"{work}/init.pt")
    gen = torch.Generator().manual_seed(0)
    torch.save({k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                if v.is_floating_point() else v for k, v in sd.items()},
               f"{work}/perturbed.pt")
    argv = recipe(work, 42, EPOCHS)
    jax_l = step_losses(jqa, jtrain_qa, argv + ["--checkpoint",
                                                f"{work}/init.pt"], n)
    pert = step_losses(jqa, jtrain_qa, argv + ["--checkpoint",
                                               f"{work}/perturbed.pt"], n)
    port = step_losses(tqa, ttrain_qa, argv + ["--checkpoint",
                                               f"{work}/init.pt",
                                               "--device", "cpu"], n)
    gap_p = np.abs(port - jax_l) / np.abs(jax_l)
    gap_j = np.abs(pert - jax_l) / np.abs(jax_l)
    for i in range(n):
        print(f"step {i}: JAX loss {jax_l[i]:.6f}, port gap {gap_p[i]:.3e},"
              f" perturbed-JAX gap {gap_j[i]:.3e}")
    edges = sorted({0, min(50, n), min(100, n), min(150, n), min(210, n),
                    min(300, n), n})
    for lo, hi in zip(edges, edges[1:]):
        print(f"steps {lo}-{hi - 1}: median relative loss gap from JAX: "
              f"port {np.median(gap_p[lo:hi]):.3e}, perturbed JAX "
              f"{np.median(gap_j[lo:hi]):.3e}", flush=True)


def train(work, seed, package):
    _, evals = make_data(work)
    argv = recipe(work, seed, EPOCHS) + ["--output-dir", f"{work}/reader"]
    t0 = time.perf_counter()
    if package == "jax":
        from multihop_dense_retrieval_tpu.data import HashTokenizer
        from multihop_dense_retrieval_tpu.data.qa_dataset import QADataset
        from multihop_dense_retrieval_tpu.eval.qa_eval import predict
        from multihop_dense_retrieval_tpu.models.reader import QAReader

        jtrain_qa.main(argv)
        params = jckpt.restore_pytree(f"{work}/reader/checkpoint_best")
        model = QAReader(jtrain_qa.READER_PRESETS["mini"](), sp_pred=True)
        step = jqa.make_qa_predict_step(model, max_ans_len=4)
        read = lambda ds: predict(step, params, ds, batch_size=8)  # noqa: E731
    else:
        from multihop_dense_retrieval_tpu_torch.cli.common import (
            READER_PRESETS)
        from multihop_dense_retrieval_tpu_torch.core import checkpoint
        from multihop_dense_retrieval_tpu_torch.data import HashTokenizer
        from multihop_dense_retrieval_tpu_torch.data.qa_dataset import (
            QADataset)
        from multihop_dense_retrieval_tpu_torch.eval.qa_eval import predict
        from multihop_dense_retrieval_tpu_torch.models.reader import QAReader

        ttrain_qa.main(argv + ["--device", "cpu"])
        model = QAReader(READER_PRESETS["mini"](), sp_pred=True)
        model.load_state_dict(checkpoint.restore_pytree(
            f"{work}/reader/checkpoint_best.pt"))
        step = tqa.make_qa_predict_step(model.eval(), max_ans_len=4)
        read = lambda ds: predict(step, ds, batch_size=8)  # noqa: E731
    ds = QADataset(HashTokenizer(vocab_size=50265, roberta_style=False),
                   evals, max_seq_len=PF.MAX_SEQ, max_q_len=16,
                   num_answer_slots=4, max_sents=8, train=False)
    answers = read(ds)["best"]["answers"]
    taught = {json.loads(x)["answer"][0] for x in
              Path(f"{work}/train.jsonl").read_text().splitlines()}
    hits = {True: [], False: []}
    for r in evals:
        hits[r["answer"][0] in taught].append(
            answers[r["_id"]] == r["answer"][0])
    em = np.mean(hits[True] + hits[False])
    print(f"{package} seed {seed}, {EPOCHS} epochs, "
          f"{time.perf_counter() - t0:.0f} s: answer EM {em:.4f}; "
          f"{np.mean(hits[True]):.4f} on the {len(hits[True])} questions "
          f"whose answer was a training answer, {np.mean(hits[False]):.4f} "
          f"on the {len(hits[False])} whose was not", flush=True)


def main(argv):
    with tempfile.TemporaryDirectory() as work:
        if argv[0] == "steps":
            steps(work, int(argv[1]) if len(argv) > 1 else 420)
        elif argv[0] == "train":
            train(work, int(argv[1]), argv[2] if len(argv) > 2 else "jax")
        else:
            raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
