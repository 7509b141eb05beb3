"""Runnable end-to-end tour of the PyTorch port on self-generated data.

The port's counterpart of ``examples/quickstart.py``: the reference's
published workflow (train the retriever, momentum-finetune it, encode the
corpus, run 2-hop retrieval, train the reader, answer questions end to
end, export the retriever) through the port's CLIs, invoked in-process,
on the same tiny synthetic HotpotQA-shaped data, the deterministic hash
tokenizer and the ``tiny`` model preset.

    python examples/quickstart_torch.py --workdir /tmp/mdr_torch_quickstart
    python examples/quickstart_torch.py --device cpu   # no card needed

Two things differ from the JAX tour:
  * checkpoints are ``.pt`` files (``checkpoint_best.pt``), not orbax
    directories;
  * ``--device`` (default ``cuda``) replaces ``--cpu`` and is passed to
    every step; without a card, a run that does not ask for the CPU fails
    as the CLIs do.

The two trainers take the JAX tour's ``--data-parallel 2``: each batch of
4 is split over two data entries, two cards where the host shows them,
else the one device twice (``cuda:0`` for the bare ``cuda``, which would
take the cards).

Each step can be re-run standalone with real data: swap ``--tokenizer
hash --model-name tiny`` for a local HF tokenizer path and
``roberta-base`` / ``electra-large``, and point the data flags at
HotpotQA files.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

# self-locating: runnable from any cwd without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORDS = [f"w{i}" for i in range(600)]


def _text(rng, lo=5, hi=40):
    return " ".join(rng.choice(WORDS, size=rng.randint(lo, hi)))


def make_data(workdir: str, n_docs=32, n_rows=8):
    """Tiny HotpotQA-shaped corpus + multi-hop training rows + QA rows."""
    rng = np.random.RandomState(0)
    docs = [{"title": f"Title {i}", "text": _text(rng)}
            for i in range(n_docs)]
    mhop = []
    for i in range(n_rows):
        idxs = rng.choice(n_docs, size=6, replace=False)
        pos = [dict(docs[idxs[0]]), dict(docs[idxs[1]])]
        mhop.append({
            "_id": f"q{i}",
            "question": f"which thing links {_text(rng, 3, 8)}?",
            "type": "bridge" if i % 2 == 0 else "comparison",
            "pos_paras": pos,
            "neg_paras": [dict(docs[j]) for j in idxs[2:]],
            "bridge": pos[1]["title"],
            "sp": [pos[0]["title"], pos[1]["title"]],
            "answer": ["yes"],
        })
    qa = []
    for i in range(n_rows // 2):
        sp = [{"title": f"G{i}a", "sents": ["the answer is paris ."],
               "sp_sent_ids": [0]},
              {"title": f"G{i}b", "sents": ["another sentence here ."],
               "sp_sent_ids": []}]
        negs = [[{"title": f"N{i}{j}a", "sents": ["noise text one ."]},
                 {"title": f"N{i}{j}b", "sents": ["noise text two ."]}]
                for j in range(3)]
        qa.append({"question": f"where is it {i}?", "_id": f"qa{i}",
                   "answer": ["paris"], "type": "bridge", "sp": sp,
                   "candidate_chains": [sp] + negs})

    paths = {}
    for name, rows in [("corpus", docs), ("mhop", mhop), ("qa", qa)]:
        paths[name] = os.path.join(workdir, f"{name}.jsonl")
        with open(paths[name], "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="",
                   help="where data/checkpoints/index land (default: tmp)")
    p.add_argument("--device", default="cuda",
                   help="torch device of every step (cpu: the kernels' "
                        "plain versions)")
    args = p.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="mdr_torch_quickstart_")
    os.makedirs(workdir, exist_ok=True)

    from multihop_dense_retrieval_tpu_torch.cli import (
        encode_corpus, end2end, eval_mhop_retrieval, export_ckpt,
        train_momentum, train_qa, train_retriever)

    paths = make_data(workdir)
    dev = ["--device", args.device]
    tiny = ["--tokenizer", "hash", "--model-name", "tiny"] + dev
    # the per-step batch must divide the data axis; the bare cuda takes
    # the visible cards, a named device repeats
    train_dev = args.device
    if args.device == "cuda" and torch.cuda.device_count() < 2:
        train_dev = "cuda:0"
    dp = ["--tokenizer", "hash", "--model-name", "tiny", "--device",
          train_dev, "--data-parallel", "2"]
    lens = ["--max-q-len", "16", "--max-q-sp-len", "48", "--max-c-len", "32"]
    summary = {"workdir": workdir}

    print("== 1/7 train the multi-hop retriever (contrastive, stage 1)")
    stage1 = os.path.join(workdir, "stage1")
    _, trainer = train_retriever.main([
        "--train-file", paths["mhop"], "--predict-file", paths["mhop"],
        "--output-dir", stage1, "--train-batch-size", "4",
        "--predict-batch-size", "4", "--num-epochs", "1",
        "--learning-rate", "1e-4"] + dp + lens)
    summary["train_mesh"] = str(trainer.mesh)
    retriever_ckpt = os.path.join(stage1, "checkpoint_best.pt")

    print("== 2/7 momentum finetuning (stage 2, memory-bank negatives)")
    stage2 = os.path.join(workdir, "stage2")
    res, _ = train_momentum.main([
        "--train-file", paths["mhop"], "--predict-file", paths["mhop"],
        "--init-checkpoint", retriever_ckpt, "--output-dir", stage2,
        "--queue-size", "32", "--train-batch-size", "4",
        "--predict-batch-size", "4", "--num-epochs", "1",
        "--learning-rate", "1e-4"] + dp + lens)
    summary["momentum_final_loss"] = res["final_loss"]

    print("== 3/7 encode the corpus into a dense index + token store")
    index_dir = os.path.join(workdir, "index")
    encode_corpus.main([paths["corpus"], index_dir,
                        "--checkpoint", retriever_ckpt, "--batch-size", "8",
                        "--chunk-rows", "16", "--max-c-len", "32"] + tiny)

    print("== 4/7 2-hop beam-search retrieval eval")
    eval_mhop_retrieval.main([paths["mhop"], index_dir,
                              "--checkpoint", retriever_ckpt,
                              "--beam-size", "3", "--topk", "3",
                              "--batch-size", "4", "--chunk-rows", "16",
                              "--max-q-len", "16", "--max-q-sp-len", "48"]
                             + tiny)

    print("== 5/7 train the span/SP reader")
    qa_dir = os.path.join(workdir, "reader")
    train_qa.main([
        "--train-file", paths["qa"], "--predict-file", paths["qa"],
        "--output-dir", qa_dir, "--tokenizer", "hash",
        "--model-name", "tiny", "--batch-size", "4",
        "--predict-batch-size", "4", "--num-epochs", "1",
        "--learning-rate", "1e-3", "--max-seq-len", "96",
        "--max-q-len", "12", "--num-answer-slots", "4", "--max-sents", "8",
        "--neg-num", "3", "--max-ans-len", "8", "--warmup-ratio", "0.0"]
        + dev)
    reader_ckpt = os.path.join(qa_dir, "checkpoint_best.pt")

    print("== 6/7 end-to-end question answering (retrieve → read → answer)")
    res = end2end.main([paths["mhop"], index_dir, "--tokenizer", "hash",
                        "--retriever-model", "tiny",
                        "--retriever-checkpoint", retriever_ckpt,
                        "--reader-model", "tiny",
                        "--reader-checkpoint", reader_ckpt,
                        "--beam-size", "2", "--topk", "2",
                        "--batch-size", "4", "--max-q-len", "16",
                        "--max-q-sp-len", "48", "--max-seq-len", "128",
                        "--chunk-rows", "16", "--max-ans-len", "8"] + dev)
    summary["end2end_n"] = res["n"]
    summary["answer_em"] = res["answer_em"]

    print("== 7/7 export the trained retriever to a reference torch .pt")
    pt_path = os.path.join(workdir, "q_encoder.pt")
    export_ckpt.main(["--checkpoint", retriever_ckpt, "--arch", "mhop",
                      "--out", pt_path])
    summary["exported_pt"] = pt_path

    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
