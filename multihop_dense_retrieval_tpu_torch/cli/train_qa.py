"""CLI: train and evaluate the QA reader (the JAX package's
``cli/train_qa.py``; scripts/train_qa.py of the reference).

Train rows are retriever outputs with gold sp chains (see
data/qa_dataset.py).  Each epoch draws a question's gold chain and up to
``--neg-num`` negatives from ``QAGroupSampler``, trains on them in
batches of ``--batch-size`` (bf16 compute over fp32 master weights and
Adam, the optimizer of the retriever trainers), then predicts the dev file
and keeps the best checkpoint by the predict sweep's own selection metric
(joint F1 with sp gold, answer F1 without).

It runs on CUDA unless ``--device`` names another device.  With
``--output-dir`` it writes ``checkpoint_best.pt`` and
``checkpoint_last.pt``: reference ``QAModel`` state dicts (ELECTRA's
pooler at top-level ``pooler.dense``, a BERT reader's at
``encoder.pooler.dense``), which both packages' ``init_reader`` and the
serving CLIs' ``--reader-checkpoint`` read.  ``--checkpoint`` reads such a
``.pt``; an orbax directory raises.  The hash tokenizer is sized to the
reader's vocabulary (``common.resolve_reader_tokenizer``).

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.train_qa \\
      --train-file train.jsonl --predict-file dev.jsonl --output-dir out \\
      --tokenizer hash --model-name tiny --num-epochs 2 [--device cpu]
  python -m multihop_dense_retrieval_tpu_torch.cli.train_qa --do-predict \\
      --predict-file dev.jsonl --checkpoint out/checkpoint_best.pt ...
"""

import argparse
import json

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core.config import RetrieverTrainConfig
from ..core.device import resolve_device
from ..data.qa_dataset import QADataset, QAGroupSampler, qa_collate
from ..eval.qa_eval import predict
from ..models import export
from ..train import qa as TQA
from ..train.trainer import TrainState, make_optimizer, to_device
from . import common


def add_args(p: argparse.ArgumentParser):
    common.add_device_arg(p)
    p.add_argument("--train-file", default="")
    p.add_argument("--predict-file", required=True)
    p.add_argument("--output-dir", default="")
    p.add_argument("--tokenizer", default="hash")
    p.add_argument("--model-name", default="electra-large")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--do-predict", action="store_true")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--predict-batch-size", type=int, default=16)
    p.add_argument("--learning-rate", type=float, default=5e-5)
    p.add_argument("--num-epochs", type=int, default=5)
    p.add_argument("--warmup-ratio", type=float, default=0.1)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--max-q-len", type=int, default=64)
    p.add_argument("--max-ans-len", type=int, default=30)
    p.add_argument("--num-answer-slots", type=int, default=10)
    p.add_argument("--max-sents", type=int, default=40)
    p.add_argument("--neg-num", type=int, default=5)
    p.add_argument("--sp-weight", type=float, default=0.05,
                   help="sp BCE weight.  NOTE: the reference's 0.05 was "
                        "tuned with its offset-multiply inflation (~100x, "
                        "train/qa.py) — sweep upward (1-10) when chasing "
                        "its sp_em/sp_f1")
    p.add_argument("--no-sp", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder layers in the backward pass "
                        "(torch.utils.checkpoint): less activation memory "
                        "for more FLOPs")
    p.add_argument("--fixed-lambda", type=float, default=None)
    common.add_rank_args(p)
    p.add_argument("--seed", type=int, default=42)


def main(argv=None):
    """Train, or with ``--do-predict`` or no ``--train-file`` predict.
    Returns (the predict result, of the best epoch when training; the
    final ``TrainState``, or None when predicting)."""
    p = argparse.ArgumentParser()
    add_args(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    logger = common.setup_logging(args.output_dir or None)
    sp_pred = not args.no_sp
    training = bool(args.train_file) and not args.do_predict
    cfg, model = common.init_reader(
        args.model_name, args.checkpoint, sp_pred, args.seed, device=dev,
        fp32_params=training, remat=args.remat, train=training)
    tok = common.resolve_reader_tokenizer(args.tokenizer, cfg)
    kw = dict(max_seq_len=args.max_seq_len, max_q_len=args.max_q_len,
              num_answer_slots=args.num_answer_slots, max_sents=args.max_sents)
    eval_ds = QADataset(tok, args.predict_file, train=False, **kw)
    pred_step = TQA.make_qa_predict_step(model, max_ans_len=args.max_ans_len)
    lambdas = [args.fixed_lambda] if args.fixed_lambda is not None else None
    pkw = dict(batch_size=args.predict_batch_size, sp_pred=sp_pred,
               lambdas=lambdas)

    if not training:
        rank_kw = {}
        if args.rank_topm:
            rank_kw = dict(rank_step=TQA.make_qa_rank_step(model),
                           rank_topm=args.rank_topm,
                           rank_width=args.rank_width)
        res = predict(pred_step, eval_ds, **pkw, **rank_kw)
        logger.info("chain ranking em: %.4f", res["chain_em"])
        best = {k: v for k, v in res["best"].items()
                if k not in ("answers", "sp")}
        logger.info("best: %s", json.dumps(best))
        print(json.dumps({"chain_em": res["chain_em"], **best}))
        return res, None

    train_ds = QADataset(tok, args.train_file, train=True, **kw)
    sampler = QAGroupSampler(train_ds, neg_num=args.neg_num, seed=args.seed)
    steps_per_epoch = max(len(sampler) // args.batch_size, 1)
    tcfg = RetrieverTrainConfig(learning_rate=args.learning_rate,
                                warmup_ratio=args.warmup_ratio)
    state = TrainState.create(model, make_optimizer(
        tcfg, steps_per_epoch * args.num_epochs))
    train_step = TQA.make_qa_train_step(sp_weight=args.sp_weight,
                                        sp_pred=sp_pred)
    electra = "bert" not in args.model_name

    def save(name):
        ckpt.save_pytree(f"{args.output_dir}/{name}.pt",
                         export.reader_state_dict(model, electra=electra))

    best_metric, result = -1.0, None
    for epoch in range(args.num_epochs):
        idxs = sampler.epoch_indices()
        if len(idxs) < args.batch_size:
            raise ValueError(
                f"epoch has {len(idxs)} sampled rows < batch size "
                f"{args.batch_size}: zero optimizer steps would run (and "
                "untrained weights would be saved) — shrink --batch-size "
                "or add training data")
        losses = []
        model.train()
        for s in range(0, len(idxs) - args.batch_size + 1, args.batch_size):
            batch = qa_collate([train_ds[i]
                                for i in idxs[s:s + args.batch_size]])
            state, loss = train_step(state, to_device(batch["net_inputs"],
                                                      dev))
            # kept on the device: a float() here would sync every step
            losses.append(loss)
        model.eval()
        res = predict(pred_step, eval_ds, **pkw)
        # best-checkpoint selection follows predict's own sweep metric:
        # joint F1 when sp gold is live, answer F1 otherwise
        sel = res["best"]["selection_metric"]
        logger.info("epoch %d: loss=%.4f chain_em=%.4f em=%.4f f1=%.4f "
                    "joint_f1=%.4f", epoch,
                    float(np.mean(torch.stack(losses).float().cpu().numpy())),
                    res["chain_em"], res["best"]["em"], res["best"]["f1"],
                    res["best"]["joint_f1"])
        if res["best"][sel] > best_metric:
            best_metric = res["best"][sel]
            result = res
            if args.output_dir:
                save("checkpoint_best")
        if args.output_dir:
            save("checkpoint_last")
    logger.info("training finished, best %s=%.4f",
                result["best"]["selection_metric"] if result else "metric",
                best_metric)
    return result, state


if __name__ == "__main__":
    main()
