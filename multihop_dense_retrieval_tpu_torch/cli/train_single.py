"""CLI: single-hop (DPR-style) retriever training (the JAX package's
``cli/train_single.py``; a working stand-in for the reference's
mdr/retrieval/train_single.py, whose ``loss_single`` import was deleted
upstream).  Trains a ``SingleRetriever`` with the in-batch DPR loss.

``--separate-encoders`` gives the question its own tower; with
``--init-checkpoint`` (a one-tower ``.pt``, e.g. a ``checkpoint_best.pt``)
both towers start from the checkpoint.  ``--momentum`` adds a memory bank
of token rows that the current encoder re-encodes every step
(``--queue-size``); ``--fever`` trains on FEVER single-evidence claims.
It runs on CUDA unless ``--device`` names another device, with fp32
master weights and Adam, the encoder computing in bf16.  With
``--output-dir`` it writes ``checkpoint_last.pt`` / ``checkpoint_best.pt``
and the preemption state under ``preempt/``.  ``--data-parallel`` as in
``cli/train_retriever``: each batch split over the data entries, the
in-batch negatives global, the token queue fed the global batch's rows.

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.train_single \\
      --train-file t.jsonl --predict-file d.jsonl --tokenizer hash \\
      --model-name tiny --num-epochs 2 [--fever] [--separate-encoders] \\
      [--device cpu]
"""

import argparse

import torch

from ..core.config import RetrieverTrainConfig
from ..core.device import resolve_device
from ..data import BatchLoader
from ..data.sp_datasets import SPDataset, sp_collate
from ..models import SingleRetriever, reference_init_
from ..train import trainer as T
from . import common


def main(argv=None):
    """Train; returns (the run's result, the trainer at its end)."""
    p = argparse.ArgumentParser()
    common.add_device_arg(p)
    p.add_argument("--train-file", required=True)
    p.add_argument("--predict-file", required=True)
    p.add_argument("--output-dir", default="")
    p.add_argument("--tokenizer", default="hash")
    p.add_argument("--model-name", default="roberta-base")
    p.add_argument("--init-checkpoint", default="")
    p.add_argument("--train-batch-size", type=int, default=128)
    p.add_argument("--predict-batch-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=2e-5)
    p.add_argument("--num-epochs", type=int, default=40)
    p.add_argument("--warmup-ratio", type=float, default=0.1)
    p.add_argument("--max-q-len", type=int, default=50)
    p.add_argument("--max-c-len", type=int, default=300)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--fever", action="store_true")
    p.add_argument("--separate-encoders", action="store_true",
                   help="separate q/ctx towers (BertRetrieverSingle parity)")
    p.add_argument("--momentum", action="store_true",
                   help="token-queue memory bank re-encoded with the "
                        "current encoder each step (MomentumRetriever "
                        "parity)")
    p.add_argument("--queue-size", type=int, default=256)
    p.add_argument("--data-parallel", type=int, default=None,
                   help="entries of the data axis (default: every visible "
                        "card for --device cuda, else 1); a named device "
                        "repeats")
    args = p.parse_args(argv)
    mesh = common.train_mesh(args.device, args.data_parallel)
    dev = resolve_device(args.device)

    logger = common.setup_logging(args.output_dir or None)
    enc_cfg = common.resolve_encoder_config(args.model_name)
    tok = common.resolve_tokenizer(args.tokenizer)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = reference_init_(SingleRetriever(
            enc_cfg, shared=not args.separate_encoders, fp32_params=True))
    if args.init_checkpoint:
        # the checkpoint holds one tower (encoder, project): loaded over the
        # seeded weights, and with --separate-encoders the question tower
        # starts from it too
        missing, unexpected = model.load_state_dict(
            common.load_retriever_params(args.init_checkpoint), strict=False)
        if unexpected:
            raise ValueError(f"{args.init_checkpoint}: unexpected keys "
                             f"{unexpected[:4]}")
        if args.separate_encoders:
            model.encoder_q.load_state_dict(model.encoder.state_dict())
            model.project_q.load_state_dict(model.project.state_dict())
    model = model.to(dev)

    kw = dict(max_q_len=args.max_q_len, max_c_len=args.max_c_len,
              fever=args.fever)
    train_ds = SPDataset(tok, args.train_file, train=True, seed=args.seed,
                         **kw)
    eval_ds = SPDataset(tok, args.predict_file, **kw)
    train_loader = BatchLoader(train_ds, args.train_batch_size, shuffle=True,
                               seed=args.seed, collate=sp_collate)
    eval_loader = BatchLoader(eval_ds, args.predict_batch_size,
                              collate=sp_collate)
    cfg = RetrieverTrainConfig(
        batch_size=args.train_batch_size,
        eval_batch_size=args.predict_batch_size,
        learning_rate=args.learning_rate, num_epochs=args.num_epochs,
        warmup_ratio=args.warmup_ratio, seed=args.seed,
        max_q_len=args.max_q_len, max_c_len=args.max_c_len)
    logger.info("training on %s", mesh)
    trainer = T.RetrieverTrainer(model, cfg, train_loader, eval_loader,
                                 mesh=mesh, output_dir=args.output_dir or None,
                                 log_fn=logger.info)
    # the single-hop steps in place of the multi-hop ones
    if args.momentum:
        trainer.state = T.TokenQueueTrainState.create(
            model, trainer.tx, queue_size=args.queue_size,
            max_c_len=args.max_c_len, cls_id=tok.spec.cls_id,
            sep_id=tok.spec.sep_id)
        trainer.train_step = T.make_single_momentum_train_step(mesh=mesh)
    else:
        trainer.train_step = T.make_train_step(task="single", mesh=mesh)
    trainer.eval_step = T.make_eval_step(task="single", mesh=mesh)
    result = trainer.run()
    logger.info("single-hop training finished: %s", result)
    return result, trainer


if __name__ == "__main__":
    main()
