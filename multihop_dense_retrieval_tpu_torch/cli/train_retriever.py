"""CLI: train the multi-hop retriever, stage 1 with in-batch negatives (the
JAX package's ``cli/train_retriever.py``; scripts/train_mhop.py of the
reference).  ``--unified`` trains the variable-hop UnifiedRetriever with
its stop head on a UnifiedDataset.

It runs on CUDA unless ``--device`` names another device: fp32 master
weights and Adam state, the encoder computing in bf16.  With
``--output-dir`` it writes ``checkpoint_last.pt`` and
``checkpoint_best.pt`` (state dicts in the reference layout, which
``train_momentum --init-checkpoint`` and the serving CLIs' ``--checkpoint``
read), TensorBoard scalars under ``tb/`` and the preemption state under
``preempt/`` (a rerun with the same directory resumes).
``--data-parallel N`` splits each batch over N data entries
(``train/trainer.py::DataParallel``: the in-batch negatives stay global):
the first N visible cards for the bare ``--device cuda`` (default: every
card), a named device (``cuda:0``, ``cpu``) N times; the batch sizes must
divide N.  The CLI runs in one process (under ``cli/pod`` it raises).

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.train_retriever \\
      --train-file train.jsonl --predict-file dev.jsonl --output-dir out \\
      --tokenizer hash --model-name tiny --num-epochs 2 [--device cpu]
"""

import argparse

from ..core.config import RetrieverTrainConfig
from ..core.device import resolve_device
from ..data import BatchLoader, MhopDataset
from ..train.trainer import RetrieverTrainer
from . import common


def add_train_args(p: argparse.ArgumentParser):
    common.add_device_arg(p)
    p.add_argument("--train-file", required=True)
    p.add_argument("--predict-file", required=True)
    p.add_argument("--output-dir", default="")
    p.add_argument("--tokenizer", default="hash")
    p.add_argument("--model-name", default="roberta-base")
    p.add_argument("--init-checkpoint", default="")
    p.add_argument("--train-batch-size", type=int, default=150)
    p.add_argument("--predict-batch-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=2e-5)
    p.add_argument("--num-epochs", type=int, default=50)
    p.add_argument("--warmup-ratio", type=float, default=0.1)
    p.add_argument("--max-grad-norm", type=float, default=2.0)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--gradient-accumulation", type=int, default=1)
    p.add_argument("--max-q-len", type=int, default=70)
    p.add_argument("--max-q-sp-len", type=int, default=350)
    p.add_argument("--max-c-len", type=int, default=300)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--data-parallel", type=int, default=None,
                   help="entries of the data axis (default: every visible "
                        "card for --device cuda, else 1); a named device "
                        "repeats")
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder layers in the backward pass "
                        "(torch.utils.checkpoint): ~33%% more FLOPs for "
                        "O(num_layers) less activation memory — use for "
                        "production batch sizes; not with --unified")
    p.add_argument("--unified", action="store_true",
                   help="variable-hop training with the stop head "
                        "(UnifiedRetriever + UnifiedDataset)")


def build(args, unified: bool = None, make_datasets=None):
    """Shared trainer scaffolding: (cfg, model, train_loader,
    eval_loader, mesh).  ``make_datasets(tok, kw) -> (train_ds, eval_ds)``
    overrides the dataset choice (the FEVER momentum CLI)."""
    mesh = common.train_mesh(args.device, args.data_parallel)
    dev = resolve_device(args.device)
    if unified is None:
        unified = getattr(args, "unified", False)
    cfg = RetrieverTrainConfig(
        batch_size=args.train_batch_size,
        eval_batch_size=args.predict_batch_size,
        learning_rate=args.learning_rate, num_epochs=args.num_epochs,
        warmup_ratio=args.warmup_ratio, max_grad_norm=args.max_grad_norm,
        weight_decay=args.weight_decay, seed=args.seed,
        gradient_accumulation=args.gradient_accumulation,
        max_q_len=args.max_q_len, max_q_sp_len=args.max_q_sp_len,
        max_c_len=args.max_c_len, unified=unified)
    enc_cfg = common.resolve_encoder_config(args.model_name)
    tok = common.resolve_tokenizer(args.tokenizer)
    model = common.init_retriever(enc_cfg, unified=unified,
                                  checkpoint=args.init_checkpoint,
                                  seed=args.seed, device=dev,
                                  fp32_params=True, remat=args.remat)
    kw = dict(max_q_len=cfg.max_q_len, max_q_sp_len=cfg.max_q_sp_len,
              max_c_len=cfg.max_c_len)
    if make_datasets is not None:
        train_ds, eval_ds = make_datasets(tok, kw)
    elif unified:
        from ..data.unified_dataset import UnifiedDataset

        train_ds = UnifiedDataset(tok, args.train_file, train=True,
                                  seed=args.seed, **kw)
        eval_ds = UnifiedDataset(tok, args.predict_file, **kw)
    else:
        train_ds = MhopDataset(tok, args.train_file, train=True,
                               seed=args.seed, **kw)
        eval_ds = MhopDataset(tok, args.predict_file, **kw)
    train_loader = BatchLoader(train_ds, cfg.batch_size, shuffle=True,
                               seed=args.seed)
    eval_loader = BatchLoader(eval_ds, cfg.eval_batch_size, shuffle=False)
    return cfg, model, train_loader, eval_loader, mesh


def main(argv=None):
    """Train; returns (the run's result, the trainer at its end)."""
    p = argparse.ArgumentParser()
    add_train_args(p)
    args = p.parse_args(argv)
    logger = common.setup_logging(args.output_dir or None)
    cfg, model, train_loader, eval_loader, mesh = build(args)
    logger.info("training on %s", mesh)
    trainer = RetrieverTrainer(model, cfg, train_loader, eval_loader,
                               mesh=mesh, output_dir=args.output_dir or None,
                               log_fn=logger.info)
    result = trainer.run()
    logger.info("training finished: %s", result)
    return result, trainer


if __name__ == "__main__":
    main()
