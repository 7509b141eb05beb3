"""CLI: stage-2 memory-bank finetuning (the JAX package's
``cli/train_momentum.py``; scripts/train_momentum.py of the reference).

Both encoders start from a stage-1 checkpoint (``--init-checkpoint``, a
``checkpoint_best.pt`` of ``train_retriever``); encoder_q trains against
the frozen encoder_k with a (K, h) queue of extra negatives
(``--queue-size``).  ``--enable-ema`` turns on the MoCo EMA update
(``--momentum-m``) that the reference ships commented out.  ``--fever``
(or "fever" in the train file's path) trains on FEVER multi-hop claims.
Only encoder_q is written to ``checkpoint_*.pt``.  Runs on CUDA unless
``--device`` names another device; ``--data-parallel`` as in
``cli/train_retriever`` (the global batch's key vectors are enqueued).

Usage:
  python -m multihop_dense_retrieval_tpu_torch.cli.train_momentum \\
      --train-file train.jsonl --predict-file dev.jsonl \\
      --init-checkpoint stage1/checkpoint_best.pt --output-dir out \\
      --tokenizer hash --model-name tiny [--device cpu]
"""

import argparse
import dataclasses

from ..train.trainer import RetrieverTrainer
from . import common
from .train_retriever import add_train_args, build


def main(argv=None):
    """Train; returns (the run's result, the trainer at its end)."""
    p = argparse.ArgumentParser()
    add_train_args(p)
    p.add_argument("--queue-size", type=int, default=76800)
    p.add_argument("--momentum-m", type=float, default=0.999)
    p.add_argument("--enable-ema", action="store_true")
    p.add_argument("--fever", action="store_true",
                   help="FEVER multi-hop claims (the reference auto-detects "
                        "'fever' in the path, train_momentum.py:86-91)")
    args = p.parse_args(argv)
    logger = common.setup_logging(args.output_dir or None)
    make_datasets = None
    if args.fever or "fever" in args.train_file.lower():
        from ..data.unified_dataset import FeverDataset

        def make_datasets(tok, kw):
            return (FeverDataset(tok, args.train_file, train=True,
                                 seed=args.seed, **kw),
                    FeverDataset(tok, args.predict_file, **kw))
    cfg, model, train_loader, eval_loader, mesh = build(
        args, make_datasets=make_datasets)
    logger.info("training on %s", mesh)
    cfg = dataclasses.replace(cfg, momentum=True, queue_size=args.queue_size,
                              momentum_m=args.momentum_m)
    trainer = RetrieverTrainer(model, cfg, train_loader, eval_loader,
                               mesh=mesh, output_dir=args.output_dir or None,
                               log_fn=logger.info, enable_ema=args.enable_ema)
    result = trainer.run()
    logger.info("momentum training finished: %s", result)
    return result, trainer


if __name__ == "__main__":
    main()
