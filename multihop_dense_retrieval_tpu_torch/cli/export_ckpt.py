"""CLI: export a port checkpoint to a reference torch state dict (the JAX
package's ``cli/export_ckpt.py``, for the port's ``.pt`` files).

The reference loads the result back with its strict ``load_saved``
(mdr/retrieval/utils/utils.py:10-22), so a model trained with the port
drops into the reference's eval scripts unchanged:

    python -m multihop_dense_retrieval_tpu_torch.cli.export_ckpt \\
        --checkpoint runs/mhop/checkpoint_best.pt --arch mhop \\
        --out q_encoder.pt

``--checkpoint`` is a ``checkpoint_*.pt`` of the port's trainers, or the
preemption state file (``preempt/trainer_state``), whose model parameters
are exported (encoder_q for the momentum stage).  Arches map to reference
modules: mhop → RobertaRetriever (also the momentum trainer's encoder_q
and RobertaRetrieverSingle, the same layout), unified → UnifiedRetriever,
reader → ELECTRA QAModel, reader-bert → BERT QAModel (the HF pooler at
``encoder.pooler.dense``).  An orbax directory is the JAX package's format:
export it with the JAX package's ``cli/export_ckpt``.
"""

import argparse
import os

import torch

from ..models import export as ex
from ..models.convert import unified_state_dict_from_reference


def load_params(checkpoint: str) -> dict:
    """The model parameters of a port checkpoint file (``module.``
    prefixes stripped)."""
    if os.path.isdir(checkpoint):
        raise SystemExit(
            f"{checkpoint!r} is a directory: orbax checkpoints are the JAX "
            "package's; export them with "
            "python -m multihop_dense_retrieval_tpu.cli.export_ckpt")
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if "params" in sd and "opt_state" in sd:      # the preemption state
        sd = sd["params"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def export_params(sd: dict, arch: str) -> dict:
    if arch == "mhop":
        return ex.retriever_state_dict(sd)
    if arch == "unified":
        if any(k.startswith(("encoder_c.", "stop.")) for k in sd):
            # a trainer checkpoint is in the reference layout already
            sd = unified_state_dict_from_reference(sd)[0]
        return ex.unified_state_dict(sd)
    return ex.reader_state_dict(sd, electra=arch == "reader")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="a port .pt: checkpoint_best.pt / checkpoint_last.pt "
                        "or the preemption state file")
    p.add_argument("--arch", required=True,
                   choices=["mhop", "unified", "reader", "reader-bert"])
    p.add_argument("--out", required=True, help="output .pt path")
    args = p.parse_args(argv)

    sd = export_params(load_params(args.checkpoint), args.arch)
    ex.save_state_dict(sd, args.out)
    print(f"wrote {len(sd)} tensors to {args.out}")
    return sd


if __name__ == "__main__":
    main()
