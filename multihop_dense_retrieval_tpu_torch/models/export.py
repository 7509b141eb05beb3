"""Export the port's models to reference-layout torch state dicts (the JAX
package's ``models/export.py``, for PyTorch modules).

The reference loads checkpoints with a strict ``load_state_dict``
(``load_saved``, mdr/retrieval/utils/utils.py:10-22), so each exporter
emits the exact key set the reference module owns, and the same key set
as the JAX package's exporter for the same architecture, every value
fp32:

  * ``retriever_state_dict`` → RobertaRetriever / RobertaRetrieverSingle:
    ``encoder.*`` + ``project.0`` / ``project.1``, and a zero
    ``encoder.pooler.dense`` (the HF model owns a tanh pooler that the
    retriever never reads; zeros satisfy the strict load without inventing
    weights that look trained);
  * ``unified_state_dict`` → UnifiedRetriever: the transformer under
    ``encoder_c.``, its real pooler at ``encoder_c.pooler.dense``, the
    ``stop`` head, ``project`` only when the model has one.  A model whose
    stop head reads the raw CLS (``stop_on_pooled=False``) is refused: the
    reference's stop head always reads the tanh pooler;
  * ``reader_state_dict`` → QAModel: the reference adds its own pooler at
    top-level ``pooler.dense`` for ELECTRA; a BERT reader keeps the HF
    pooler at ``encoder.pooler.dense``.

Each takes a port model or its state dict under the port's names (the
reader's are the reference's).  The retriever trainers' own
``checkpoint_*.pt`` files carry no synthetic pooler; export is the one
place that adds it.
"""

from __future__ import annotations

from typing import Dict, Union

import torch
import torch.nn as nn

from ..core import checkpoint as ckpt

StateDict = Dict[str, torch.Tensor]

# the port's UnifiedRetriever names → the reference's
UNIFIED_RENAMES = (("encoder.", "encoder_c."), ("stop_head.", "stop."),
                   ("pooler.", "encoder_c.pooler.dense."))


def _sd(model: Union[nn.Module, StateDict]) -> StateDict:
    return model.state_dict() if isinstance(model, nn.Module) else model


def _fp32(sd: StateDict) -> StateDict:
    return {k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in sd.items()}


def unified_reference_names(sd: StateDict) -> StateDict:
    """A UnifiedRetriever state dict under the reference's names (no key
    added or dropped)."""
    out = {}
    for key, val in sd.items():
        for old, new in UNIFIED_RENAMES:
            if key.startswith(old):
                key = new + key[len(old):]
                break
        out[key] = val
    return out


def retriever_state_dict(model: Union[nn.Module, StateDict]) -> StateDict:
    """MhopRetriever / shared SingleRetriever → RobertaRetriever state
    dict (an unshared SingleRetriever exports its passage tower, as the
    JAX exporter does)."""
    sd = _sd(model)
    out = _fp32({k: v for k, v in sd.items()
                 if k.startswith(("encoder.", "project."))})
    h = out["encoder.encoder.layer.0.output.dense.weight"].shape[0]
    out["encoder.pooler.dense.weight"] = torch.zeros((h, h))
    out["encoder.pooler.dense.bias"] = torch.zeros((h,))
    return out


def unified_state_dict(model: Union[nn.Module, StateDict]) -> StateDict:
    """UnifiedRetriever → the reference UnifiedRetriever state dict."""
    sd = _sd(model)
    if "pooler.weight" not in sd:
        raise ValueError(
            "this UnifiedRetriever was trained with stop_on_pooled=False "
            "(stop head reads raw CLS); the reference's stop head always "
            "reads the tanh pooler, so an exported checkpoint would load "
            "but produce constant stop logits.  Re-train with "
            "stop_on_pooled=True to export for the reference stack.")
    return _fp32(unified_reference_names(sd))


def reader_state_dict(model: Union[nn.Module, StateDict],
                      electra: bool = True) -> StateDict:
    """QAReader → QAModel state dict; ``electra=False`` (BERT readers) puts
    the pooler at the HF pooler's ``encoder.pooler.dense``."""
    out = {}
    for key, val in _sd(model).items():
        if key.startswith(("pooler.dense.", "encoder.pooler.dense.")):
            part = key.rsplit(".", 1)[1]
            key = ("pooler.dense." if electra
                   else "encoder.pooler.dense.") + part
        out[key] = val
    return _fp32(out)


def save_state_dict(sd: StateDict, path: str) -> None:
    """Write a state dict as a torch ``.pt`` file, fp32."""
    ckpt.save_pytree(path, _fp32(sd))
