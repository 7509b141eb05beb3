"""Carry retriever and reader weights from a Flax parameter tree into the
port.

``retriever_state_dict_from_jax`` takes the JAX package's MhopRetriever
parameter tree with numpy leaves (``jax.device_get(params)``, with or
without the outer ``{"params": ...}``) and returns a state dict under the
reference's names: ``encoder.*`` (HF layout), ``project.0``, ``project.1``.
It is the port's own copy of the mapping in the JAX package's
``models/export.py``; no pooler is synthesized because the port's module
has none.  Load the result with ``MhopRetriever.load_state_dict`` (or
``MultiVectorCtxEncoder.load_state_dict``: the same names).

``reader_state_dict_from_jax`` does the same for the JAX QAReader under
the reference ``QAModel``'s names: ``encoder.*`` (HF ELECTRA/BERT, with
``encoder.embeddings_project`` where the embeddings are narrower than the
hidden size), the top-level ``pooler.dense`` that the reference adds to
ELECTRA, ``qa_outputs``, ``rank`` and ``sp``.  The JAX package's
``reader_ckpt_to_flax`` reads these names back, and ``QAReader`` loads
them directly.

``unified_state_dict_from_jax`` does it for the JAX UnifiedRetriever under
the port's ``UnifiedRetriever`` names (``encoder.*``, ``project.0/1``
where the tree has a projection head, ``stop_head``, ``pooler``), and
``unified_state_dict_from_reference`` maps a reference UnifiedRetriever
``.pt`` onto them, as the JAX package's ``unified_ckpt_to_flax`` reads
it: the transformer under ``encoder_c.`` (or ``encoder.``), the head
``stop``, ``project.0/1`` only for roberta names, and the HF pooler
``encoder_c.pooler.dense`` feeding the stop head.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(out: StateDict, name: str, p: Dict) -> None:
    # Flax Dense kernel is (in, out); torch Linear weight is (out, in)
    out[f"{name}.weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
    out[f"{name}.bias"] = _np(p["bias"])


def _layer_norm(out: StateDict, name: str, p: Dict) -> None:
    out[f"{name}.weight"] = _np(p["scale"])
    out[f"{name}.bias"] = _np(p["bias"])


def _qkv(out: StateDict, name: str, p: Dict) -> None:
    k = _np(p["kernel"])                      # (in, heads, head_dim)
    out[f"{name}.weight"] = np.ascontiguousarray(k.reshape(k.shape[0], -1).T)
    out[f"{name}.bias"] = _np(p["bias"]).reshape(-1)


def _attn_out(out: StateDict, name: str, p: Dict) -> None:
    k = _np(p["kernel"])                      # (heads, head_dim, out)
    out[f"{name}.weight"] = np.ascontiguousarray(k.reshape(-1, k.shape[-1]).T)
    out[f"{name}.bias"] = _np(p["bias"])


def encoder_state_dict_from_jax(enc: Dict, prefix: str = "") -> StateDict:
    """Flax TransformerEncoder params → HF BERT/RoBERTa model names."""
    p = prefix
    out: StateDict = {}
    emb = enc["embeddings"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{p}embeddings.{name}.weight"] = _np(emb[name]["embedding"])
    _layer_norm(out, f"{p}embeddings.LayerNorm", emb["layer_norm"])
    if "embeddings_project" in emb:
        # HF ElectraModel.embeddings_project, beside the embeddings
        _dense(out, f"{p}embeddings_project", emb["embeddings_project"])
    i = 0
    while f"layer_{i}" in enc:
        lp = f"{p}encoder.layer.{i}."
        layer = enc[f"layer_{i}"]
        attn = layer["attention"]
        _qkv(out, f"{lp}attention.self.query", attn["query"])
        _qkv(out, f"{lp}attention.self.key", attn["key"])
        _qkv(out, f"{lp}attention.self.value", attn["value"])
        _attn_out(out, f"{lp}attention.output.dense", attn["out"])
        _layer_norm(out, f"{lp}attention.output.LayerNorm",
                    layer["attention_layer_norm"])
        _dense(out, f"{lp}intermediate.dense", layer["intermediate"])
        _dense(out, f"{lp}output.dense", layer["output"])
        _layer_norm(out, f"{lp}output.LayerNorm", layer["output_layer_norm"])
        i += 1
    return out


def _tensors(out: StateDict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def retriever_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """MhopRetriever, MultiVectorCtxEncoder, SingleRetriever or NQRetriever
    Flax params (numpy leaves) → the port's state dict (no ``project.*``
    where the tree has no projection head: ``MultiVectorCtxEncoder(
    project=False)``, ``NQRetriever(use_projection=False)``; the question
    tower ``encoder_q`` / ``project_q`` of an unshared SingleRetriever)."""
    if "params" in params and "encoder" not in params:
        params = params["params"]
    out = {}
    for tower in ("", "_q"):
        if f"encoder{tower}" in params:
            out.update(encoder_state_dict_from_jax(params[f"encoder{tower}"],
                                                   prefix=f"encoder{tower}."))
        if f"project{tower}" in params:
            head = params[f"project{tower}"]
            _dense(out, f"project{tower}.0", head["dense"])
            _layer_norm(out, f"project{tower}.1", head["layer_norm"])
    return _tensors(out)


def reader_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """QAReader Flax params (numpy leaves) → a reference ``QAModel`` state
    dict (no ``sp.*`` for a reader built with ``sp_pred=False``)."""
    if "params" in params and "encoder" not in params:
        params = params["params"]
    out = encoder_state_dict_from_jax(params["encoder"], prefix="encoder.")
    for name in ("pooler.dense", "qa_outputs", "rank", "sp"):
        key = name.split(".")[0]
        if key in params:
            _dense(out, name, params[key])
    return _tensors(out)


def unified_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """UnifiedRetriever Flax params (numpy leaves) → the port's
    ``UnifiedRetriever`` state dict; ``project.*`` and ``pooler.*`` only
    where the tree has them."""
    if "params" in params and "encoder" not in params:
        params = params["params"]
    out = encoder_state_dict_from_jax(params["encoder"], prefix="encoder.")
    if "project" in params:
        _dense(out, "project.0", params["project"]["dense"])
        _layer_norm(out, "project.1", params["project"]["layer_norm"])
    _dense(out, "stop_head", params["stop_head"])
    if "pooler" in params:
        _dense(out, "pooler", params["pooler"])
    return _tensors(out)


def unified_state_dict_from_reference(sd: Dict[str, torch.Tensor]):
    """A reference UnifiedRetriever state dict (``module.`` prefixes
    already stripped) → (the port's state dict, use_projection,
    stop_on_pooled): the model's flags follow from which keys exist."""
    prefix = ("encoder_c."
              if "encoder_c.embeddings.word_embeddings.weight" in sd
              else "encoder.")
    pooler = f"{prefix}pooler.dense."
    out = {}
    for key, val in sd.items():
        if key.startswith(pooler):
            out["pooler." + key[len(pooler):]] = val
        elif key.startswith(prefix):
            out["encoder." + key[len(prefix):]] = val
        elif key.startswith("stop."):
            out["stop_head." + key[len("stop."):]] = val
        elif key.startswith("project."):
            out[key] = val
    return out, "project.0.weight" in sd, "pooler.weight" in out
