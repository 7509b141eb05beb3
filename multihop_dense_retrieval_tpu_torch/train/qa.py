"""QA reader steps and span decoding (PyTorch).

The inference half of the JAX package's ``train/qa.py``: ``decode_spans``
and the rank / predict steps.  ``qa_loss`` and the train step come with
training (ROADMAP item 11).

A step is a plain function over the module: ``step(batch)`` takes the
collated ``net_inputs`` (numpy or tensors), moves the inputs the reader
reads onto the module's device and returns tensors there.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

NEG_INF = -1e30

# the collated inputs QAReader reads
READER_INPUTS = ("input_ids", "attention_mask", "token_type_ids",
                 "paragraph_mask", "sent_offsets", "sent_mask")


def decode_spans(start_logits: torch.Tensor, end_logits: torch.Tensor,
                 max_ans_len: int):
    """Band-masked best span per row: the highest start + end over
    0 <= end - start <= max_ans_len (others -1e10), the first maximum on
    ties, as ``jnp.argmax``.  Returns (start_pos, end_pos, span_score),
    each (B,)."""
    span = start_logits[:, :, None] + end_logits[:, None, :]   # (B, L, L)
    i = torch.arange(span.shape[1], device=span.device)
    band = (i[None, :, None] <= i[None, None, :]) & \
           (i[None, None, :] - i[None, :, None] <= max_ans_len)
    span = torch.where(band, span, -1e10)
    best_end_for_start = span.amax(dim=2)                       # (B, L)
    start_pos = best_end_for_start.argmax(dim=1)                # (B,)
    rows = torch.arange(span.shape[0], device=span.device)
    end_pos = span[rows, start_pos].argmax(dim=1)
    span_score = best_end_for_start.amax(dim=1)
    return start_pos, end_pos, span_score


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The reader's inputs of a collated batch as tensors on ``device``."""
    out = {}
    for k in READER_INPUTS:
        if k in batch:
            v = batch[k]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = v.to(device)
    return out


def make_qa_rank_step(model: torch.nn.Module) -> Callable:
    """batch → rank scores (B,): the narrow first pass of the two-stage
    read (eval/qa_eval.py::rank_filter)."""
    dev = _device_of(model)

    @torch.inference_mode()
    def step(batch):
        return model(to_device(batch, dev))["rank_score"].reshape(-1)

    return step


def make_qa_predict_step(model: torch.nn.Module, *,
                         max_ans_len: int = 30) -> Callable:
    """batch → rank score, best span and its score, and the sp
    probabilities (slots outside ``sent_mask`` at sigmoid(-1e30) = 0)."""
    dev = _device_of(model)

    @torch.inference_mode()
    def step(batch):
        net = to_device(batch, dev)
        out = model(net)
        start_pos, end_pos, span_score = decode_spans(
            out["start_logits"], out["end_logits"], max_ans_len)
        res = {"rank_score": out["rank_score"].reshape(-1),
               "start_pos": start_pos, "end_pos": end_pos,
               "span_score": span_score}
        if out["sp_score"] is not None:
            sp = torch.where(net["sent_mask"].bool(), out["sp_score"],
                             NEG_INF)
            res["sp_prob"] = torch.sigmoid(sp)
        return res

    return step
