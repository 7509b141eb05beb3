"""QA reader loss, steps and span decoding (PyTorch; the JAX package's
``train/qa.py``).

Loss = rank BCE (sum) + marginal span NLL + sp_weight · sp BCE, all fp32:

  * span supervision is a padded set of answer-occurrence slots per chain
    (starts/ends with -1 padding); the span loss marginalizes over all
    occurrences: -log Σ_slots exp(-(CE_start + CE_end)) per row, summed
    over rows with at least one valid slot (a slot whose CE sum is exactly
    0, as both -1 slots give, counts as log-prob -1e30);
  * rows with no covered answer (all slots -1) contribute 0;
  * sp BCE over the sentence-marker slots, masked by ``sent_mask`` and by
    the gold-chain ``label``.  As in the JAX package this masks where the
    reference multiplies each sentence's BCE by its token offset
    (qa_model.py:78), which reads as a stand-in for a 0/1 valid-slot mask.

A predict or rank step is a plain function over the module: ``step(batch)``
takes the collated ``net_inputs`` (numpy or tensors), moves the inputs the
reader reads onto the module's device and returns tensors there.  The
train step is ``step(state, batch) -> (state, loss)`` over
``train/trainer.py``'s ``TrainState``, as ``make_train_step``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.mesh import Mesh
from .trainer import _apply, _batch_rows, _data_parallel, _outputs

NEG_INF = -1e30

# the collated inputs QAReader reads
READER_INPUTS = ("input_ids", "attention_mask", "token_type_ids",
                 "paragraph_mask", "sent_offsets", "sent_mask")
# the supervision qa_loss reads
LOSS_INPUTS = ("label", "starts", "ends", "sent_labels", "sent_mask")


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


def _ce_with_ignore(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """(B, A) cross entropies of (B, L) logits against each of the A target
    columns; a target of -1 gives 0 (torch's ``ignore_index=-1``)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, targets.long().clamp(min=0))
    return torch.where(targets == -1, 0.0, logz[:, None] - gold)


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, element by element."""
    return -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(
        -logits)


def qa_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            *, sp_weight: float = 0.05, sp_pred: bool = True) -> torch.Tensor:
    start_logits = outputs["start_logits"].float()             # (B, L)
    end_logits = outputs["end_logits"].float()
    label = batch["label"].reshape(-1).float()                  # (B,)
    rank_loss = _sigmoid_bce(outputs["rank_score"].float().reshape(-1),
                             label).sum()
    loss_tensor = (_ce_with_ignore(start_logits, batch["starts"])
                   + _ce_with_ignore(end_logits, batch["ends"]))  # (B, A)
    log_prob = torch.where(loss_tensor == 0.0, NEG_INF, -loss_tensor)
    marginal = torch.exp(log_prob).sum(dim=1)                   # (B,)
    has_span = marginal > 0
    span_loss = -torch.where(
        has_span, torch.log(torch.where(has_span, marginal, 1.0)), 0.0).sum()
    total = rank_loss + span_loss
    if sp_pred and outputs["sp_score"] is not None:
        sp_bce = _sigmoid_bce(outputs["sp_score"].float(),
                              batch["sent_labels"].float())
        sp_bce = sp_bce * batch["sent_mask"].float() * label[:, None]
        total = total + sp_weight * sp_bce.sum()
    return total


def make_qa_train_step(*, sp_weight: float = 0.05, sp_pred: bool = True,
                       mesh: Optional[Mesh] = None) -> Callable:
    """``step(state, batch) -> (state, loss)``: the reader's forward pass
    over a collated batch already on the model's device (``net_inputs``
    with the supervision keys), ``qa_loss``, backward and one optimizer
    update of ``state`` (in place).  ``mesh``: the batch is split over
    its data axis (``train/trainer.py::DataParallel``) and ``qa_loss``,
    whose terms are sums over rows, is computed once on the gathered
    heads' outputs and the global batch's supervision."""
    dp = _data_parallel(mesh)

    def step(state, batch):
        outputs = _outputs(dp, state.model, batch)
        rows = _batch_rows(dp, batch, LOSS_INPUTS, state.model)
        return state, _apply(state, qa_loss(outputs, rows,
                                            sp_weight=sp_weight,
                                            sp_pred=sp_pred), dp)

    return step


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


def make_qa_rank_step(model: torch.nn.Module, *,
                      mesh: Optional[Mesh] = None) -> Callable:
    """batch → rank scores (B,): the narrow first pass of the two-stage
    read (eval/qa_eval.py::rank_filter).  ``mesh``: the batch split over
    its data axis, the scores gathered."""
    dev = _device_of(model)
    dp = _data_parallel(mesh)

    @torch.inference_mode()
    def step(batch):
        out = _outputs(dp, model, to_device(batch, dev))
        return out["rank_score"].reshape(-1)

    return step


def make_qa_predict_step(model: torch.nn.Module, *, max_ans_len: int = 30,
                         mesh: Optional[Mesh] = None) -> Callable:
    """batch → rank score, best span and its score, and the sp
    probabilities (slots outside ``sent_mask`` at sigmoid(-1e30) = 0).
    ``mesh``: the batch split over its data axis, the heads' outputs
    gathered before the decode."""
    dev = _device_of(model)
    dp = _data_parallel(mesh)

    @torch.inference_mode()
    def step(batch):
        net = to_device(batch, dev)
        out = _outputs(dp, model, net)
        net = _batch_rows(dp, net, ("sent_mask",), model)
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
