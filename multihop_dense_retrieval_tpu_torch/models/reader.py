"""QA reader: encoder + span / rank / supporting-fact heads (PyTorch).

The port of the JAX package's ``models/reader.py``:

  * the encoder runs every position (``cls_only`` off) in ``config.dtype``;
    its output is cast to fp32 and every head is an fp32 dense;
  * ``qa_outputs`` (h → 2) gives start/end logits, set to -1e30 outside
    ``paragraph_mask``;
  * ``rank`` (h → 1) reads a tanh pooler over the CLS position;
  * ``sp`` (h → 1) reads the hidden states at ``sent_offsets`` (the
    sentence-marker positions); offsets past the batch width, which only
    a width-truncated rank pass produces and which feed nothing it
    returns, are clamped to the last column.

``fp32_params`` keeps the encoder's dense weights fp32 (the trainer's
master weights) and ``remat`` recomputes each encoder layer in the
backward pass, as for the retrievers; serving builds the reader with both
off.

Parameter names are the reference ``QAModel``'s (``encoder.*`` HF layout,
``pooler.dense``, ``qa_outputs``, ``rank``, ``sp``), so its ``.pt`` state
dict loads with ``load_state_dict``.  A BERT reader's HF pooler
(``encoder.pooler.dense``) is taken as the pooler when the checkpoint has
no top-level one, and ``sp.*`` is dropped for ``sp_pred=False``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..core.config import EncoderConfig
from .encoder import TransformerEncoder, dense

NEG_INF = -1e30


class Pooler(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)


def _reference_names(module, state_dict, prefix, *args):
    if prefix + "pooler.dense.weight" not in state_dict:
        for part in ("weight", "bias"):
            key = f"{prefix}encoder.pooler.dense.{part}"
            if key in state_dict:
                state_dict[f"{prefix}pooler.dense.{part}"] = \
                    state_dict.pop(key)
    if not module.sp_pred:
        for key in [k for k in state_dict if k.startswith(prefix + "sp.")]:
            del state_dict[key]


class QAReader(nn.Module):
    def __init__(self, config: EncoderConfig, sp_pred: bool = True,
                 fp32_params: bool = False, remat: bool = False):
        super().__init__()
        self.config = config
        self.sp_pred = sp_pred
        h = config.hidden_size
        self.encoder = TransformerEncoder(config, fp32_params=fp32_params,
                                          remat=remat)
        self.pooler = Pooler(h)
        self.qa_outputs = nn.Linear(h, 2)
        self.rank = nn.Linear(h, 1)
        if sp_pred:
            self.sp = nn.Linear(h, 1)
        self._register_load_state_dict_pre_hook(_reference_names,
                                                 with_module=True)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        seq = self.encoder(batch["input_ids"], batch["attention_mask"],
                           batch.get("token_type_ids")).float()
        logits = dense(seq, self.qa_outputs)                   # (B, L, 2)
        pmask = batch["paragraph_mask"].bool()
        start_logits = torch.where(pmask, logits[..., 0], NEG_INF)
        end_logits = torch.where(pmask, logits[..., 1], NEG_INF)
        pooled = torch.tanh(dense(seq[:, 0], self.pooler.dense))
        rank_score = dense(pooled, self.rank)                  # (B, 1)
        sp_score = None
        if self.sp_pred:
            offs = batch["sent_offsets"].long().clamp(0, seq.shape[1] - 1)
            gathered = torch.gather(
                seq, 1, offs[:, :, None].expand(-1, -1, seq.shape[2]))
            sp_score = dense(gathered, self.sp)[..., 0]        # (B, S)
        return {"start_logits": start_logits, "end_logits": end_logits,
                "rank_score": rank_score, "sp_score": sp_score}
