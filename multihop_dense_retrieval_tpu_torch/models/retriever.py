"""The multi-hop bi-encoder retriever (shared encoder + projection head).

Parameter names match the reference's RobertaRetriever state dict:
``encoder.*`` (an HF RoBERTa/BERT model), ``project.0`` (Linear) and
``project.1`` (LayerNorm).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..core.config import EncoderConfig
from .encoder import TransformerEncoder, layer_norm


class ProjectionHead(nn.Sequential):
    """fp32 Linear(h, h) + LayerNorm over the CLS vector."""

    def __init__(self, c: EncoderConfig):
        super().__init__(nn.Linear(c.hidden_size, c.hidden_size),
                         nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps))

    def forward(self, cls_rep: torch.Tensor) -> torch.Tensor:
        lin, ln = self[0], self[1]
        x = torch.matmul(cls_rep.float(), lin.weight.t()) + lin.bias
        return layer_norm(x, ln)


class MhopRetriever(nn.Module):
    """Shared encoder for questions, question⊕passage rows and passages;
    ``encode_seq`` is the entry point search uses (fp32 vectors out)."""

    def __init__(self, config: EncoderConfig, cls_only: bool = False):
        super().__init__()
        self.config = config
        self.encoder = TransformerEncoder(config, cls_only=cls_only)
        self.project = ProjectionHead(config)

    def encode_seq(self, input_ids, mask, token_type_ids=None):
        hidden = self.encoder(input_ids, mask, token_type_ids)
        return self.project(hidden[:, 0, :])

    forward = encode_seq
