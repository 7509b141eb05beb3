"""The multi-hop bi-encoder retriever (shared encoder + projection head),
the variable-hop retriever with a stop head, the single-hop and NQ
retrievers that the trainer drives, and the multi-vector corpus encoder.

``forward(batch)`` of each retriever encodes a training batch's views (the
JAX modules' ``__call__``); ``encode_seq`` is the one-view entry point
that search and corpus encoding use.  ``fp32_params`` keeps the encoder's
dense weights fp32 (the trainer's master weights); ``remat`` recomputes
each encoder layer in the backward pass.

Parameter names match the reference's RobertaRetriever state dict:
``encoder.*`` (an HF RoBERTa/BERT model), ``project.0`` (Linear) and
``project.1`` (LayerNorm); ``MultiVectorCtxEncoder`` uses the same names,
so a retriever's state dict loads into it.  ``UnifiedRetriever`` adds
``stop_head`` and, where the stop head reads the tanh pooler, ``pooler``
(``models/convert.py`` maps a reference UnifiedRetriever ``.pt`` onto
these names).
"""

from __future__ import annotations

from typing import Dict

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


def _view(encode, batch, pref):
    return encode(batch[f"{pref}input_ids"], batch[f"{pref}mask"],
                  batch.get(f"{pref}type_ids"))


class MhopRetriever(nn.Module):
    """Shared encoder for questions, question⊕passage rows and passages;
    ``encode_seq`` is the entry point search uses (fp32 vectors out),
    ``forward`` encodes the six views of a training batch."""

    def __init__(self, config: EncoderConfig, cls_only: bool = False,
                 fp32_params: bool = False, remat: bool = False):
        super().__init__()
        self.config = config
        self.encoder = TransformerEncoder(config, cls_only=cls_only,
                                          fp32_params=fp32_params,
                                          remat=remat)
        self.project = ProjectionHead(config)

    def encode_seq(self, input_ids, mask, token_type_ids=None):
        hidden = self.encoder(input_ids, mask, token_type_ids)
        return self.project(hidden[:, 0, :])

    encode_q = encode_seq

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        enc = self.encode_seq
        return {"q": _view(enc, batch, "q_"),
                "q_sp1": _view(enc, batch, "q_sp_"),
                "c1": _view(enc, batch, "c1_"),
                "c2": _view(enc, batch, "c2_"),
                "neg_1": _view(enc, batch, "neg1_"),
                "neg_2": _view(enc, batch, "neg2_")}


class SingleRetriever(nn.Module):
    """Single-hop DPR-style bi-encoder (the JAX package's
    ``SingleRetriever``): ``shared=True`` one tower, ``shared=False``
    separate question (``encoder_q``, ``project_q``) and passage towers."""

    def __init__(self, config: EncoderConfig, shared: bool = True,
                 fp32_params: bool = False):
        super().__init__()
        self.config = config
        self.shared = shared
        self.encoder = TransformerEncoder(config, fp32_params=fp32_params)
        self.project = ProjectionHead(config)
        if not shared:
            self.encoder_q = TransformerEncoder(config,
                                                fp32_params=fp32_params)
            self.project_q = ProjectionHead(config)

    def encode_ctx(self, input_ids, mask, token_type_ids=None):
        hidden = self.encoder(input_ids, mask, token_type_ids)
        return self.project(hidden[:, 0, :])

    def encode_q(self, input_ids, mask, token_type_ids=None):
        if self.shared:
            return self.encode_ctx(input_ids, mask, token_type_ids)
        hidden = self.encoder_q(input_ids, mask, token_type_ids)
        return self.project_q(hidden[:, 0, :])

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        return {"q": _view(self.encode_q, batch, "q_"),
                "c": _view(self.encode_ctx, batch, "c_"),
                "neg": _view(self.encode_ctx, batch, "neg_")}


class UnifiedRetriever(nn.Module):
    """Variable-hop retriever: the shared encoder, an optional projection
    head, and a stop classifier over the q⊕p representation that says
    whether a second hop is needed (the JAX package's
    ``models/retriever.py::UnifiedRetriever``).

    ``stop_head`` is an fp32 Linear(h, 2) over the fp32 CLS vector, or,
    with ``stop_on_pooled``, over ``tanh(pooler(cls))`` (an fp32
    Linear(h, h)), as the reference feeds it from the HF pooler.  Without
    ``use_projection`` the vector is the raw CLS state, in fp32.  Class 0
    of the stop logits is "stop"."""

    def __init__(self, config: EncoderConfig, use_projection: bool = True,
                 stop_on_pooled: bool = False, cls_only: bool = False,
                 fp32_params: bool = False):
        super().__init__()
        self.config = config
        self.use_projection = use_projection
        self.stop_on_pooled = stop_on_pooled
        self.encoder = TransformerEncoder(config, cls_only=cls_only,
                                          fp32_params=fp32_params)
        if use_projection:
            self.project = ProjectionHead(config)
        self.stop_head = nn.Linear(config.hidden_size, 2)
        if stop_on_pooled:
            self.pooler = nn.Linear(config.hidden_size, config.hidden_size)

    def _vec(self, cls: torch.Tensor) -> torch.Tensor:
        return self.project(cls) if self.use_projection else cls.float()

    def encode_seq(self, input_ids, mask, token_type_ids=None):
        hidden = self.encoder(input_ids, mask, token_type_ids)
        return self._vec(hidden[:, 0, :])

    def encode_qsp(self, input_ids, mask, token_type_ids=None):
        """(vector, stop_logits) of a question ⊕ passage row."""
        cls = self.encoder(input_ids, mask, token_type_ids)[:, 0, :]
        stop_in = cls.float()
        if self.stop_on_pooled:
            stop_in = torch.tanh(torch.matmul(stop_in, self.pooler.weight.t())
                                 + self.pooler.bias)
        logits = torch.matmul(stop_in, self.stop_head.weight.t()) \
            + self.stop_head.bias
        return self._vec(cls), logits

    encode_q = encode_seq

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        q_sp1, stop_logits = _view(self.encode_qsp, batch, "q_sp_")
        enc = self.encode_seq
        return {"q": _view(enc, batch, "q_"), "q_sp1": q_sp1,
                "stop_logits": stop_logits,
                "c1": _view(enc, batch, "c1_"),
                "c2": _view(enc, batch, "c2_"),
                "neg_1": _view(enc, batch, "neg1_"),
                "neg_2": _view(enc, batch, "neg2_")}


class NQRetriever(nn.Module):
    """NQ/WebQ single-hop retriever with the error-recovery view (the JAX
    package's ``NQRetriever``): ``q_neg1`` re-encodes question ⊕ a wrongly
    retrieved passage as a second-chance query.  Without
    ``use_projection`` the vector is the raw CLS state in fp32, as the
    reference's RobertaNQRetriever returns it, and the module has no
    projection head (the JAX module creates none it never calls)."""

    def __init__(self, config: EncoderConfig, use_projection: bool = False,
                 fp32_params: bool = False):
        super().__init__()
        self.config = config
        self.use_projection = use_projection
        self.encoder = TransformerEncoder(config, fp32_params=fp32_params)
        if use_projection:
            self.project = ProjectionHead(config)

    def encode_seq(self, input_ids, mask, token_type_ids=None):
        cls = self.encoder(input_ids, mask, token_type_ids)[:, 0, :]
        return self.project(cls) if self.use_projection else cls.float()

    encode_q = encode_seq

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        enc = self.encode_seq
        out = {"q": _view(enc, batch, "q_"), "c": _view(enc, batch, "c_"),
               "neg": _view(enc, batch, "neg_"),
               "q_neg1": _view(enc, batch, "q_neg1_")}
        if "dense_neg1_input_ids" in batch:
            out["dense_neg1"] = _view(enc, batch, "dense_neg1_")
            out["dense_neg2"] = _view(enc, batch, "dense_neg2_")
        return out


class MultiVectorCtxEncoder(nn.Module):
    """Multi-vector corpus encoder (the JAX package's
    ``models/retriever.py::MultiVectorCtxEncoder``):

    scheme="layerwise" — CLS of the last ``multi_vector`` layers, last first
    scheme="tokenwise" — the first ``multi_vector`` positions of the last
                         layer
    multi_vector=1     — the plain CLS vector
    Returns (B * multi_vector, H) fp32, rows grouped per passage.

    ``project=True`` runs every vector through the retriever's projection
    head, so corpus rows live in the space of ``MhopRetriever.encode_seq``;
    ``project=False`` returns the raw hidden states (fp32)."""

    def __init__(self, config: EncoderConfig, multi_vector: int = 1,
                 scheme: str = "tokenwise", project: bool = True):
        super().__init__()
        self.config = config
        self.multi_vector = multi_vector
        self.scheme = scheme
        self.projected = project
        self.encoder = TransformerEncoder(
            config, return_all_hiddens=(scheme == "layerwise"))
        if project:
            self.project = ProjectionHead(config)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(x) if self.projected else x.float()

    def forward(self, input_ids, mask, token_type_ids=None):
        out = self.encoder(input_ids, mask, token_type_ids)
        m = self.multi_vector
        if m <= 1:
            h = out[-1] if isinstance(out, list) else out
            return self._head(h[:, 0, :])
        if self.scheme == "layerwise":
            cls = torch.stack([h[:, 0, :] for h in out[::-1][:m]], dim=1)
        elif self.scheme == "tokenwise":
            cls = out[:, :m, :]
        else:
            raise ValueError(f"unknown scheme {self.scheme}")
        if cls.shape[1] != m:
            # fewer rows would break the doc = row // multi_vector layout
            # that the index and merge_multivector rely on
            what = ("encoder layers" if self.scheme == "layerwise"
                    else "sequence positions")
            raise ValueError(f"{self.scheme} multi_vector={m} needs >= {m} "
                             f"{what}, got {cls.shape[1]}")
        return self._head(cls.reshape(-1, cls.shape[-1]))
