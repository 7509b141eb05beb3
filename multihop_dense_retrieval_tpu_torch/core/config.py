"""Typed configuration, PyTorch side.

Field names and defaults are those of the JAX package's
``core/config.py`` so one set of kwargs builds both.  ``dtype`` stays a
string; ``EncoderConfig.torch_dtype`` resolves it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class EncoderConfig:
    """Architecture config for the BERT-family transformer encoder."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    # RoBERTa position ids are pad_id + cumsum(ids != pad); BERT uses arange
    roberta_positions: bool = True
    embedding_size: Optional[int] = None
    hidden_act: str = "gelu"
    # compute dtype; params are fp32
    dtype: str = "bfloat16"
    # "xla": plain torch ops; "fused": kernel 8 (ops/fused_attention.py),
    # fp32 scores and softmax whatever attention_scores_dtype says; "flash"
    # (JAX's stock TPU kernel) runs the xla path, as JAX does off a TPU
    attention_impl: str = "xla"
    attention_scores_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def roberta_base(cls, **kw) -> "EncoderConfig":
        return cls(**kw)

    @classmethod
    def bert_base_uncased(cls, **kw) -> "EncoderConfig":
        d = dict(vocab_size=30522, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0,
                 roberta_positions=False)
        d.update(kw)
        return cls(**d)

    @classmethod
    def electra_large(cls, **kw) -> "EncoderConfig":
        """The QA reader's backbone: 24 layers, 1024 wide, 16 heads."""
        d = dict(vocab_size=30522, hidden_size=1024, num_layers=24,
                 num_heads=16, intermediate_size=4096,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, pad_token_id=0, roberta_positions=False)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, **kw) -> "EncoderConfig":
        """A minuscule config for unit tests (CPU-fast, same code paths)."""
        d = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64, max_position_embeddings=68,
                 dtype="float32")
        d.update(kw)
        return cls(**d)


@_frozen
class RetrieverTrainConfig:
    """Hyperparameters for contrastive retriever training (the reference
    trainer's flags, scripts/train_mhop.py:125-190)."""

    batch_size: int = 150
    eval_batch_size: int = 256
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.1
    max_grad_norm: float = 2.0
    num_epochs: int = 50
    gradient_accumulation: int = 1
    seed: int = 3
    max_q_len: int = 70
    max_q_sp_len: int = 350
    max_c_len: int = 300
    # momentum / memory-bank stage (scripts/train_momentum.py)
    momentum: bool = False
    queue_size: int = 76800
    momentum_m: float = 0.999
    # unified variable-hop stage
    unified: bool = False


@_frozen
class SearchConfig:
    """2-hop beam search settings; see the JAX package's SearchConfig for
    the measured rationale behind each default."""

    beam_size_1: int = 5
    beam_size_2: int = 5
    topk: int = 2
    max_q_len: int = 70
    max_q_sp_len: int = 350
    batch_size: int = 100
    chunk_rows: int = 131072
    # kept for field parity with the JAX config; the port picks the
    # kernels by device (CUDA tensors) and ignores this flag
    use_pallas: bool = True
    hop2_buckets: tuple = ()
    hop2_tile_fracs: tuple = ()
    q_width_multiple: int = 0
    hop2_prune_margin: float = 0.0
    stop_skip_threshold: float = 0.0
    use_pca: bool = False
    pca_k_chunks: int = 8
    pca_hops: str = "auto"


HOP2_BUCKETS_5TILE = (128, 160, 192, 256, 350)
HOP2_TILE_FRACS_5TILE = (0.25, 0.25, 0.25, 0.125, 0.125)
HOP2_BUCKETS_6TILE = (96, 128, 160, 192, 224, 350)
HOP2_TILE_FRACS_6TILE = (0.125, 0.25, 0.25, 0.125, 0.125, 0.125)


def default_hop2_tiling(n_rows: int, max_width: int = 350):
    """``(hop2_buckets, hop2_tile_fracs)`` for a hop-2 row count: the
    6-tile split from 512 rows, the 5-tile split from 128, none below.
    A non-default ``max_width`` clips the preset (buckets >= max_width
    merge into one final max_width tile)."""
    if n_rows >= 512:
        b, f = HOP2_BUCKETS_6TILE, HOP2_TILE_FRACS_6TILE
    elif n_rows >= 128:
        b, f = HOP2_BUCKETS_5TILE, HOP2_TILE_FRACS_5TILE
    else:
        return (), ()
    if max_width != 350:
        k = sum(1 for w in b if w < max_width)
        if k < 2:
            return (), ()
        if k == len(b):
            return b[:-1] + (max_width,), f
        b = tuple(b[:k]) + (max_width,)
        f = tuple(f[:k]) + (round(1.0 - sum(f[:k]), 6),)
    return b, f
