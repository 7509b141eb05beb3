"""Shared CLI plumbing: logging, tokenizer, model and checkpoint resolution,
and the hop-2 tiling flags (the JAX package's ``cli/common.py``, minus its
compile cache, which the eager port has no use for).

``--model-name roberta-base --checkpoint q_encoder.pt`` works as in the
JAX package, and ``--tokenizer hash --model-name tiny`` gives a
self-contained run.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional

import torch

from ..core.config import EncoderConfig, default_hop2_tiling
from ..data.tokenization import HashTokenizer, HFTokenizer
from ..models import MhopRetriever


def setup_logging(output_dir: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger("mdr_torch")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())
        if output_dir and is_primary():
            os.makedirs(output_dir, exist_ok=True)
            logger.addHandler(logging.FileHandler(
                os.path.join(output_dir, "log.txt")))
    return logger


def load_json_flex(path: str):
    """Load a .json array or a .jsonl file (sniffs the first
    non-whitespace character)."""
    with open(path) as f:
        head = f.read(64)
        f.seek(0)
        if head.lstrip()[:1] == "[":
            return json.load(f)
        return [json.loads(l) for l in f if l.strip()]


def is_primary() -> bool:
    """True on the process that owns shared-filesystem writes: rank 0 of
    ``torch.distributed`` when it is initialised, else always."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _electra_large(**kw):
    raise NotImplementedError(
        "electra-large is the reader's encoder; it comes with the reader "
        "(ROADMAP item 10)")


MODEL_PRESETS = {
    "roberta-base": EncoderConfig.roberta_base,
    "bert-base-uncased": EncoderConfig.bert_base_uncased,
    "electra-large": _electra_large,
    "tiny": lambda **kw: EncoderConfig.tiny(
        vocab_size=50265, max_position_embeddings=514, **kw),
    "mini": lambda **kw: EncoderConfig.tiny(
        vocab_size=50265, max_position_embeddings=514, hidden_size=64,
        num_layers=4, intermediate_size=128, **kw),
}


def resolve_encoder_config(name: str, dtype: str = "bfloat16") -> EncoderConfig:
    if name not in MODEL_PRESETS:
        raise ValueError(f"unknown model preset {name}; "
                         f"options: {sorted(MODEL_PRESETS)}")
    return MODEL_PRESETS[name](dtype=dtype)


def _prune_margin(s: str) -> float:
    """--hop2-prune-margin parser: 'auto' = -0.5, 'auto:Q' = -Q, else a
    margin >= 0."""
    if s == "auto":
        return -0.5
    if s.startswith("auto:"):
        q = float(s[5:])
        if not 0 < q <= 1:
            raise argparse.ArgumentTypeError(
                "auto:Q needs a gap quantile Q in (0, 1]")
        return -q
    v = float(s)
    if v < 0:
        raise argparse.ArgumentTypeError(
            "margin must be >= 0, 'auto', or 'auto:Q'")
    return v


def add_hop2_tiling_args(p):
    """Length-adaptive hop-2 encode flags (exact results either way)."""
    p.add_argument("--hop2-buckets", default="auto",
                   help='hop-2 encode width tiles: "auto" (the preset for '
                        'the batch x beam row count), "off", or a comma list '
                        'of multiples of 32 ending at max-q-sp-len')
    p.add_argument("--hop2-tile-fracs", default="",
                   help="comma row-fractions per bucket (sum to 1); empty = "
                        "preset fracs for auto, equal tiles otherwise")
    p.add_argument("--hop2-prune-margin", type=_prune_margin, default=0.0,
                   help="approximate hop-2 candidate pruning; 0 = off "
                        "(exact).  Not ported yet: any other value raises")


def resolve_hop2_tiling(args, n_rows: int, max_width: int):
    """Map --hop2-buckets/--hop2-tile-fracs to SearchConfig fields;
    ``n_rows`` is the hop-2 row count (batch x beam_size_1).  Explicit
    flags the engine could not apply raise."""
    spec = getattr(args, "hop2_buckets", "auto")
    if spec == "off":
        return (), ()
    if spec == "auto":
        return default_hop2_tiling(n_rows, max_width)
    buckets = tuple(int(x) for x in spec.split(","))
    fracs_spec = getattr(args, "hop2_tile_fracs", "")
    fracs = (tuple(float(x) for x in fracs_spec.split(","))
             if fracs_spec else ())
    if fracs:
        if len(fracs) != len(buckets):
            raise ValueError(
                f"--hop2-tile-fracs has {len(fracs)} entries for "
                f"{len(buckets)} buckets")
        sizes = [int(round(f * n_rows)) for f in fracs]
        sizes[-1] = n_rows - sum(sizes[:-1])
        if min(sizes) <= 0:
            raise ValueError(
                f"--hop2-tile-fracs {fracs_spec} leaves an empty tile at "
                f"{n_rows} hop-2 rows (batch x beam)")
    elif n_rows % len(buckets):
        raise ValueError(
            f"--hop2-buckets: {n_rows} hop-2 rows do not split into "
            f"{len(buckets)} equal tiles; pass --hop2-tile-fracs")
    return buckets, fracs


def resolve_tokenizer(spec: str, vocab_size: int = 50265,
                      roberta_style: bool = True):
    """``hash`` → the deterministic test tokenizer; anything else → a
    local HF tokenizer directory."""
    if spec == "hash":
        return HashTokenizer(vocab_size=vocab_size, roberta_style=roberta_style)
    return HFTokenizer(spec)


def load_retriever_params(checkpoint: str):
    """A reference ``.pt`` state dict (``module.`` prefixes stripped; an HF
    pooler is ignored by the model).  Orbax directories are the JAX
    package's format and raise."""
    if not checkpoint.endswith(".pt"):
        raise NotImplementedError(
            f"{checkpoint!r}: the port loads reference .pt state dicts; "
            "export an orbax checkpoint with the JAX package's "
            "cli/export_ckpt first")
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def init_retriever(config: EncoderConfig, *, checkpoint: str = "",
                   seed: int = 0, device=None) -> MhopRetriever:
    """The retriever in eval mode on ``device``: loaded from ``checkpoint``,
    or random weights from ``seed`` without one (the caller's global RNG
    state is left as it was).  The last layer computes the CLS position
    only (``cls_only``)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MhopRetriever(config, cls_only=True)
    if checkpoint:
        model.load_state_dict(load_retriever_params(checkpoint))
    return model.to(device).eval()
