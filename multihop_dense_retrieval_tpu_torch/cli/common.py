"""Shared CLI plumbing: logging, tokenizer, model and checkpoint resolution,
the serving pipeline's flags, and the hop-2 tiling flags (the JAX
package's ``cli/common.py``, minus its compile cache, which the eager port
has no use for), plus ``init_reader``, whose JAX counterpart lives in the
JAX package's ``cli/train_qa.py``.

``--model-name roberta-base --checkpoint q_encoder.pt`` works as in the
JAX package, and ``--tokenizer hash --model-name tiny`` gives a
self-contained run.  ``init_retriever`` (``unified=True``: the
variable-hop ``UnifiedRetriever``) and ``init_reader`` put their model on
``cuda`` unless the caller names another device.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional

import torch

from ..core.config import EncoderConfig, default_hop2_tiling
from ..core.device import process_index, resolve_device, world
from ..core.mesh import Mesh, local_devices, make_mesh, pod_devices
from ..data.tokenization import HashTokenizer, HFTokenizer
from ..models import (MhopRetriever, QAReader, UnifiedRetriever,
                      reference_init_, unified_state_dict_from_reference)


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
    return process_index() == 0


MODEL_PRESETS = {
    "roberta-base": EncoderConfig.roberta_base,
    "bert-base-uncased": EncoderConfig.bert_base_uncased,
    "electra-large": EncoderConfig.electra_large,
    "tiny": lambda **kw: EncoderConfig.tiny(
        vocab_size=50265, max_position_embeddings=514, **kw),
    "mini": lambda **kw: EncoderConfig.tiny(
        vocab_size=50265, max_position_embeddings=514, hidden_size=64,
        num_layers=4, intermediate_size=128, **kw),
}


# the reader's presets (BERT-style positions and segment ids); "tiny" and
# "mini" run in fp32, as EncoderConfig.tiny does
READER_PRESETS = {
    "electra-large": EncoderConfig.electra_large,
    "bert-base-uncased": EncoderConfig.bert_base_uncased,
    "tiny": lambda **kw: EncoderConfig.tiny(
        vocab_size=50265, max_position_embeddings=514, type_vocab_size=2,
        pad_token_id=0, roberta_positions=False, **kw),
    "mini": lambda **kw: EncoderConfig.tiny(
        vocab_size=50265, max_position_embeddings=514, type_vocab_size=2,
        pad_token_id=0, roberta_positions=False, hidden_size=64,
        num_layers=4, intermediate_size=128, **kw),
}


def resolve_encoder_config(name: str, dtype: str = "bfloat16") -> EncoderConfig:
    if name not in MODEL_PRESETS:
        raise ValueError(f"unknown model preset {name}; "
                         f"options: {sorted(MODEL_PRESETS)}")
    return MODEL_PRESETS[name](dtype=dtype)


def add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu: the kernels' plain "
                        "versions)")


def index_mesh(n_shards: int, device) -> Optional[Mesh]:
    """The mesh of ``--index-shards N`` (None for N <= 1): N shards over
    this process's devices (every visible card for the bare ``cuda``, as
    many as fit; a named device such as ``cpu`` or ``cuda:0`` holds N / P
    shards) and, under ``cli/pod``, over every one of the P processes."""
    if n_shards <= 1:
        return None
    size = world()[1]
    if n_shards % size:
        raise ValueError(f"--index-shards {n_shards} does not split over "
                         f"{size} processes")
    return make_mesh(index=n_shards, devices=pod_devices(
        local_devices(device, n_shards // size)))


def train_mesh(device, data_parallel: Optional[int]) -> Mesh:
    """The data mesh of a trainer CLI (the JAX CLIs' ``make_mesh(data=
    --data-parallel or every device, index=1)``): every visible card for
    the bare ``cuda``, or the first ``--data-parallel N`` of them (more
    than there are raise); a named device (``cpu``, ``cuda:0``) N times,
    its entries sharing it.  Each batch must split over the entries.

    Under ``cli/pod`` with more than one process it raises: each
    process's loader reads the whole dataset, so the processes would
    train on duplicated data (the JAX trainer loop never hands a process
    its slice of a batch either)."""
    if world()[1] > 1:
        raise ValueError(
            "the trainer CLIs run in one process: under cli/pod each "
            "process's loader would read the whole dataset and the "
            "processes would train on duplicated data; train with "
            "--data-parallel over this process's cards")
    resolve_device(device)
    local = local_devices(device, data_parallel or 1)
    return make_mesh(data=data_parallel or len(local), index=1, devices=local)


def add_pipeline_args(p):
    """Arguments that construct a ``DemoPipeline`` (retriever + reader +
    live index), shared by the demo REPL and the HTTP server."""
    p.add_argument("index_dir")
    add_device_arg(p)
    p.add_argument("--tokenizer", default="hash")
    p.add_argument("--retriever-model", default="roberta-base")
    p.add_argument("--retriever-checkpoint", default="")
    p.add_argument("--reader-model", default="electra-large")
    p.add_argument("--reader-checkpoint", default="")
    p.add_argument("--reader-tokenizer", default="",
                   help="tokenizer for the reader (its vocabulary differs "
                        "from the retriever's: electra wordpiece vs roberta "
                        "BPE); default: --tokenizer, correct only for the "
                        "hash test tokenizer")
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--max-q-len", type=int, default=70)
    p.add_argument("--max-q-sp-len", type=int, default=350)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--max-ans-len", type=int, default=30)
    p.add_argument("--chunk-rows", type=int, default=4096)
    p.add_argument("--max-c-len", type=int, default=300,
                   help="passage budget when encoding live-added documents")
    add_reader_scores_args(p)
    p.add_argument("--pca", action="store_true",
                   help="PCA-prefiltered MIPS (index built with --pca-dims)")
    p.add_argument("--pca-k-chunks", type=int, default=8)
    p.add_argument("--lambda", dest="lam", type=float, default=0.8)
    p.add_argument("--unified", action="store_true",
                   help="variable-hop serving with a UnifiedRetriever: a "
                        "chain whose stop head fires is one passage")
    p.add_argument("--stop-threshold", type=float, default=0.5,
                   help="P(single-hop) above which a chain is served as one "
                        "passage (--unified only)")
    add_rank_args(p)
    add_hop2_tiling_args(p)


def add_reader_scores_args(p):
    p.add_argument("--reader-bf16-scores", action="store_true", default=True,
                   help="bf16 reader attention scores (the default)")
    p.add_argument("--reader-fp32-scores", dest="reader_bf16_scores",
                   action="store_false",
                   help="revert reader attention scores to fp32")


def add_rank_args(p):
    """Two-stage read flags (shared by the pipeline CLIs and end2end)."""
    p.add_argument("--rank-topm", type=int, default=0,
                   help="two-stage read: rank ALL chains at --rank-width "
                        "tokens, run the full span/sp pass on the top-m per "
                        "question (0 = read every chain fully, the "
                        "reference behavior)")
    p.add_argument("--rank-width", type=int, default=128,
                   help="rank-pass token width (a cap on each length-"
                        "bucketed batch's width)")


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
                   help="approximate hop-2 candidate pruning: re-encode only "
                        "hop-1 candidates within this margin of their "
                        "question's top-1 score; 'auto' / 'auto:Q' take the "
                        "batch's Q-quantile hop-1 gap (auto = 0.5); 0 = off "
                        "(exact)")


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
    """A reference ``.pt`` state dict, retriever or reader (``module.``
    prefixes stripped; an HF pooler is ignored by the retriever).  Orbax
    directories are the JAX package's format and raise."""
    if not checkpoint.endswith(".pt"):
        raise NotImplementedError(
            f"{checkpoint!r}: the port loads reference .pt state dicts; "
            "export an orbax checkpoint with the JAX package's "
            "cli/export_ckpt first")
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def init_retriever(config: EncoderConfig, *, unified: bool = False,
                   checkpoint: str = "", seed: int = 0, device=None,
                   fp32_params: bool = False, remat: bool = False):
    """The retriever in eval mode on ``device`` (``cuda`` unless named):
    loaded from ``checkpoint``, or random weights from ``seed`` without one,
    drawn from the JAX package's initialisers (``reference_init_``; the
    caller's global RNG state is left as it was).  The last layer
    computes the CLS position only (``cls_only``; a loss reads only the
    CLS vector, so training's gradients are the same).  ``unified``: a
    ``UnifiedRetriever``, whose head layout a reference checkpoint decides
    (``project`` only for roberta names, the stop head on the tanh
    pooler); its seeded weights are made on the device itself.  The
    training CLIs ask for ``fp32_params`` (fp32 master weights) and, for
    the multi-hop retriever as in the JAX package, ``remat``, which the
    UnifiedRetriever lacks: asking for both raises."""
    dev = resolve_device(device)
    if unified and remat:
        raise ValueError("remat is not supported for the unified retriever "
                         "(UnifiedRetriever takes no remat)")
    if unified:
        sd, kw = None, {}
        if checkpoint:
            sd, proj, pooled = unified_state_dict_from_reference(
                load_retriever_params(checkpoint))
            kw = dict(use_projection=proj, stop_on_pooled=pooled)
        devices = [dev.index or 0] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed)
            with dev:
                model = reference_init_(UnifiedRetriever(
                    config, cls_only=True, fp32_params=fp32_params, **kw))
        if sd is not None:
            model.load_state_dict(sd)
        return model.eval()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = reference_init_(MhopRetriever(
            config, cls_only=True, fp32_params=fp32_params, remat=remat))
    if checkpoint:
        model.load_state_dict(load_retriever_params(checkpoint))
    return model.to(dev).eval()


def init_reader(model_name: str, checkpoint: str = "", sp_pred: bool = True,
                seed: int = 0, scores_dtype: str = "float32", device=None,
                fp32_params: bool = False, remat: bool = False,
                train: bool = False):
    """(config, QAReader on ``device``, ``cuda`` unless named): loaded
    from a reference ``QAModel`` ``.pt``, or random weights from ``seed``
    made on the device itself without one, drawn from the JAX package's
    initialisers (``reference_init_``; the caller's RNG state is left as
    it was).  ``scores_dtype`` is the attention scores' dtype; the
    serving CLIs default to bf16.  In eval mode, or in train mode with
    ``train``; the reader trainer asks for ``fp32_params`` (fp32 master
    weights) and may ask for ``remat``.  Orbax directories raise, as in
    ``load_retriever_params``.  The JAX counterpart is ``init_reader`` in
    the JAX package's ``cli/train_qa.py``."""
    dev = resolve_device(device)
    if model_name not in READER_PRESETS:
        raise ValueError(f"unknown reader preset {model_name}; "
                         f"options: {sorted(READER_PRESETS)}")
    cfg = READER_PRESETS[model_name](attention_scores_dtype=scores_dtype)
    devices = [dev.index or 0] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        with dev:
            model = reference_init_(QAReader(
                cfg, sp_pred=sp_pred, fp32_params=fp32_params, remat=remat))
    if checkpoint:
        model.load_state_dict(load_retriever_params(checkpoint))
    return cfg, model.train(train)


def resolve_reader_tokenizer(spec: str, config: EncoderConfig):
    """The reader's tokenizer: BERT-style specials; the hash tokenizer is
    sized to the reader's vocabulary, so every id it gives is a row of the
    reader's embedding table."""
    return resolve_tokenizer(spec, vocab_size=config.vocab_size,
                             roberta_style=False)
