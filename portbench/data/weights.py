"""Seeded weights at a configuration's published widths, made on the device.

The tensors are drawn in three large calls on a ``torch.Generator`` of the
device (matrices, vectors, embedding tables) and cut into a state dict in
the Hugging Face layout (``encoder.*``) plus the heads MDR puts on top:

  * ``retriever``: ``project.0`` (Linear h → h) and ``project.1``
    (LayerNorm), MDR's RobertaRetriever head;
  * ``reader``: ``pooler.dense``, ``qa_outputs`` (h → 2), ``rank`` (h → 1)
    and ``sp`` (h → 1), MDR's QAModel heads.

Each matrix is drawn from a normal of std 1/sqrt(fan_in) clipped at two
std, each embedding table from a normal of std 1/sqrt(h), biases and
LayerNorm shifts from N(0, 0.02), LayerNorm scales from 1 + N(0, 0.02).
The encoder's dense weights and biases are served in the configuration's
``dtype`` and are made in it; everything else is float32, as served.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kind is ``dense`` (an
    encoder matrix or bias, served in the compute dtype), ``head``,
    ``embedding``, ``ln_weight`` or ``ln_bias`` (float32)."""
    h = cfg["hidden_size"]
    f = cfg["intermediate_size"]
    out = []
    e = "encoder.embeddings."
    out.append((e + "word_embeddings.weight", (cfg["vocab_size"], h),
                "embedding"))
    out.append((e + "position_embeddings.weight",
                (cfg["max_position_embeddings"], h), "embedding"))
    out.append((e + "token_type_embeddings.weight",
                (cfg["type_vocab_size"], h), "embedding"))
    out += [(e + "LayerNorm.weight", (h,), "ln_weight"),
            (e + "LayerNorm.bias", (h,), "ln_bias")]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.encoder.layer.{i}."
        for lin, (o, n) in (("attention.self.query", (h, h)),
                            ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)),
                            ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (f, h)),
                            ("output.dense", (h, f))):
            out.append((pre + lin + ".weight", (o, n), "dense"))
            out.append((pre + lin + ".bias", (o,), "dense"))
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            out += [(pre + ln + ".weight", (h,), "ln_weight"),
                    (pre + ln + ".bias", (h,), "ln_bias")]
    if cfg["model"] == "retriever":
        out += [("project.0.weight", (h, h), "head"),
                ("project.0.bias", (h,), "head"),
                ("project.1.weight", (h,), "ln_weight"),
                ("project.1.bias", (h,), "ln_bias")]
    elif cfg["model"] == "reader":
        out += [("pooler.dense.weight", (h, h), "head"),
                ("pooler.dense.bias", (h,), "head"),
                ("qa_outputs.weight", (2, h), "head"),
                ("qa_outputs.bias", (2,), "head"),
                ("rank.weight", (1, h), "head"),
                ("rank.bias", (1,), "head"),
                ("sp.weight", (1, h), "head"),
                ("sp.bias", (1,), "head")]
    else:
        raise ValueError(f"model {cfg['model']!r}")
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``cfg``'s model drawn from ``seed`` on
    ``device``."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    compute = _DTYPES[cfg["dtype"]]
    mats = [(n, s, k) for n, s, k in shapes if len(s) == 2
            and k != "embedding"]
    vecs = [(n, s, k) for n, s, k in shapes if len(s) == 1]
    embs = [(n, s, k) for n, s, k in shapes if k == "embedding"]
    out = {}

    def draw(group):
        total = sum(int(torch.Size(s).numel()) for _, s, _ in group)
        return torch.randn(total, generator=gen, device=device)

    flat = draw(mats)
    at = 0
    for name, shape, kind in mats:
        n = int(torch.Size(shape).numel())
        w = flat[at:at + n].view(shape).clamp_(-2.0, 2.0)
        w = w * (shape[1] ** -0.5)
        at += n
        out[name] = w.to(compute if kind == "dense" else torch.float32)
    del flat
    flat = draw(vecs)
    at = 0
    for name, shape, kind in vecs:
        n = shape[0]
        v = flat[at:at + n] * 0.02
        at += n
        if kind == "ln_weight":
            v = v + 1.0
        out[name] = v.to(compute if kind == "dense" else torch.float32)
    flat = draw(embs)
    at = 0
    h = cfg["hidden_size"]
    for name, shape, _ in embs:
        n = int(torch.Size(shape).numel())
        out[name] = (flat[at:at + n].view(shape) * h ** -0.5).contiguous()
        at += n
    del flat
    return {name: out[name] for name, _, _ in shapes}
