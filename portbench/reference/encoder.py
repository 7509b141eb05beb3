"""Plain reference of the two encoders the benchmark serves.

A BERT-family encoder written from the published description (post-LN
transformer, exact GELU, learned absolute positions; RoBERTa's positions
count from ``pad_id + 1`` over the non-pad tokens), with MDR's two heads
on top of it:

  * the retriever: the CLS vector through Linear(h, h) + LayerNorm;
  * the reader: start/end logits (Linear(h, 2), set to -1e30 outside the
    paragraph), a rank score (Linear(h, 1) over tanh(Linear(h, h)) of the
    CLS vector) and a supporting-sentence score (Linear(h, 1)) at each
    sentence marker.

It reads a state dict in the Hugging Face layout (``encoder.*``), upcast
to float32, and computes in float32 with TF32 off.  ``precision="fp8"``
is the control: every matrix product takes its two operands rounded to
float8 e4m3 (one scale per tensor, amax / 448) and sums in float32, as
an fp8 tensor-core product does; everything else stays float32.

It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the products inside (a float32 reference must not
    round its operands to 10 mantissa bits)."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Encoder:
    """The encoder over a float32 copy of ``state`` (keys under
    ``prefix``); ``cfg`` holds the Hugging Face config keys."""

    def __init__(self, state: Dict[str, torch.Tensor], cfg: Dict,
                 prefix: str = "encoder.", precision: str = "fp32",
                 device=None):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.cfg = cfg
        self.precision = precision
        self.p = {k[len(prefix):]: v.to(device).float()
                  for k, v in state.items() if k.startswith(prefix)}
        self.heads = {k: v.to(device).float() for k, v in state.items()
                      if not k.startswith(prefix)}
        if precision == "fp8":
            self._w8 = {k: _fp8(v) for k, v in self.p.items()
                        if k.endswith(".weight") and v.dim() == 2
                        and "embeddings" not in k}

    # ---- pieces ----------------------------------------------------------

    def _mm(self, x, key):
        w = self.p[key + ".weight"]
        if self.precision == "fp8":
            y = _fp8(x) @ self._w8[key + ".weight"].t()
        else:
            y = x @ w.t()
        return y + self.p[key + ".bias"]

    def _bmm(self, a, b):
        if self.precision == "fp8":
            return _fp8(a) @ _fp8(b)
        return a @ b

    def _ln(self, x, key):
        eps = self.cfg["layer_norm_eps"]
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + eps) * self.p[key + ".weight"]
                + self.p[key + ".bias"])

    def hidden(self, input_ids, mask, token_type_ids=None):
        """(B, L, h) last hidden states."""
        c = self.cfg
        ids = input_ids.long()
        b, n = ids.shape
        if c.get("position_style") == "roberta":
            keep = (ids != c["pad_token_id"]).long()
            pos = torch.cumsum(keep, 1) * keep + c["pad_token_id"]
        else:
            pos = torch.arange(n, device=ids.device).expand(b, n)
        tt = (torch.zeros_like(ids) if token_type_ids is None
              else token_type_ids.long())
        e = "embeddings."
        x = (self.p[e + "word_embeddings.weight"][ids]
             + self.p[e + "position_embeddings.weight"][pos]
             + self.p[e + "token_type_embeddings.weight"][tt])
        x = self._ln(x, e + "LayerNorm")
        heads = c["num_attention_heads"]
        d = c["hidden_size"] // heads
        keymask = mask.bool()[:, None, None, :]
        for i in range(c["num_hidden_layers"]):
            pre = f"encoder.layer.{i}."
            a = pre + "attention."
            q = self._mm(x, a + "self.query").view(b, n, heads, d)
            k = self._mm(x, a + "self.key").view(b, n, heads, d)
            v = self._mm(x, a + "self.value").view(b, n, heads, d)
            s = self._bmm(q.transpose(1, 2), k.permute(0, 2, 3, 1))
            s = s / math.sqrt(d)
            s = s.masked_fill(~keymask, float("-inf"))
            prob = torch.softmax(s, dim=-1)
            ctx = self._bmm(prob, v.transpose(1, 2))
            ctx = ctx.transpose(1, 2).reshape(b, n, heads * d)
            x = self._ln(x + self._mm(ctx, a + "output.dense"),
                         a + "output.LayerNorm")
            inter = self._mm(x, pre + "intermediate.dense")
            inter = 0.5 * inter * (1.0 + torch.erf(inter / math.sqrt(2.0)))
            x = self._ln(x + self._mm(inter, pre + "output.dense"),
                         pre + "output.LayerNorm")
        return x

    # ---- heads -------------------------------------------------------------

    def retrieve(self, input_ids, mask, token_type_ids=None):
        """(B, h) retriever vectors: CLS → Linear → LayerNorm."""
        cls = self.hidden(input_ids, mask, token_type_ids)[:, 0]
        h = self.heads
        y = cls @ h["project.0.weight"].t() + h["project.0.bias"]
        eps = self.cfg["layer_norm_eps"]
        mean = y.mean(-1, keepdim=True)
        var = ((y - mean) ** 2).mean(-1, keepdim=True)
        return ((y - mean) / torch.sqrt(var + eps) * h["project.1.weight"]
                + h["project.1.bias"])

    def read(self, input_ids, mask, token_type_ids, paragraph_mask,
             sent_offsets) -> Dict[str, torch.Tensor]:
        """The reader's heads: start/end logits (B, L), rank (B,), sp
        scores at the sentence markers (B, S)."""
        seq = self.hidden(input_ids, mask, token_type_ids)
        h = self.heads
        logits = seq @ h["qa_outputs.weight"].t() + h["qa_outputs.bias"]
        pm = paragraph_mask.bool()
        neg = torch.tensor(-1e30, device=seq.device)
        pooled = torch.tanh(seq[:, 0] @ h["pooler.dense.weight"].t()
                            + h["pooler.dense.bias"])
        rank = (pooled @ h["rank.weight"].t() + h["rank.bias"])[:, 0]
        offs = sent_offsets.long().clamp(0, seq.shape[1] - 1)
        at = torch.gather(seq, 1, offs[:, :, None].expand(-1, -1,
                                                          seq.shape[2]))
        sp = (at @ h["sp.weight"].t() + h["sp.bias"])[..., 0]
        return {"start": torch.where(pm, logits[..., 0], neg),
                "end": torch.where(pm, logits[..., 1], neg),
                "rank": rank, "sp": sp}
