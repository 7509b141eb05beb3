"""BERT-family transformer encoder as PyTorch modules.

The numerics follow the JAX package's ``models/encoder.py`` step for
step, so a checkpoint gives the same vectors in both:

  * dense weights and biases are stored in ``config.dtype`` (Flax keeps
    them fp32 and rounds them to the compute dtype in every product, so a
    checkpoint rounded once at load gives the same numbers); with
    ``fp32_params`` (training: fp32 master weights for the optimizer) they
    stay fp32 and ``dense`` rounds them at use, as Flax does, a no-op for
    weights already in the compute dtype; embeddings and LayerNorm
    parameters stay fp32; activations run in ``config.dtype``;
  * each embedding lookup is cast to the compute dtype before
    ``word + pos + typ``;
  * RoBERTa position ids come from ``input_ids != pad_id`` (not the mask);
  * LayerNorm statistics are fp32 with the fast variance E[x²]−E[x]², the
    result is downcast once;
  * gelu is fp32 erf with one downcast; ``gelu_new`` (the tanh
    approximation) and ``relu`` run in the compute dtype, op for op as
    ``jax.nn.gelu(approximate=True)`` and ``jax.nn.relu``;
  * with ``embedding_size != hidden_size`` (ELECTRA small/base) the
    embeddings and their LayerNorm are ``embedding_size`` wide, and the
    ``embeddings_project`` dense (compute dtype) follows the LayerNorm;
  * a dense layer is a matmul in the compute dtype, then a separate bias
    add in that dtype (Flax rounds the product before adding the bias);
  * attention (``attention_impl="xla"``) is two matmuls and an explicit
    softmax; the mask bias is -1e9.  ``attention_scores_dtype="bfloat16"``
    divides by √d and adds the bias in bf16, ``"float32"`` upcasts the
    scores before the bias;
  * ``attention_impl="fused"`` hands the (B, L, H) q/k/v projections to
    kernel 8 (``ops/fused_attention.py``) without a head transpose, as the
    JAX encoder does: fp32 scores times fp32(1/√d) plus an fp32 0 / -1e9
    bias from the mask (``attention_scores_dtype`` is ignored), a one-pass
    fp32 softmax, the probabilities rounded to the compute dtype, and an
    fp32 product with v; ``"flash"`` runs the xla path, as the JAX
    encoder does on every backend but a TPU (its stock TPU flash kernel
    is not a kernel of this repository);
  * ``cls_only`` runs the last layer's queries and FFN for position 0;
    ``return_all_hiddens`` returns every layer's output (embeddings first)
    for the layerwise multi-vector encoder, and then runs the last layer
    in full;
  * a layer laid out tensor-parallel (``parallel/sharding.py``) computes
    each index shard's heads and FFN columns on its device and adds the
    shards' partial output projections in fp32, in shard order, before
    the replicated bias and one downcast: in bf16 that rounds otherwise
    than the unsharded product (one rounding of the whole sum);
  * ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``, as ``nn.remat`` in JAX): less activation
    memory for more FLOPs, the same numbers.

Module and parameter names are those of HF RoBERTa/BERT, so a reference
``.pt`` loads with ``load_state_dict``; an HF pooler in the checkpoint is
accepted and ignored (the retriever never reads it).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..core.config import EncoderConfig
from ..ops.fused_attention import fused_attention
from ..parallel.sharding import ShardedLinear

NEG_INF = -1e9  # attention mask bias, as in the JAX encoder


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf * 0.7071067811865476))).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in the dtype of ``x``."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float32).to(x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3))))
    return x * cdf


def _act(name: str):
    acts = {"gelu": gelu_exact, "gelu_new": gelu_tanh, "relu": torch.relu}
    if name not in acts:
        raise ValueError(f"unknown activation {name}")
    return acts[name]


def dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """Flax ``Dense(dtype=...)``: product in the compute dtype (that of
    ``x``; the weights are rounded to it, a no-op where they are stored
    in it), then bias add."""
    return _dense(x, lin.weight, lin.bias)


def _dense(x, weight, bias=None):
    y = torch.matmul(x, weight.to(x.dtype).t())
    return y if bias is None else y + bias.to(x.dtype)


def row_parallel(parts, lin: ShardedLinear, home: torch.device, dt):
    """The index shards' partial products of a row-parallel linear, added
    in shard order in fp32 on ``home``, then its replicated bias (rounded
    to the compute dtype, as ``dense`` uses it) once, then one downcast."""
    acc = parts[0].float().to(home)
    for p in parts[1:]:
        acc = acc + p.float().to(home)
    return (acc + lin.bias.to(dt).float().to(home)).to(dt)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=float32)``: fp32 fast-variance statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight.float()
    return (xf - mean) * mul + ln.bias.float()


# Flax's truncated normal draws from [-2, 2] and divides the scale by this
# factor, the std of a unit normal truncated there
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def reference_init_(model: nn.Module) -> nn.Module:
    """Draw ``model``'s weights (in place, from torch's global RNG) from the
    JAX package's initialisers, Flax's defaults: a Linear weight from a
    normal truncated at 2 std of std 1/sqrt(fan_in) (``lecun_normal``), an
    Embedding from a normal of std 1/sqrt(width), every bias 0, every
    LayerNorm 1 and 0.  PyTorch's own defaults (uniform Linear weights and
    biases, N(0, 1) embeddings) train otherwise: Adam moves every weight
    by about the learning rate a step, and an N(0, 1) embedding is 8x the
    JAX package's at width 64, so at the JAX reader recipe's learning rate
    it barely moves."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            std = mod.in_features ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            nn.init.normal_(mod.weight, std=mod.embedding_dim ** -0.5)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
    return model


def roberta_position_ids(input_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    mask = (input_ids != pad_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_id


class Embeddings(nn.Module):
    def __init__(self, c: EncoderConfig):
        super().__init__()
        e = c.embedding_size or c.hidden_size
        self.word_embeddings = nn.Embedding(c.vocab_size, e)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, e)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, e)
        self.LayerNorm = nn.LayerNorm(e, eps=c.layer_norm_eps)
        self.dtype = c.torch_dtype

    def forward(self, input_ids, token_type_ids, position_ids):
        # F.embedding rather than indexing: the same rows, and a backward
        # that sums each row's gradient in a fixed order on the CPU
        dt = self.dtype
        emb = nn.functional.embedding
        word = emb(input_ids, self.word_embeddings.weight).to(dt)
        pos = emb(position_ids, self.position_embeddings.weight).to(dt)
        typ = emb(token_type_ids, self.token_type_embeddings.weight).to(dt)
        return layer_norm(word + pos + typ, self.LayerNorm).to(dt)


class SelfAttention(nn.Module):
    def __init__(self, c: EncoderConfig):
        super().__init__()
        h = c.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)


class AttentionOutput(nn.Module):
    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class Attention(nn.Module):
    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.self = SelfAttention(c)
        self.output = AttentionOutput(c)
        self.c = c

    def context(self, x, attn_bias, attention_mask, q_positions=None,
                shard=None):
        """Multi-head attention before the output projection: (B, Lq, H);
        with ``shard`` s, that of index shard s's heads (the q/k/v
        linears split by ``parallel/sharding.py``), on its device."""
        c = self.c
        dt = c.torch_dtype
        B, L, _ = x.shape
        nh, d = c.num_heads, c.head_dim
        x_q = x if q_positions is None else x[:, :q_positions]
        Lq = x_q.shape[1]
        sa = self.self
        if shard is None:
            proj = dense
        else:
            nh //= len(sa.query.weight)

            def proj(inp, lin):
                return _dense(inp, *lin.block(shard))
        if c.attention_impl == "fused":
            return fused_attention(proj(x_q, sa.query), proj(x, sa.key),
                                   proj(x, sa.value), attention_mask, nh)
        q = proj(x_q, sa.query).view(B, Lq, nh, d).transpose(1, 2)
        k = proj(x, sa.key).view(B, L, nh, d).transpose(1, 2)
        v = proj(x, sa.value).view(B, L, nh, d).transpose(1, 2)
        scale = torch.tensor(math.sqrt(d), dtype=torch.float32).to(dt)
        scores = torch.matmul(q, k.transpose(-1, -2)) / scale   # (B,nh,Lq,L)
        if c.attention_scores_dtype == "bfloat16":
            scores = scores + attn_bias.to(dt)
        else:
            scores = scores.float() + attn_bias
        m = scores.amax(-1, keepdim=True)
        e = torch.exp(scores - m)
        probs = (e / e.sum(-1, keepdim=True)).to(dt)
        out = torch.matmul(probs, v)                            # (B,nh,Lq,d)
        return out.transpose(1, 2).reshape(B, Lq, nh * d)


class Intermediate(nn.Module):
    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size)


class Output(nn.Module):
    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.dense = nn.Linear(c.intermediate_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class EncoderLayer(nn.Module):
    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.attention = Attention(c)
        self.intermediate = Intermediate(c)
        self.output = Output(c)
        self.c = c
        self.act = _act(c.hidden_act)

    def forward(self, x, attn_bias, attention_mask, q_positions=None):
        dt = self.c.torch_dtype
        if isinstance(self.attention.self.query, ShardedLinear):
            return self._tensor_parallel(x, attn_bias, attention_mask,
                                         q_positions)
        ctx = self.attention.context(x, attn_bias, attention_mask, q_positions)
        attn_out = dense(ctx, self.attention.output.dense)
        res = x if q_positions is None else x[:, :q_positions]
        x = layer_norm(res + attn_out,
                       self.attention.output.LayerNorm).to(dt)
        inter = self.act(dense(x, self.intermediate.dense))
        out = dense(inter, self.output.dense)
        return layer_norm(x + out, self.output.LayerNorm).to(dt)

    def _tensor_parallel(self, x, attn_bias, attention_mask, q_positions):
        """The layer over index shards (``parallel/sharding.py``): each
        shard computes its heads' context and its partial output
        projection, then its FFN columns and their partial output
        projection, on its device; ``row_parallel`` adds the partial sums
        on ``x``'s device, where the residuals and LayerNorms run.
        Autograd carries each block's gradient back to its device."""
        dt, home = self.c.torch_dtype, x.device
        att_out, inter_lin = self.attention.output.dense, self.intermediate.dense
        parts = []
        for s, dev in enumerate(att_out.devices):
            ctx = self.attention.context(
                x.to(dev), attn_bias.to(dev), attention_mask.to(dev),
                q_positions, shard=s)
            parts.append(_dense(ctx, att_out.weight[s]))
        res = x if q_positions is None else x[:, :q_positions]
        x = layer_norm(res + row_parallel(parts, att_out, home, dt),
                       self.attention.output.LayerNorm).to(dt)
        parts = []
        for s, dev in enumerate(inter_lin.devices):
            inter = self.act(_dense(x.to(dev), *inter_lin.block(s)))
            parts.append(_dense(inter, self.output.dense.weight[s]))
        out = row_parallel(parts, self.output.dense, home, dt)
        return layer_norm(x + out, self.output.LayerNorm).to(dt)


class LayerStack(nn.Module):
    def __init__(self, c: EncoderConfig):
        super().__init__()
        self.layer = nn.ModuleList(EncoderLayer(c) for _ in range(c.num_layers))


def _drop_unused_keys(module, state_dict, prefix, *args):
    # HF checkpoints carry a tanh pooler (never consumed by the retriever)
    # and, in newer versions, a position_ids buffer
    for key in list(state_dict):
        if key.startswith(prefix + "pooler.") or \
                key == prefix + "embeddings.position_ids":
            del state_dict[key]


class TransformerEncoder(nn.Module):
    """Returns the last hidden state (B, L, H) in the compute dtype;
    (B, 1, H) with ``cls_only``; with ``return_all_hiddens`` the list of
    every layer's hidden state, the embeddings' output first."""

    def __init__(self, config: EncoderConfig, cls_only: bool = False,
                 return_all_hiddens: bool = False, fp32_params: bool = False,
                 remat: bool = False):
        super().__init__()
        if config.attention_impl not in ("xla", "fused", "flash"):
            raise NotImplementedError(
                f"attention_impl={config.attention_impl!r} is not ported; "
                "use 'xla' or 'flash' (plain attention) or 'fused' (kernel 8)")
        self.config = config
        self.cls_only = cls_only
        self.return_all_hiddens = return_all_hiddens
        self.remat = remat
        self.embeddings = Embeddings(config)
        # HF ELECTRA keeps the projection beside the embeddings, at the
        # model's top level
        self.embeddings_project = None
        if config.embedding_size not in (None, config.hidden_size):
            self.embeddings_project = nn.Linear(config.embedding_size,
                                                config.hidden_size)
        self.encoder = LayerStack(config)
        if not fp32_params:
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    mod.to(config.torch_dtype)
        self._register_load_state_dict_pre_hook(_drop_unused_keys,
                                                 with_module=True)

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        c = self.config
        B, L = input_ids.shape
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if c.roberta_positions:
            position_ids = roberta_position_ids(input_ids, c.pad_token_id)
        else:
            position_ids = torch.arange(L, device=input_ids.device
                                        ).expand(B, L)
        x = self.embeddings(input_ids, token_type_ids.long(), position_ids)
        if self.embeddings_project is not None:
            x = dense(x, self.embeddings_project)
        attn_bias = torch.where(attention_mask[:, None, None, :].bool(),
                                0.0, NEG_INF).to(torch.float32)
        layers = self.encoder.layer
        hiddens = [x]
        for i, layer in enumerate(layers):
            last = i == len(layers) - 1
            qp = 1 if (self.cls_only and last
                       and not self.return_all_hiddens) else None
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, attn_bias, attention_mask, qp,
                               use_reentrant=False)
            else:
                x = layer(x, attn_bias, attention_mask, q_positions=qp)
            if self.return_all_hiddens:
                hiddens.append(x)
        return hiddens if self.return_all_hiddens else x
