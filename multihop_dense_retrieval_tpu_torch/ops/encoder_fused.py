"""One pass for each elementwise chain between two matmuls of an encoder
layer (kernels 9-11, ``csrc/encoder_fused.cu``).

  9. ``bias_gelu``      — the intermediate dense's bias add, then erf-GELU
  10. ``masked_softmax`` — the attention scores' scale, mask bias and
                           softmax (``attention_impl="xla"``)
  11. ``add_layer_norm`` — an output dense's bias add, the residual add and
                           the LayerNorm

They replace no Pallas kernel: the JAX package left these chains to XLA's
fusion inside ``jit``, and PyTorch runs them op by op, one pass over
device memory an op.  Their bound is bytes; each kernel reads the matmul's
output once and writes the next matmul's input once, with every
intermediate in registers (the note in the source has the design).

Each wrapper launches its kernel for CUDA tensors and takes its plain twin
only for tensors on the CPU; a CUDA input the kernel does not take raises.
The twins are the plain path's arithmetic, which ``models/encoder.py``
runs wherever gradients are on: the kernels compute the same operations
with the same roundings, bit for bit for kernel 9, and up to the order of
a row's sums for kernels 10 and 11.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

from .mips import LAUNCHES, _FLOAT_CODES, _on_cuda, _require, _stream

MAX_SCORE_WIDTH = 544   # 17 scores a lane of the softmax's warp
MAX_HIDDEN = 1024       # 32 values a lane of the LayerNorm's warp


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf * 0.7071067811865476))).to(x.dtype)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=float32)``: fp32 fast-variance statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight.float()
    return (xf - mean) * mul + ln.bias.float()


def bias_gelu_plain(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A dense layer's bias add in its compute dtype, then erf-GELU."""
    return gelu_exact(y + bias.to(y.dtype))


def masked_softmax_plain(scores: torch.Tensor, attn_bias: torch.Tensor,
                         scale: torch.Tensor,
                         scores_dtype: str) -> torch.Tensor:
    """The attention probabilities of the raw scores q.k^T (B, nh, Lq, L):
    divided by ``scale`` (a CPU 0-dim tensor in the compute dtype), plus
    the (B, 1, 1, L) fp32 mask bias, softmax; with ``scores_dtype``
    "bfloat16" in the compute dtype, else in fp32; in the compute dtype."""
    dt = scores.dtype
    scores = scores / scale
    if scores_dtype == "bfloat16":
        scores = scores + attn_bias.to(dt)
    else:
        scores = scores.float() + attn_bias
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    return (e / e.sum(-1, keepdim=True)).to(dt)


def add_layer_norm_plain(y: torch.Tensor, bias: torch.Tensor,
                         res: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """An output dense's bias add, the residual add (both in the compute
    dtype), then ``layer_norm``, rounded to the compute dtype."""
    return layer_norm(res + (y + bias.to(y.dtype)), ln).to(y.dtype)


def _vec(width: int, *tensors) -> int:
    """16-byte packs where the width and every address allow, else 1."""
    vec = 16 // tensors[0].element_size()
    ok = width % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return vec if ok else 1


@functools.lru_cache(maxsize=64)
def _inv(x: float) -> float:
    """The fp32 quotient 1 / fp32(x) (numpy's fp32 scalars divide in fp32;
    a torch op on the CPU costs the host ten times as much), once for
    each x: a layer asks for the same few."""
    return float(np.float32(1.0) / np.float32(x))


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as contiguous ``dtype``, itself where it is already: the
    checks read attributes, where ``.to()`` and ``.contiguous()`` each
    cost the host a dispatch."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


# The wrappers run a few times in every encoder layer, and the host
# launching the encoder is what the card waits for: they read attributes
# and format a message only to raise it.


def bias_gelu(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``bias_gelu_plain`` as one pass (kernel 9): y (..., I) contiguous in
    bf16 or fp32, bias (I,)."""
    if not _on_cuda(y, bias):
        return bias_gelu_plain(y, bias)
    from . import _build

    cols = y.shape[-1]
    if y.dtype not in _FLOAT_CODES:
        raise ValueError(f"unsupported dtype {y.dtype}")
    _require(y.is_contiguous(), "y must be contiguous")
    if bias.shape != (cols,):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({cols},)")
    bias = _as(bias, y.dtype)
    out = torch.empty_like(y)
    lib = _build.load("encoder_fused")
    _build.check(lib.bias_gelu(
        _FLOAT_CODES[y.dtype], _vec(cols, y, bias, out), y.data_ptr(),
        bias.data_ptr(), out.data_ptr(), y.numel() // cols, cols, _stream()),
        "bias_gelu")
    LAUNCHES["bias_gelu"] += 1
    return out


def masked_softmax(scores: torch.Tensor, attn_bias: torch.Tensor,
                   scale: torch.Tensor, scores_dtype: str) -> torch.Tensor:
    """``masked_softmax_plain`` as one pass (kernel 10): scores (B, nh, Lq,
    L) contiguous in bf16 or fp32, L <= 544, attn_bias (B, 1, 1, L) fp32."""
    if not _on_cuda(scores, attn_bias):
        return masked_softmax_plain(scores, attn_bias, scale, scores_dtype)
    from . import _build

    if scores.dtype not in _FLOAT_CODES:
        raise ValueError(f"unsupported dtype {scores.dtype}")
    _require(scores.dim() == 4 and scores.is_contiguous(),
             "scores must be a contiguous (B, nh, Lq, L) tensor")
    b, nh, lq, w = scores.shape
    if attn_bias.shape != (b, 1, 1, w) or attn_bias.dtype != torch.float32:
        raise ValueError(f"attn_bias {tuple(attn_bias.shape)} "
                         f"{attn_bias.dtype} is not ({b}, 1, 1, {w}) float32")
    if w > MAX_SCORE_WIDTH:
        raise ValueError(f"score rows of {w} exceed {MAX_SCORE_WIDTH}")
    _require(scale.device.type == "cpu" and scale.numel() == 1,
             "scale must be a CPU scalar")
    # PyTorch's CUDA division by a CPU scalar multiplies by its reciprocal
    # taken in fp32 (BinaryDivTrueKernel.cu: a * (1 / b) in opmath)
    inv = _inv(scale.item())
    bias = _as(attn_bias, torch.float32)   # (B, 1, 1, L): (B, L) in place
    out = torch.empty_like(scores)
    lib = _build.load("encoder_fused")
    _build.check(lib.masked_softmax(
        _FLOAT_CODES[scores.dtype], int(scores_dtype == "bfloat16"),
        scores.data_ptr(), bias.data_ptr(), out.data_ptr(), b * nh * lq,
        nh * lq, w, inv, _stream()), "masked_softmax")
    LAUNCHES["masked_softmax"] += 1
    return out


def add_layer_norm(y: torch.Tensor, bias: torch.Tensor, res: torch.Tensor,
                   ln: nn.LayerNorm) -> torch.Tensor:
    """``add_layer_norm_plain`` as one pass (kernel 11): y (..., N)
    contiguous in bf16 or fp32, N <= 1024, bias (N,), res of y's shape
    with rows of unit stride (a strided ``x[:, :1]`` is read in place)."""
    if not _on_cuda(y, bias, res, ln.weight):
        return add_layer_norm_plain(y, bias, res, ln)
    from . import _build

    n = y.shape[-1]
    dt = y.dtype
    if dt not in _FLOAT_CODES:
        raise ValueError(f"unsupported dtype {dt}")
    if res.dtype != dt or res.shape != y.shape:
        raise ValueError(f"res {tuple(res.shape)} {res.dtype} does not match "
                         f"y {tuple(y.shape)} {dt}")
    _require(y.is_contiguous(), "y must be contiguous")
    if not 1 <= n <= MAX_HIDDEN:
        raise ValueError(f"width {n} exceeds {MAX_HIDDEN}")
    if bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({n},)")
    rows = y.numel() // n
    if res.dim() != 2:
        res = res.reshape(rows, n)
    if res.stride(-1) != 1:
        res = res.contiguous()
    bias = _as(bias, dt)
    w, beta = _as(ln.weight, torch.float32), _as(ln.bias, torch.float32)
    out = torch.empty_like(y)
    vec = _vec(n, y, bias, res, w, beta, out)
    if res.stride(0) % vec:
        vec = 1
    lib = _build.load("encoder_fused")
    _build.check(lib.add_layer_norm(
        _FLOAT_CODES[dt], vec, y.data_ptr(), bias.data_ptr(),
        res.data_ptr(), res.stride(0), w.data_ptr(), beta.data_ptr(),
        # PyTorch's CUDA mean multiplies the sum by fp32(1 / N)
        # (ReduceMomentKernel.cu: float(outputs) / inputs)
        out.data_ptr(), rows, n, _inv(n), ln.eps, _stream()),
        "add_layer_norm")
    LAUNCHES["add_layer_norm"] += 1
    return out
