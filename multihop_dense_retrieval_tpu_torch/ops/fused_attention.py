"""Fused short-sequence multi-head attention (kernel 8).

The PyTorch counterpart of the JAX package's ``ops/fused_attention.py``.
``fused_attention`` launches the hand-written CUDA kernel
(``csrc/fused_attention.cu``) for CUDA tensors and takes the plain version,
``fused_attention_plain``, only for tensors on the CPU; a CUDA input the
kernel does not take raises.  ``attention_plan`` picks the kernel's
template by a fixed rule: bf16 squares (Wq = W) with d >= 16 on the tensor
cores, bf16 with Wq = 1 one warp per (batch row, head), and the SIMT
template for fp32 (tensor cores would be TF32) and bf16 squares with d = 8.

Both compute, per batch row and head, the JAX kernel's arithmetic (not the
encoder's plain attention): fp32 scores ``q_h . k_h`` times fp32(1/sqrt(d))
plus a 0 / -1e9 fp32 bias built from ``mask``, a one-pass fp32 softmax
(max, exp, sum, division), the probabilities rounded to the input dtype,
then an fp32 product with ``v_h`` rounded to the output dtype.  Heads are
column slices of the (B, W, H) projection layout.  The JAX function's
``block_b`` sized a TPU VMEM block and has no counterpart here.
"""

from __future__ import annotations

import torch

from .mips import LAUNCHES, SMEM_LIMIT, _on_cuda, _require, _stream

NEG_INF = -1e9          # mask bias, as in the JAX kernel
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_WIDTH = 514         # the widest sequence the kernel's score rows hold

_DTYPE_CODES = {torch.bfloat16: 1, torch.float32: 2}
_ROUTES = {"simt": 0, "mma": 1, "row": 2}   # the C entry point's route codes
_KSTRIP, _ROW_WARPS = 64, 4                 # csrc/fused_attention.cu


def attention_plan(b: int, wq: int, w: int, num_heads: int, d: int,
                   dtype) -> dict:
    """Route and launch plan of kernel 8 (the C entry point checks ``smem``
    against the route's own count):
      * "row" (bf16, Wq = 1): one warp per (batch row, head), 4 a block;
        ``smem`` holds each warp's W scores.
      * "mma" (bf16, Wq = W, d >= 16): tensor cores; a block of ``warps``
        warps (8, or 4 for W <= 64) per (16 * warps query rows, head,
        batch row), keys padded to a multiple of 16; ``smem`` holds k_h
        whole and two 64-key v strips (rows of d + 8 bf16) and an fp32
        bias for every key of the 64-key strips.
      * "simt" (fp32, and bf16 squares with d = 8): 32-row query tiles,
        fp32 q, one 64-row fp32 k/v tile and the (32, W) score rows."""
    bf16 = dtype == torch.bfloat16
    if bf16 and wq == 1:
        return dict(route="row", warps=_ROW_WARPS, key_pad=w, q_pad=1,
                    grid=(-(-b * num_heads // _ROW_WARPS), 1, 1),
                    smem=4 * _ROW_WARPS * (-(-w // 4) * 4))
    if bf16 and d >= 16:
        kp = -(-w // 16) * 16
        warps = 8 if w > 64 else 4
        q_tiles = -(-w // (16 * warps))
        return dict(route="mma", warps=warps, key_pad=kp,
                    q_pad=16 * warps * q_tiles, grid=(q_tiles, num_heads, b),
                    smem=2 * (kp + 2 * _KSTRIP) * (d + 8)
                    + 4 * _KSTRIP * -(-kp // _KSTRIP))
    q_tiles = -(-wq // 32)
    return dict(route="simt", warps=8, key_pad=w, q_pad=32 * q_tiles,
                grid=(b, num_heads, q_tiles),
                smem=4 * (32 * d + 64 * (d + 1) + 32 * w))


def _scale(d: int) -> float:
    """The JAX kernel's scale: the Python float 1/sqrt(d), used as fp32."""
    return 1.0 / float(d) ** 0.5


def fused_attention_plain(q, k, v, mask, num_heads: int):
    """Plain version of kernel 8: the same steps in the same order, the
    products upcast to fp32 (the JAX kernel's ``preferred_element_type``)."""
    b, wq, hsz = q.shape
    w = k.shape[1]
    d = hsz // num_heads
    qh = q.float().view(b, wq, num_heads, d).transpose(1, 2)
    kh = k.float().view(b, w, num_heads, d).transpose(1, 2)
    vh = v.float().view(b, w, num_heads, d).transpose(1, 2)
    scale = torch.tensor(_scale(d), dtype=torch.float32, device=q.device)
    bias = torch.where(mask.bool(), 0.0, NEG_INF).to(torch.float32)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale + bias[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype).float()
    o = torch.matmul(p, vh)                                  # (B, nh, Wq, d)
    return o.transpose(1, 2).reshape(b, wq, hsz).to(q.dtype)


def fused_attention(q, k, v, mask, num_heads: int):
    """q (B, Wq, H), k and v (B, W, H) in the projection layout, mask (B, W)
    nonzero where attendable; returns (B, Wq, H) in q's dtype.  On CUDA:
    bf16 or fp32, head dim in ``HEAD_DIMS``, W <= 514, Wq = W or 1."""
    if not _on_cuda(q, k, v, mask):
        return fused_attention_plain(q, k, v, mask, num_heads)
    from . import _build

    b, wq, hsz = q.shape
    w = k.shape[1]
    _require(q.dtype in _DTYPE_CODES, f"unsupported dtype {q.dtype}")
    _require(k.dtype == v.dtype == q.dtype, "q, k and v must share a dtype")
    _require(k.shape == v.shape == (b, w, hsz),
             f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(tuple(mask.shape) == (b, w), f"mask {tuple(mask.shape)} is not "
             f"({b}, {w})")
    _require(hsz % num_heads == 0 and hsz // num_heads in HEAD_DIMS,
             f"head dim {hsz}/{num_heads} not in {HEAD_DIMS}")
    _require(1 <= w <= MAX_WIDTH and wq in (w, 1),
             f"widths Wq={wq}, W={w}: need W <= {MAX_WIDTH} and Wq in (W, 1)")
    for t in (q, k, v):
        _require(t.is_contiguous(), "q, k and v must be contiguous")
    d = hsz // num_heads
    plan = attention_plan(b, wq, w, num_heads, d, q.dtype)
    _require(max(plan["grid"][1:]) <= 65535, f"grid {plan['grid']} too large")
    _require(plan["smem"] <= SMEM_LIMIT, f"{plan['smem']} bytes of shared "
             "memory exceed a block's")
    if plan["route"] != "simt":
        _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                 "q, k and v must be 16-byte aligned")
    mask = mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load("fused_attention")
    _build.check(lib.fused_attention(
        _ROUTES[plan["route"]], plan["warps"], _DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), b, wq, w,
        num_heads, d, _scale(d), plan["smem"], out.data_ptr(), _stream()),
        "fused_attention")
    LAUNCHES["fused_attention"] += 1
    return out
