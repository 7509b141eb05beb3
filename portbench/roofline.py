"""The least time the work of a call needs on one H100: max(bytes / peak
bandwidth, sum over number types of operations / that type's peak).

Bytes count each input byte read once and each output byte written once,
whatever a kernel reads again; operations count what the call's answer
needs.  Where the work depends on the data (the chunks a rescan reads),
the count is a lower bound drawn from what the call returned, never more
than the inputs need, so that a share of this bound cannot pass 100%
whatever kernels do the work.  Peaks: NVIDIA's H100 SXM data sheet, dense.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}


@dataclass
class Work:
    bytes: float = 0.0
    ops: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Work") -> "Work":
        ops = dict(self.ops)
        for k, v in other.ops.items():
            ops[k] = ops.get(k, 0.0) + v
        return Work(self.bytes + other.bytes, ops)

    def least_s(self) -> float:
        compute = sum(v / PEAK[k] for k, v in self.ops.items())
        return max(self.bytes / HBM_BYTES_PER_S, compute)


def int8_scan(b: int, n: int, d: int, k: int) -> Work:
    """Exact top-k of ``b`` float32 queries over ``n`` int8 rows with
    float32 scales: the rows and scales once, the queries, the (value,
    id) outputs; 2 b n d int8 operations."""
    return Work(n * (d + 4) + b * d * 4 + b * k * 8,
                {"int8": 2.0 * b * n * d})


def int8_pca_search(b: int, n: int, d: int, r: int, k: int, kc: int,
                    cand: int, chunks_read: int) -> Work:
    """PCA-prefiltered top-k: the bf16 projections (n x r) once, the
    rotation, the chunk bounds, the ``chunks_read`` distinct candidate
    chunks' int8 rows and scales once, the queries and outputs; the
    projected product (2 b n r bf16), the queries' projection (2 b d r
    fp32) and the rescan of every query's ``kc`` chunks (2 b kc cand d
    int8)."""
    byt = (n * r * 2 + d * r * 4 + 4 * (n // cand) * 4
           + chunks_read * cand * (d + 4) + b * d * 4 + b * k * 8)
    return Work(byt, {"bf16": 2.0 * b * n * r, "fp32": 2.0 * b * d * r,
                      "int8": 2.0 * b * kc * cand * d})


def encoder_flops(lengths, h: int, f: int, layers: int,
                  cls_only_last: bool, head: int = 0) -> float:
    """Forward FLOPs of a post-LN encoder over rows of real (unpadded)
    ``lengths``: per layer the q, k, v and output projections (8 L h^2),
    the FFN (4 L h f) and attention (4 L^2 h); with ``cls_only_last`` the
    last layer's queries, output projection and FFN for position 0 only;
    ``head`` FLOPs per row on top."""
    n = np.asarray(lengths, dtype=np.float64)
    full = 8 * n * h * h + 4 * n * h * f + 4 * n * n * h
    if cls_only_last:
        last = 4 * n * h * h + 4 * h * h + 4 * h * f + 4 * n * h
        per_row = (layers - 1) * full + last
    else:
        per_row = layers * full
    return float((per_row + head).sum())
