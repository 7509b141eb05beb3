"""Device-resident dense index: layout, padding, host quantization, and the
``.npz`` format the JAX package's ``index/store.py`` reads and writes.

Rows are padded to a multiple of ``chunk_rows`` and ``n_docs``
is kept so padded rows are masked in search.  On disk a bf16 payload and
``pca_proj`` are stored as uint16 bit patterns (numpy has no bf16).
Online updates and sharding are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.mips import build_pca_prefilter, train_pca_rotation

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def _bf16_to_u16(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def _u16_to_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                            ).view(torch.bfloat16)


@dataclasses.dataclass
class DenseIndex:
    vectors: torch.Tensor            # (N_pad, D): bf16, fp32 or int8
    n_docs: int                      # true row count
    scales: Optional[torch.Tensor] = None   # (N_pad,) fp32, int8 only
    multi_vector: int = 1            # rows per document (doc = row // m)
    chunk_rows: int = 4096           # layout granularity of the padding
    pca_rot: Optional[torch.Tensor] = None      # (D, R) fp32
    pca_proj: Optional[torch.Tensor] = None     # (N_pad, R) bf16
    pca_bounds: Optional[torch.Tensor] = None   # (4, N_pad/cand_rows) fp32
    pca_cand_rows: int = 512

    @property
    def n_passages(self) -> int:
        """Distinct documents in the index (n_docs / multi_vector)."""
        return self.n_docs // self.multi_vector

    @classmethod
    def build(cls, embeddings: np.ndarray, *, chunk_rows: int = 4096,
              dtype: Union[str, torch.dtype] = "bfloat16",
              multi_vector: int = 1, pca_dims: Optional[int] = None,
              pca_cand_rows: int = 512, pca_sample: int = 131072,
              device=None) -> "DenseIndex":
        dev = resolve_device(device)
        dt = _dtype(dtype)
        n, d = embeddings.shape
        assert n % max(multi_vector, 1) == 0, \
            "embedding rows must be a whole number of documents"
        n_pad = _round_up(n, chunk_rows)
        out = np.zeros((n_pad, d), dtype=np.float32)
        out[:n] = np.asarray(embeddings, np.float32)
        scales = sc = None
        if dt == torch.int8:
            # host-side, chunk by chunk, in the JAX store's arithmetic
            q = np.empty((n_pad, d), np.int8)
            sc = np.empty((n_pad,), np.float32)
            for s0 in range(0, n_pad, 65536):
                e0 = min(s0 + 65536, n_pad)
                x = out[s0:e0]
                s_chunk = np.maximum(np.max(np.abs(x), axis=1) / 127.0,
                                     1e-10).astype(np.float32)
                q[s0:e0] = np.clip(np.round(x / s_chunk[:, None]),
                                   -127, 127).astype(np.int8)
                sc[s0:e0] = s_chunk
            arr = torch.from_numpy(q).to(dev)
            scales = torch.from_numpy(sc).to(dev)
        else:
            arr = torch.from_numpy(out).to(dt).to(dev)
        rot = proj = bounds = None
        if pca_dims:
            assert n_pad % pca_cand_rows == 0, \
                "pca_cand_rows must divide the padded row count"
            rot_np = train_pca_rotation(out[:min(n, pca_sample)],
                                        min(pca_dims, d))
            proj_np, bounds_np = build_pca_prefilter(
                out, rot_np, cand_rows=pca_cand_rows, scales=sc,
                store_dtype=_NAMES[dt])
            rot = torch.from_numpy(rot_np).to(dev)
            proj = torch.from_numpy(proj_np).to(torch.bfloat16).to(dev)
            bounds = torch.from_numpy(bounds_np).to(dev)
        return cls(vectors=arr, n_docs=n, scales=scales,
                   multi_vector=max(multi_vector, 1), chunk_rows=chunk_rows,
                   pca_rot=rot, pca_proj=proj, pca_bounds=bounds,
                   pca_cand_rows=pca_cand_rows)

    def save(self, path: str):
        extra = {"multi_vector": self.multi_vector,
                 "chunk_rows": self.chunk_rows}
        if self.scales is not None:
            extra["scales"] = self.scales.cpu().numpy()
        if self.pca_proj is not None:
            extra["pca_rot"] = self.pca_rot.cpu().numpy()
            extra["pca_proj"] = _bf16_to_u16(self.pca_proj)
            extra["pca_bounds"] = self.pca_bounds.cpu().numpy()
            extra["pca_cand_rows"] = self.pca_cand_rows
        if self.vectors.dtype == torch.bfloat16:
            np.savez(path, payload=_bf16_to_u16(self.vectors),
                     dtype="bfloat16", n_docs=self.n_docs, **extra)
        else:
            host = self.vectors.cpu().numpy()
            np.savez(path, payload=host, dtype=str(host.dtype),
                     n_docs=self.n_docs, **extra)

    @classmethod
    def load(cls, path: str, device=None) -> "DenseIndex":
        dev = resolve_device(device)
        z = np.load(path)
        payload, dtype = z["payload"], str(z["dtype"])
        if dtype == "bfloat16":
            arr = _u16_to_bf16(payload)
        else:
            arr = torch.from_numpy(np.array(payload))
        scales = (torch.from_numpy(np.array(z["scales"])).to(dev)
                  if "scales" in z.files else None)
        pca = {}
        if "pca_proj" in z.files:
            pca = dict(
                pca_rot=torch.from_numpy(np.array(z["pca_rot"])).to(dev),
                pca_proj=_u16_to_bf16(z["pca_proj"]).to(dev),
                pca_bounds=torch.from_numpy(np.array(z["pca_bounds"])).to(dev),
                pca_cand_rows=int(z["pca_cand_rows"]))
        mv = int(z["multi_vector"]) if "multi_vector" in z.files else 1
        cr = int(z["chunk_rows"]) if "chunk_rows" in z.files else 4096
        return cls(vectors=arr.to(dev), n_docs=int(z["n_docs"]),
                   scales=scales, multi_vector=mv, chunk_rows=cr, **pca)
