"""Device-resident dense index: layout, padding, host quantization, and the
``.npz`` format the JAX package's ``index/store.py`` reads and writes.

Rows are padded to a multiple of ``chunk_rows`` and ``n_docs``
is kept so padded rows are masked in search.  On disk a bf16 payload and
``pca_proj`` are stored as uint16 bit patterns (numpy has no bf16).

Online updates (``append``, ``replace``, ``delete_swap``) follow the JAX
store's arithmetic: new rows are quantized on the host as ``build`` does
(true division by 127, which is what the JAX store's eager
``quantize_rows`` computes), the PCA projection of a stored row is an fp32
product on the device, and certificate bounds only ever grow.  The JAX
store donates its buffers; the port writes into them in place, so an
update's input index shares (and sees) the written buffers: use only the
returned index afterwards.

Sharding (``build(n_shards=, mesh=)``, ``shard``, ``load(mesh=)``): the
rows are padded to a multiple of ``chunk_rows × n_shards`` and split by
rows over the mesh's ``index`` axis (``core.mesh.Sharded``): the vectors,
scales and projections by rows, the certificate bounds along their chunk
axis, the rotation kept whole on the mesh's home device.  Updates write
into the shards in place; growth rebuilds each shard's block at the longer
length on its own device from the old blocks.  ``save``
writes the global arrays, the file of an unsharded index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.mesh import INDEX_AXIS, Mesh, Sharded
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


def quantize_host(x: np.ndarray):
    """Symmetric per-row int8 on the host: (int8 rows, fp32 scales), the
    scale max|x| / 127 (floor 1e-10), values rounded half to even."""
    q = np.empty(x.shape, np.int8)
    sc = np.empty((x.shape[0],), np.float32)
    for s0 in range(0, x.shape[0], 65536):
        e0 = min(s0 + 65536, x.shape[0])
        chunk = x[s0:e0]
        s_chunk = np.maximum(np.max(np.abs(chunk), axis=1) / 127.0,
                             1e-10).astype(np.float32)
        q[s0:e0] = np.clip(np.round(chunk / s_chunk[:, None]),
                           -127, 127).astype(np.int8)
        sc[s0:e0] = s_chunk
    return q, sc


def _u16_to_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                            ).view(torch.bfloat16)


def _whole(x, device):
    """A field as one tensor on ``device``: a Sharded one gathered."""
    if isinstance(x, Sharded):
        return x.gather(device)
    return None if x is None else x.to(device)


def _pieces(x, start: int, m: int):
    """(tensor, local start, offset in the range, length) of each piece of
    rows start .. start + m - 1 of ``x`` (a tensor, or Sharded by rows)
    that this process holds."""
    if not isinstance(x, Sharded):
        return [(x, start, 0, m)]
    n = x.block_len
    out = []
    for s, blk in enumerate(x.blocks):
        lo, hi = max(start, s * n), min(start + m, (s + 1) * n)
        if lo < hi and blk is not None:
            out.append((blk, lo - s * n, lo - start, hi - lo))
    return out


def _write_rows(x, start: int, rows: torch.Tensor) -> None:
    for blk, at, off, m in _pieces(x, start, rows.shape[0]):
        blk[at:at + m] = rows[off:off + m].to(blk.device)


def _read_rows(x, start: int, m: int, device) -> torch.Tensor:
    parts = _pieces(x, start, m)
    if sum(p[3] for p in parts) != m:
        raise ValueError("another process holds these rows")
    return torch.cat([blk[at:at + n].to(device) for blk, at, _, n in parts])


def _max_cols(bounds, cols: torch.Tensor, vals: torch.Tensor) -> None:
    """bounds[:, cols] = max(bounds[:, cols], vals), ``bounds`` a tensor or
    Sharded along its chunk axis."""
    if not isinstance(bounds, Sharded):
        bounds.scatter_reduce_(1, cols.expand(4, -1), vals, reduce="amax")
        return
    n = bounds.block_len
    for s, blk in enumerate(bounds.blocks):
        sel = cols // n == s
        if blk is not None and bool(sel.any()):
            c = (cols[sel] - s * n).to(blk.device)
            blk.scatter_reduce_(1, c.expand(4, -1),
                                vals[:, sel].to(blk.device), reduce="amax")


def _read_cols(bounds, cols: torch.Tensor, device) -> torch.Tensor:
    if not isinstance(bounds, Sharded):
        return bounds[:, cols].clone()
    n = bounds.block_len
    return torch.stack([bounds.blocks[c // n][:, c % n].to(device)
                        for c in cols.tolist()], dim=1)


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
    mesh: Optional[Mesh] = None      # set: the arrays are Sharded over it

    @property
    def n_passages(self) -> int:
        """Distinct documents in the index (n_docs / multi_vector)."""
        return self.n_docs // self.multi_vector

    @classmethod
    def build(cls, embeddings: np.ndarray, *, chunk_rows: int = 4096,
              n_shards: int = 1, dtype: Union[str, torch.dtype] = "bfloat16",
              mesh: Optional[Mesh] = None, multi_vector: int = 1,
              pca_dims: Optional[int] = None, pca_cand_rows: int = 512,
              pca_sample: int = 131072, device=None) -> "DenseIndex":
        """The index of ``embeddings`` on ``device`` (default ``cuda``),
        rows padded to a multiple of ``chunk_rows × n_shards``; with a
        ``mesh``, built on the host and placed by ``shard(mesh)``."""
        if mesh is not None:
            return cls.build(
                embeddings, chunk_rows=chunk_rows, n_shards=n_shards,
                dtype=dtype, multi_vector=multi_vector, pca_dims=pca_dims,
                pca_cand_rows=pca_cand_rows, pca_sample=pca_sample,
                device="cpu").shard(mesh)
        dev = resolve_device(device)
        dt = _dtype(dtype)
        n, d = embeddings.shape
        assert n % max(multi_vector, 1) == 0, \
            "embedding rows must be a whole number of documents"
        n_pad = _round_up(n, chunk_rows * n_shards)
        out = np.zeros((n_pad, d), dtype=np.float32)
        out[:n] = np.asarray(embeddings, np.float32)
        scales = sc = None
        if dt == torch.int8:
            # host-side, chunk by chunk, in the JAX store's arithmetic
            q, sc = quantize_host(out)
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

    def shard(self, mesh: Mesh) -> "DenseIndex":
        """The index split by rows over ``mesh``'s index axis, each block on
        its shard's device (a view where it is there already): projections
        follow the rows, bounds shard along their chunk axis, the rotation
        goes whole to ``mesh.home``."""
        g = self if self.mesh is None else self.unshard()

        def split(t, axis=0):
            return None if t is None else Sharded.split(t, mesh, axis)

        return dataclasses.replace(
            g, vectors=split(g.vectors), scales=split(g.scales),
            pca_proj=split(g.pca_proj), pca_bounds=split(g.pca_bounds, 1),
            pca_rot=_whole(g.pca_rot, mesh.home), mesh=mesh)

    def unshard(self, device=None) -> "DenseIndex":
        """Every array whole on ``device`` (default: the mesh's home)."""
        if self.mesh is None:
            return self
        dev = self.mesh.home if device is None else device
        return dataclasses.replace(
            self, vectors=_whole(self.vectors, dev),
            scales=_whole(self.scales, dev),
            pca_proj=_whole(self.pca_proj, dev),
            pca_bounds=_whole(self.pca_bounds, dev),
            pca_rot=_whole(self.pca_rot, dev), mesh=None)

    # ---- online updates (serving) ----------------------------------------
    # Row arithmetic is in DOCUMENT units of `multi_vector` rows.

    def _stored_rows(self, embeddings: np.ndarray):
        """(rows in the index dtype, int8 scales or None) on the device."""
        x = np.array(embeddings, np.float32)     # a writable copy
        dev = self.vectors.device
        if self.scales is not None:
            q, sc = quantize_host(x)
            return torch.from_numpy(q).to(dev), torch.from_numpy(sc).to(dev)
        return torch.from_numpy(x).to(dev).to(self.vectors.dtype), None

    def _pca_ingest(self, proj, bounds, rows, scales_new, start: int):
        """Project newly stored rows and max their certificate bounds in.
        Bounds only ever grow, so every certificate issued afterwards stays
        a true upper bound; stale contributions of replaced or deleted rows
        cost tightness only.  ``rows`` are the stored rows (int8 values or
        bf16/fp32 rows)."""
        xd = rows.float()
        if scales_new is not None:
            xd = xd * scales_new.reshape(-1, 1)
        p = xd @ self.pca_rot
        pb = p.to(proj.dtype)
        pb32 = pb.float()
        quant = torch.stack([
            torch.sqrt(torch.clamp((xd * xd).sum(1) - (p * p).sum(1),
                                   min=0)),
            torch.linalg.vector_norm(p - pb32, dim=1),
            torch.linalg.vector_norm(pb32, dim=1),
            torch.linalg.vector_norm(xd, dim=1),
        ]) * (1 + 1e-6) + 1e-6          # fp32-accumulation safety margin
        _write_rows(proj, start, pb)
        cols = torch.arange(start, start + rows.shape[0],
                            device=pb.device) // self.pca_cand_rows
        _max_cols(bounds, cols, quant)
        return proj, bounds

    def append(self, embeddings: np.ndarray, *,
               chunk_rows: Optional[int] = None,
               n_shards: Optional[int] = None) -> "DenseIndex":
        """Add documents; returns the updated index.  New rows land in the
        tail padding when they fit; otherwise every buffer grows to the
        next multiple of ``chunk_rows × n_shards`` (defaults: the index's
        own layout granularity, and its mesh's shard count) with zero rows,
        and the bounds with zero chunks: a sharded index's blocks are
        rebuilt at the longer length, each on its own device
        (``Sharded.grow``)."""
        chunk_rows = chunk_rows or self.chunk_rows
        if n_shards is None:
            n_shards = 1 if self.mesh is None else self.mesh.shape[INDEX_AXIS]
        m = len(embeddings)
        rows, scales_new = self._stored_rows(embeddings)
        if m % self.multi_vector:
            raise ValueError("appended rows must be whole documents")
        vec, scales = self.vectors, self.scales
        proj, bounds = self.pca_proj, self.pca_bounds
        n_pad = vec.shape[0]
        if self.n_docs + m > n_pad:
            length = _round_up(self.n_docs + m, chunk_rows * n_shards)

            def grow(t, length, axis=0):
                if isinstance(t, Sharded):
                    return t.grow(length)
                shape = list(t.shape)
                shape[axis] = length - shape[axis]
                return torch.cat([t, t.new_zeros(shape)], dim=axis)

            vec = grow(vec, length)
            if scales is not None:
                scales = grow(scales, length)
            if proj is not None:
                if length % self.pca_cand_rows:
                    raise ValueError("the grown row count is not a multiple "
                                     "of pca_cand_rows")
                proj = grow(proj, length)
                bounds = grow(bounds, length // self.pca_cand_rows, axis=1)
        start = self.n_docs
        _write_rows(vec, start, rows)
        if scales is not None:
            _write_rows(scales, start, scales_new)
        if proj is not None:
            proj, bounds = self._pca_ingest(proj, bounds, rows, scales_new,
                                            start)
        return dataclasses.replace(self, vectors=vec, n_docs=self.n_docs + m,
                                   scales=scales, pca_proj=proj,
                                   pca_bounds=bounds)

    def replace(self, doc_id: int, embeddings: np.ndarray) -> "DenseIndex":
        """Overwrite one document's vector(s) in place."""
        rows, scales_new = self._stored_rows(embeddings)
        if rows.shape[0] != self.multi_vector:
            raise ValueError(f"a document is {self.multi_vector} rows, "
                             f"got {rows.shape[0]}")
        start = doc_id * self.multi_vector
        if not 0 <= start < self.n_docs:
            raise IndexError(f"doc_id {doc_id} out of range")
        _write_rows(self.vectors, start, rows)
        if self.scales is not None:
            _write_rows(self.scales, start, scales_new)
        if self.pca_proj is not None:
            self._pca_ingest(self.pca_proj, self.pca_bounds, rows,
                             scales_new, start)
        return dataclasses.replace(self)

    def delete_swap(self, doc_id: int):
        """Swap-delete a document: the LAST document moves into its slot and
        n_docs shrinks (the freed rows stay masked by n_valid in search).
        Returns (index, moved_doc_id): the caller moves the same row of its
        doc table, or nothing when the moved id is None (the last document
        was deleted).  The moved rows take their source chunk's bounds, a
        sound (if loose) transfer without per-row bounds."""
        last = self.n_passages - 1
        if not 0 <= doc_id <= last:
            raise IndexError(f"doc_id {doc_id} out of range")
        mv = self.multi_vector
        moved = None
        if doc_id != last:
            dev = self.vectors.device
            for x in (self.vectors, self.scales, self.pca_proj):
                if x is not None:
                    _write_rows(x, doc_id * mv,
                                _read_rows(x, last * mv, mv, dev))
            if self.pca_proj is not None:
                r = torch.arange(mv, device=dev)
                srcs = (last * mv + r) // self.pca_cand_rows
                tgts = (doc_id * mv + r) // self.pca_cand_rows
                _max_cols(self.pca_bounds, tgts,
                          _read_cols(self.pca_bounds, srcs, dev))
            moved = last
        return dataclasses.replace(self, n_docs=self.n_docs - mv), moved

    def save(self, path: str):
        """The ``.npz`` of the global arrays, sharded or not."""
        if self.mesh is not None:
            return self.unshard("cpu").save(path)
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
    def load(cls, path: str, device=None,
             mesh: Optional[Mesh] = None) -> "DenseIndex":
        """The saved index on ``device`` (default ``cuda``); with a
        ``mesh``, read on the host and placed by ``shard(mesh)``."""
        if mesh is not None:
            return cls.load(path, device="cpu").shard(mesh)
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
