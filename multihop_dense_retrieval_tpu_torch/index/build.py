"""Bulk corpus encoding into a dense index (the JAX package's
``index/build.py``).

Passage views (title, text) are assembled on the device from the
pre-tokenized corpus with the engine's own ``assemble_pair_inputs`` and
encoded batch by batch.  The batch plan is the JAX package's, step for
step, so that every passage is encoded at the same width and gives the same
vector: a stable length sort, per-batch widths rounded up to multiples of
32 and capped at ``max_c_len``, and fixed super-batches of ``scan_batches``
batches encoded at their widest batch's width.  JAX runs a super-batch as
one jitted ``lax.scan``; here it is a Python loop, and the tail's padding
batches (whose outputs JAX discards) are not encoded at all.

With a ``mesh`` each batch is split into equal parts over the mesh's
``data`` devices, as JAX shards it over its data axis: part j is encoded
on data device j (by a copy of the encoder where it lives elsewhere) and
the rows come back in order.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import normal_device, resolve_device
from ..core.mesh import Mesh, on_device
from ..data.corpus import TokenizedCorpus
from ..data.tokenization import TokenizerSpec
from ..search.beam import assemble_pair_inputs
from .store import DenseIndex


def batch_plan(tc: TokenizedCorpus, spec: TokenizerSpec, *, max_c_len: int,
               batch_size: int, length_sort: bool, scan_batches: int):
    """Super-batches as (doc ids of each batch, true counts, width): each
    batch padded to ``batch_size`` with repeats of its first doc, the tail
    super-batch padded to ``scan_batches`` batches with count-0 repeats."""
    n = tc.text_ids.shape[0]
    total = (np.minimum(tc.title_lens, max_c_len)
             + np.minimum(tc.text_lens, max_c_len) + spec.num_special_pair)
    order = (np.argsort(total, kind="stable") if length_sort
             else np.arange(n))
    batches = []
    for s in range(0, n, batch_size):
        idx = order[s:s + batch_size]
        cnt = len(idx)
        if cnt < batch_size:
            idx = np.concatenate([idx, np.repeat(idx[:1], batch_size - cnt)])
        if length_sort:
            # exact: the width covers every row's assembled length, or is
            # max_c_len (the same truncation as the unsorted plan)
            width = min(-(-int(total[idx].max()) // 32) * 32, max_c_len)
        else:
            width = max_c_len
        batches.append((idx, cnt, width))
    supers = []
    for s in range(0, len(batches), scan_batches):
        grp = batches[s:s + scan_batches]
        while len(grp) < scan_batches:
            grp.append((grp[0][0], 0, grp[0][2]))
        supers.append(([b[0] for b in grp], [b[1] for b in grp],
                       max(b[2] for b in grp)))
    return supers


def _replicas(encode_fn: Callable, devices: list) -> list:
    """``encode_fn`` for each device: itself where its module lives, a copy
    of the module moved there elsewhere (the parameters replicated over the
    data axis, as a JAX mesh replicates them)."""
    devices = [normal_device(d) for d in devices]
    module = encode_fn if isinstance(encode_fn, torch.nn.Module) else \
        getattr(encode_fn, "__self__", None)
    if not isinstance(module, torch.nn.Module):
        if len(set(devices)) > 1:
            raise ValueError("encoding over several devices needs the "
                             "encoder as an nn.Module or a bound method of "
                             "one")
        return [encode_fn] * len(devices)
    copies = {next(module.parameters()).device: encode_fn}
    for d in devices:
        if d not in copies:
            twin = copy.deepcopy(module).to(d)
            copies[d] = twin if encode_fn is module else \
                getattr(twin, encode_fn.__name__)
    return [copies[d] for d in devices]


@torch.inference_mode()
def encode_corpus(encode_fn: Callable, tc: TokenizedCorpus,
                  spec: TokenizerSpec, *, max_c_len: int = 300,
                  batch_size: int = 256, mesh: Optional[Mesh] = None,
                  progress: bool = False, multi_vector: int = 1,
                  length_sort: bool = True, scan_batches: int = 16,
                  device=None) -> np.ndarray:
    """(N * multi_vector, H) fp32 embeddings of every passage, in corpus
    order.  ``encode_fn(input_ids, mask[, token_type_ids])`` returns
    (B * multi_vector, H) vectors, rows grouped per passage
    (``MhopRetriever.encode_seq`` or ``MultiVectorCtxEncoder``), and lives
    on ``device`` (default ``cuda``), or with a ``mesh`` on one of its
    data devices, over which each batch is split (``batch_size`` a
    multiple of their count)."""
    devs = [resolve_device(device)] if mesh is None else mesh.data_devices()
    if batch_size % len(devs):
        raise ValueError(f"batch size {batch_size} does not split over "
                         f"{len(devs)} data devices")
    fns = _replicas(encode_fn, devs)
    part = batch_size // len(devs)
    mv = max(multi_vector, 1)
    n = tc.text_ids.shape[0]
    supers = batch_plan(tc, spec, max_c_len=max_c_len, batch_size=batch_size,
                        length_sort=length_sort, scan_batches=scan_batches)
    if progress:
        try:
            from tqdm import tqdm
            supers = tqdm(supers, desc="encode corpus (super-batches)")
        except ImportError:
            pass

    def dev_ids(a, dev):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def encode(idx, text, width, dev, fn):
        with on_device(dev):
            inputs = assemble_pair_inputs(
                dev_ids(tc.title_ids[idx], dev),
                dev_ids(tc.title_lens[idx], dev), dev_ids(text[idx], dev),
                dev_ids(tc.text_lens[idx], dev), width, spec)
            args = [inputs["input_ids"], inputs["attention_mask"]]
            if "token_type_ids" in inputs:
                args.append(inputs["token_type_ids"])
            return fn(*args).float().to(devs[0])

    chunks = None
    for idx_list, cnts, width in supers:
        # doc tokens beyond the width are never kept: slice the view first
        # so that the gather copies only the kept columns
        text = tc.text_ids[:, :width]
        embs = []
        for idx, cnt in zip(idx_list, cnts):
            if cnt == 0:
                break
            embs.append(torch.cat([
                encode(idx[j * part:(j + 1) * part], text, width, dev, fn)
                for j, (dev, fn) in enumerate(zip(devs, fns))]))
        embs = torch.stack(embs).cpu().numpy()            # (nb, B*mv, H)
        if chunks is None:
            chunks = np.empty((n * mv, embs.shape[-1]), np.float32)
        for j, (idx, cnt) in enumerate(zip(idx_list, cnts[:len(embs)])):
            rows = (idx[:cnt, None] * mv + np.arange(mv)[None, :]).reshape(-1)
            chunks[rows] = embs[j, :cnt * mv]
    if chunks is None:
        return np.zeros((0, 0), np.float32)
    return chunks


def build_index(encode_fn: Callable, tc: TokenizedCorpus,
                spec: TokenizerSpec, *, max_c_len: int = 300,
                batch_size: int = 256, chunk_rows: int = 4096,
                n_shards: int = 1, dtype: str = "bfloat16",
                mesh: Optional[Mesh] = None, progress: bool = False,
                multi_vector: int = 1, length_sort: bool = True,
                pca_dims: Optional[int] = None, pca_cand_rows: int = 512,
                device=None) -> DenseIndex:
    """``encode_corpus`` then ``DenseIndex.build`` on ``device``, or on
    ``mesh`` (padded to a multiple of ``chunk_rows × n_shards``)."""
    emb = encode_corpus(encode_fn, tc, spec, max_c_len=max_c_len,
                        batch_size=batch_size, mesh=mesh, progress=progress,
                        multi_vector=multi_vector, length_sort=length_sort,
                        device=device)
    return DenseIndex.build(emb, chunk_rows=chunk_rows, n_shards=n_shards,
                            dtype=dtype, mesh=mesh, multi_vector=multi_vector,
                            pca_dims=pca_dims, pca_cand_rows=pca_cand_rows,
                            device=device)
