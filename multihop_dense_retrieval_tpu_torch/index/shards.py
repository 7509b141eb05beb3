"""Sharded corpus encoding: worker shards and a host-side merge.

The port's copy of the JAX package's ``index/shards.py`` (same file names,
same loud failures).  Each worker encodes a contiguous doc slice and writes
a shard artifact into the shared output directory; ``merge_shards``
concatenates them into the standard index.npz / tokens.npz / id2doc.json
layout: with ``--merge-only``, or on rank 0 after ``cli/pod``'s
processes each encoded theirs.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional, Tuple

import numpy as np

from ..data.corpus import Corpus, TokenizedCorpus
from .store import DenseIndex


def shard_bounds(n: int, num_shards: int, shard_id: int) -> Tuple[int, int]:
    """Contiguous, balanced [lo, hi) doc range of shard ``shard_id``."""
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
    return shard_id * n // num_shards, (shard_id + 1) * n // num_shards


def _emb_path(out_dir: str, i: int, n: int) -> str:
    return os.path.join(out_dir, f"emb_shard{i}-of-{n}.npy")


def _tokens_path(out_dir: str, i: int, n: int) -> str:
    return os.path.join(out_dir, f"tokens_shard{i}-of-{n}.npz")


def _id2doc_path(out_dir: str, i: int, n: int) -> str:
    return os.path.join(out_dir, f"id2doc_shard{i}-of-{n}.json")


def save_shard(out_dir: str, shard_id: int, num_shards: int,
               emb: np.ndarray, tc: TokenizedCorpus, corpus_slice: Corpus):
    """Write one shard's artifacts (fp32 embeddings, token slice, id2doc
    slice keyed 0..n_i-1; the merge re-keys with global offsets)."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(_emb_path(out_dir, shard_id, num_shards),
            np.asarray(emb, np.float32))
    tc.save(_tokens_path(out_dir, shard_id, num_shards))
    corpus_slice.save_id2doc(_id2doc_path(out_dir, shard_id, num_shards))


def detect_num_shards(out_dir: str) -> Optional[int]:
    """Infer the shard count from the emb_shard*-of-<N>.npy files present."""
    ns = set()
    for p in glob.glob(os.path.join(out_dir, "emb_shard*-of-*.npy")):
        m = re.match(r"emb_shard(\d+)-of-(\d+)\.npy$", os.path.basename(p))
        if m:
            ns.add(int(m.group(2)))
    if len(ns) > 1:
        raise ValueError(f"mixed shard counts in {out_dir}: {sorted(ns)}")
    return ns.pop() if ns else None


def merge_shards(out_dir: str, num_shards: Optional[int] = None, *,
                 chunk_rows: int = 4096, dtype: str = "bfloat16",
                 multi_vector: int = 1, pca_dims: Optional[int] = None,
                 pca_cand_rows: int = 512, keep_shards: bool = False,
                 device=None) -> DenseIndex:
    """Concatenate shard artifacts into the final index layout; the index
    is built on ``device`` (default ``cuda``) by ``DenseIndex.build`` from
    the merged embeddings, the same artifacts as a single run.  A missing
    shard fails loudly (a gap would mis-key every doc after it)."""
    if num_shards is None:
        num_shards = detect_num_shards(out_dir)
        if num_shards is None:
            raise FileNotFoundError(f"no shard artifacts in {out_dir}")
    missing = [i for i in range(num_shards)
               if not os.path.exists(_emb_path(out_dir, i, num_shards))]
    if missing:
        raise FileNotFoundError(
            f"missing embedding shards {missing} of {num_shards} in "
            f"{out_dir}: encode them before merging")

    embs, tcs, id2docs = [], [], []
    for i in range(num_shards):
        embs.append(np.load(_emb_path(out_dir, i, num_shards)))
        tcs.append(TokenizedCorpus.load(_tokens_path(out_dir, i,
                                                     num_shards)))
        with open(_id2doc_path(out_dir, i, num_shards)) as f:
            id2docs.append(json.load(f))

    widths = {(t.text_ids.shape[1], t.title_ids.shape[1]) for t in tcs}
    if len(widths) > 1:
        raise ValueError(
            f"shards tokenized at different widths {sorted(widths)}: "
            "re-encode with matching --max-c-len")

    emb = np.concatenate(embs, axis=0)
    del embs
    index = DenseIndex.build(emb, chunk_rows=chunk_rows, dtype=dtype,
                             multi_vector=multi_vector, pca_dims=pca_dims,
                             pca_cand_rows=pca_cand_rows, device=device)
    index.save(os.path.join(out_dir, "index.npz"))

    tc = TokenizedCorpus(
        *(np.concatenate([getattr(t, name) for t in tcs])
          for name in ("text_ids", "text_lens", "title_ids", "title_lens",
                       "empty")))
    tc.save(os.path.join(out_dir, "tokens.npz"))

    merged, off = {}, 0
    for table in id2docs:
        for k, v in table.items():
            merged[str(int(k) + off)] = v
        off += len(table)
    with open(os.path.join(out_dir, "id2doc.json"), "w") as f:
        json.dump(merged, f)

    if not keep_shards:
        for i in range(num_shards):
            for pth in (_emb_path(out_dir, i, num_shards),
                        _tokens_path(out_dir, i, num_shards),
                        _id2doc_path(out_dir, i, num_shards)):
                os.remove(pth)
    return index
