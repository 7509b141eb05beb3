"""Static-shape batch loader (a numpy-only copy of the JAX package's
``data/loader.py``: the same seed gives the same batches).

Replaces torch DataLoader + samplers (scripts/train_mhop.py:156-157).  Epochs
shuffle indices with a seeded RNG; partial trailing batches are dropped in
training and padded-by-repeat in eval (with a `valid` mask so
metrics ignore the padding).  Prefetches with a small thread pool — host-side
tokenization overlaps device compute.

Determinism under threading: datasets that randomize per sample (negative
shuffles etc.) expose `getitem_rng(i, rng)`; the loader derives ONE RandomState
per sample from (an epoch base drawn from the loader RNG, the sample index),
so sample content is independent of thread scheduling.  Sharing the dataset's
own RandomState across pool workers raced draws (non-thread-safe state,
schedule-dependent order) and silently broke seeded reproducibility AND the
preemption resume replay below.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
from typing import Dict, Iterator, Optional

import numpy as np


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: Optional[bool] = None, seed: int = 0,
                 num_workers: int = 8, collate=None):
        from .mhop_dataset import mhop_collate

        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        self.collate = collate or mhop_collate

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    # -- data-order RNG snapshot (preemption resume) ---------------------
    # JSON-serializable Mersenne state: a resumed run replays the SAME
    # shuffle sequence (and per-sample seed bases) an uninterrupted run
    # would have seen.

    def rng_state(self) -> dict:
        alg, keys, pos, has_gauss, cached = self.rng.get_state()
        return {"alg": alg, "keys": np.asarray(keys).tolist(),
                "pos": int(pos), "has_gauss": int(has_gauss),
                "cached": float(cached)}

    def set_rng_state(self, st: dict):
        self.rng.set_state((st["alg"], np.asarray(st["keys"], np.uint32),
                            st["pos"], st["has_gauss"], st["cached"]))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        # one sequential draw per epoch; per-sample streams derive from it
        base = int(self.rng.randint(0, 2**31 - 1))
        batches = []
        for s in range(0, n, self.bs):
            chunk = order[s:s + self.bs]
            if len(chunk) < self.bs:
                if self.drop_last:
                    continue
                pad = np.resize(chunk, self.bs)  # repeat to fill
                valid = np.zeros(self.bs, bool)
                valid[:len(chunk)] = True
                batches.append((pad, valid))
            else:
                batches.append((chunk, np.ones(self.bs, bool)))

        fetch_rng = getattr(self.ds, "getitem_rng", None)

        def fetch(i: int):
            if fetch_rng is None:
                return self.ds[int(i)]
            seed = int(np.random.SeedSequence([base, int(i)])
                       .generate_state(1)[0])
            return fetch_rng(int(i), np.random.RandomState(seed))

        def make(args):
            idxs, valid = args
            batch = self.collate([fetch(i) for i in idxs])
            batch["valid"] = valid
            return batch

        if self.num_workers <= 1:
            for b in batches:
                yield make(b)
            return
        # bounded in-flight window: Executor.map would submit the WHOLE
        # epoch up front, piling every tokenized-but-unconsumed batch in
        # host memory while the device drains them one at a time
        window = self.num_workers * 2
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            futs = collections.deque()
            it = iter(batches)
            for b in itertools.islice(it, window):
                futs.append(pool.submit(make, b))
            while futs:
                out = futs.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    futs.append(pool.submit(make, nxt))
                yield out
