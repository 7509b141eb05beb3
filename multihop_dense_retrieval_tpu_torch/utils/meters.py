"""Metric smoothing and lightweight scalar logging (the JAX package's
``utils/meters.py``).

``AverageMeter`` keeps a running mean; ``MetricWriter`` writes TensorBoard
scalars through tensorboardX when it is importable, else one JSON line per
scalar to ``<log_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time

from ..core.device import process_index


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n


class MetricWriter:
    """TensorBoard scalars when tensorboardX is importable, else JSONL.

    Only process 0 writes (rank 0 of ``torch.distributed`` when it is
    initialised); every other process gets a no-op writer."""

    def __init__(self, log_dir: str):
        self._tb = None
        self._jsonl = None
        if process_index() != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter  # optional

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "ts": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        elif self._jsonl is not None:
            self._jsonl.close()
