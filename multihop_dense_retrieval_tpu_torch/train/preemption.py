"""Preemption-safe full-trainer-state checkpointing (the JAX package's
``train/preemption.py``, over the port's checkpoint files).

On a preemption signal the trainer finishes its epoch, saves its complete
state (parameters, optimizer, step, the momentum stage's key encoder and
queue) with a small JSON sidecar (epoch, best metric, the loader's
data-order RNG), and exits; a requeued process calls ``maybe_restore`` at
start-up and resumes where it left off.
"""

from __future__ import annotations

import json
import os
import signal
from typing import Any, Dict, Optional

from ..core import checkpoint as ckpt
from ..core.device import process_index


class PreemptionCheckpointer:
    def __init__(self, directory: str):
        self.dir = directory
        self._preempted = False

    # -- signal-based preemption hook (SLURM sends SIGTERM/SIGUSR1) -------

    def install_signal_handler(self, signals=(signal.SIGTERM,)):
        for sig in signals:
            signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    # -- state io ----------------------------------------------------------

    def save(self, state: Any, *, epoch: int, best_metric: float,
             rng_state: Optional[Dict] = None):
        if process_index() != 0:
            return
        os.makedirs(self.dir, exist_ok=True)
        state_path = os.path.join(self.dir, "trainer_state")
        new_path, old_path = state_path + ".new", state_path + ".old"
        # the new state lands beside the previous one, which stays
        # restorable until the new one is complete on disk; each swap step
        # below is an atomic rename (maybe_restore falls back to .old for
        # a kill between the renames)
        ckpt.save_pytree(new_path, state)
        # .old is displaced only when trainer_state exists to replace it:
        # after a crash between the two renames (state absent, .old the
        # only restorable checkpoint) removing .old first, then a kill
        # before the promote, would leave nothing restorable
        if os.path.isfile(state_path):
            if os.path.exists(old_path):
                os.remove(old_path)
            os.rename(state_path, old_path)
        os.rename(new_path, state_path)
        if os.path.exists(old_path):
            os.remove(old_path)
        # the sidecar is written atomically as well: a truncated file would
        # crash-loop every requeue
        meta_path = os.path.join(self.dir, "trainer_meta.json")
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "best_metric": best_metric,
                       "rng_state": rng_state}, f)
        os.replace(tmp, meta_path)

    def maybe_restore(self, map_location="cpu"):
        """Returns (state, meta) if a checkpoint exists, else (None, None)."""
        meta_path = os.path.join(self.dir, "trainer_meta.json")
        state_path = os.path.join(self.dir, "trainer_state")
        if not os.path.isfile(state_path):
            # killed between the two swap renames: the previous state sits
            # intact at .old; failing that, .new, which save_pytree writes
            # by a rename, so a present .new is complete (a kill after the
            # save and before the promote)
            for cand in (state_path + ".old", state_path + ".new"):
                if os.path.isfile(cand):
                    state_path = cand
                    break
        if not (os.path.exists(meta_path) and os.path.isfile(state_path)):
            return None, None
        with open(meta_path) as f:
            meta = json.load(f)
        return ckpt.restore_pytree(state_path, map_location), meta
