"""Checkpoint files: ``torch.save`` of a state dict (nested dicts and
lists of tensors and plain numbers), read back with
``torch.load(weights_only=True)``.

Covers both uses of the JAX package's orbax module: a model's parameters
(``checkpoint_best.pt`` / ``checkpoint_last.pt``, the reference's
``torch.save(model.state_dict())`` layout) and the full trainer state for
a preemption resume.  A save lands in ``<path>.tmp`` and is renamed into
place, so a file that exists is complete.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def _path(p: str) -> str:
    return os.path.abspath(os.path.expanduser(p))


def save_pytree(path: str, tree: Any) -> None:
    path = _path(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_pytree(path: str, map_location="cpu") -> Any:
    return torch.load(_path(path), map_location=map_location,
                      weights_only=True)
