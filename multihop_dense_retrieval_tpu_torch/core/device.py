"""Device resolution and numerics policy for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

# A float32 matmul or convolution must not silently run in TF32: the
# parity tolerances against the JAX package assume full fp32 products.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "the plain PyTorch path")
    return dev


def normal_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with a bare ``cuda`` given the current card's index, so
    that it compares equal to the device of a tensor placed there."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def world() -> tuple:
    """(rank, world size) of this process in ``torch.distributed`` when it
    is initialised, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> int:
    """Rank of this process: the process that owns shared-filesystem
    writes is rank 0."""
    return world()[0]
