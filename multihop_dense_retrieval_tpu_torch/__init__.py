"""PyTorch/CUDA port of the multi-hop dense retrieval serving engine.

Importing the package sets the numerics policy (no TF32 for fp32 matmuls
or convolutions, see ``core/device.py``).  Entry points take a ``device``;
the default is ``cuda`` and raises when CUDA is absent.
"""

from .core import device as _device  # noqa: F401  (sets the TF32 policy)
