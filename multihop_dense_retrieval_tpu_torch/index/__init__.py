from .store import DenseIndex

__all__ = ["DenseIndex"]
