"""SPH cell-pair interaction kernels (Hopper CUDA + plain PyTorch)."""

from . import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
