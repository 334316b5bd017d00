"""Selective scan (Mamba-1): Hopper CUDA kernel and plain PyTorch version."""

from .kernel import selective_scan
from .ops import selective_scan_op
from .ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_op", "selective_scan_ref"]
