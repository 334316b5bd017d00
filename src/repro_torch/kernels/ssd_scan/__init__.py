"""Fused SSD (Mamba-2) scan: Hopper CUDA kernel and plain PyTorch version."""

from .kernel import ssd_scan
from .ops import ssd_scan_op
from .ref import ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_op", "ssd_scan_ref"]
