"""Selective scan (Mamba-1): Hopper CUDA kernels (forward, backward) and
plain PyTorch versions."""

from .kernel import selective_scan, selective_scan_bwd
from .ops import SelectiveScanF32, selective_scan_op
from .ref import selective_scan_bwd_ref, selective_scan_ref

__all__ = ["SelectiveScanF32", "selective_scan", "selective_scan_bwd",
           "selective_scan_bwd_ref", "selective_scan_op",
           "selective_scan_ref"]
