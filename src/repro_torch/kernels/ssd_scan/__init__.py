"""Fused SSD (Mamba-2) scan: Hopper CUDA kernels (forward, backward) and
plain PyTorch versions."""

from .kernel import ssd_scan, ssd_scan_bwd
from .ops import SsdScan, ssd_scan_op
from .ref import ssd_scan_bwd_ref, ssd_scan_ref

__all__ = ["SsdScan", "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_ref",
           "ssd_scan_op", "ssd_scan_ref"]
