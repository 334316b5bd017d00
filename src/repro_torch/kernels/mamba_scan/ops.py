"""The model-facing selective-scan op: makes its inputs contiguous (the
model's B and C are slices of one projection) and calls the wrapper."""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import selective_scan


def selective_scan_op(u, dt, A, Bm, Cm, D, *,
                      h0: Optional[torch.Tensor] = None):
    """u/dt (B, S, dI); A (dI, N); Bm/Cm (B, S, N); D (dI,);
    h0 (B, dI, N) or None. → (y (B, S, dI), h_final (B, dI, N))."""
    return selective_scan(u.contiguous(), dt.contiguous(), A.contiguous(),
                          Bm.contiguous(), Cm.contiguous(), D.contiguous(),
                          h0=None if h0 is None else h0.contiguous())
