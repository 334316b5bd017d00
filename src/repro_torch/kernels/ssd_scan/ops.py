"""The model-facing SSD scan op: makes its inputs contiguous (the model's
u, B and C are views of one projection) and calls the wrapper."""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import ssd_scan


def ssd_scan_op(u, dt, A, Bm, Cm, D, *, chunk: Optional[int] = None,
                h0: Optional[torch.Tensor] = None):
    """u (B, S, H, hp); dt (B, S, H); A/D (H,); Bm/Cm (B, S, N);
    h0 (B, H, N, hp) or None; chunk: the plain version's chunk length (CPU
    only, see ``ssd_scan``). → (y (B, S, H, hp), h (B, H, N, hp))."""
    return ssd_scan(u.contiguous(), dt.contiguous(), A.contiguous(),
                    Bm.contiguous(), Cm.contiguous(), D.contiguous(),
                    chunk=chunk,
                    h0=None if h0 is None else h0.contiguous())
