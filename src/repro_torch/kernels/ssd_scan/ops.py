"""The model-facing SSD scan op: makes its inputs contiguous (the model's
u, B and C are views of one projection) and calls the wrapper.

The kernel has no backward yet: on the card a call whose inputs require a
gradient (with grad mode on) raises, rather than return outputs cut off from
their inputs' gradients. On the CPU the plain version runs under autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..flash_attention.ops import wants_grad
from .kernel import ssd_scan


def ssd_scan_op(u, dt, A, Bm, Cm, D, *, chunk: Optional[int] = None,
                h0: Optional[torch.Tensor] = None):
    """u (B, S, H, hp); dt (B, S, H); A/D (H,); Bm/Cm (B, S, N);
    h0 (B, H, N, hp) or None; chunk: the plain version's chunk length (CPU
    only, see ``ssd_scan``). → (y (B, S, H, hp), h (B, H, N, hp))."""
    if u.device.type == "cuda" and wants_grad(u, dt, A, Bm, Cm, D, *(
            () if h0 is None else (h0,))):
        raise NotImplementedError(
            "ssd_scan: the kernel has no backward yet (ROADMAP queue 1, item "
            "13f: training of the Mamba kinds); call it under torch.no_grad()")
    return ssd_scan(u.contiguous(), dt.contiguous(), A.contiguous(),
                    Bm.contiguous(), Cm.contiguous(), D.contiguous(),
                    chunk=chunk,
                    h0=None if h0 is None else h0.contiguous())
