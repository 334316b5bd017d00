"""The model-facing selective-scan op: makes its inputs contiguous (the
model's B and C are slices of one projection) and calls the wrapper.

The kernel has no backward yet: on the card a call whose inputs require a
gradient (with grad mode on) raises, rather than return outputs cut off from
their inputs' gradients. On the CPU the plain version runs under autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..flash_attention.ops import wants_grad
from .kernel import selective_scan


def selective_scan_op(u, dt, A, Bm, Cm, D, *,
                      h0: Optional[torch.Tensor] = None):
    """u/dt (B, S, dI); A (dI, N); Bm/Cm (B, S, N); D (dI,);
    h0 (B, dI, N) or None. → (y (B, S, dI), h_final (B, dI, N))."""
    if u.device.type == "cuda" and wants_grad(u, dt, A, Bm, Cm, D, *(
            () if h0 is None else (h0,))):
        raise NotImplementedError(
            "selective_scan: the kernel has no backward yet (ROADMAP queue 1, item "
            "13f: training of the Mamba kinds); call it under torch.no_grad()")
    return selective_scan(u.contiguous(), dt.contiguous(), A.contiguous(),
                          Bm.contiguous(), Cm.contiguous(), D.contiguous(),
                          h0=None if h0 is None else h0.contiguous())
