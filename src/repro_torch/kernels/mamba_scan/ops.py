"""The model-facing selective-scan op: makes its inputs contiguous (the
model's B and C are slices of one projection) and calls the wrapper,
through an autograd function where a gradient is wanted.

On the CPU the plain version runs under PyTorch's autograd as it is. On the
card a call whose inputs require a gradient (with grad mode on) goes
through ``SelectiveScanF32``: its forward launches the f32 kernel and keeps
only the inputs (so a remat region keeps its memory), its backward
launches the backward kernel (``selective_scan_bwd``). The bf16 entry has no
backward kernel: no model trains through a bf16 Mamba-1 scan, because the
reference upcasts u to f32 before it (``repro/models/mamba.py:130``) and
the port's model does the same. So a bf16 call that wants a gradient
raises rather than return outputs cut off from their inputs' gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..flash_attention.ops import wants_grad
from .kernel import selective_scan, selective_scan_bwd


class SelectiveScanF32(torch.autograd.Function):
    """The f32 kernel forward and its backward kernel, for CUDA tensors
    (on CPU tensors the wrappers' plain versions)."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm, D, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, A, Bm, Cm, D, h0)
        return selective_scan(u, dt, A, Bm, Cm, D, h0=h0)

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, A, Bm, Cm, D, h0 = ctx.saved_tensors
        dy = torch.zeros_like(u) if dy is None else dy.contiguous()
        return selective_scan_bwd(u, dt, A, Bm, Cm, D, dy, h0=h0,
                                  dh=None if dh is None else dh.contiguous())


def selective_scan_op(u, dt, A, Bm, Cm, D, *,
                      h0: Optional[torch.Tensor] = None):
    """u/dt (B, S, dI); A (dI, N); Bm/Cm (B, S, N); D (dI,);
    h0 (B, dI, N) or None. → (y (B, S, dI), h_final (B, dI, N))."""
    args = [t.contiguous() for t in (u, dt, A, Bm, Cm, D)]
    h0 = None if h0 is None else h0.contiguous()
    if u.device.type == "cuda" and wants_grad(*args, *(
            () if h0 is None else (h0,))):
        if u.dtype != torch.float32:
            raise NotImplementedError(
                "selective_scan: the bf16 entry has no backward kernel: no "
                "model trains through a bf16 Mamba-1 scan (the reference "
                "upcasts u to float32 before it); pass float32")
        return SelectiveScanF32.apply(*args, h0)
    return selective_scan(*args, h0=h0)
