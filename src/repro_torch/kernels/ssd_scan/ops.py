"""The model-facing SSD scan op: makes its inputs contiguous (the model's
u, B and C are views of one projection) and calls the wrapper, through an
autograd function where a gradient is wanted.

On the CPU the plain version runs under PyTorch's autograd as it is. On the
card a call whose inputs require a gradient (with grad mode on) goes
through ``SsdScan``, in either entry (u, B and C all f32, or all bf16 as a
bf16 model passes them under ``ssm_bf16``): its forward launches that
entry's kernel and keeps only the inputs (so a remat region keeps its
memory), its backward launches the same entry's backward kernel
(``ssd_scan_bwd``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..flash_attention.ops import wants_grad
from .kernel import ssd_scan, ssd_scan_bwd


class SsdScan(torch.autograd.Function):
    """The kernel forward and its backward kernel, f32 or bf16 entry by u's
    dtype, for CUDA tensors (on CPU tensors the wrappers' plain versions,
    in chunks of ``chunk``)."""

    @staticmethod
    def forward(ctx, u, dt, A, Bm, Cm, D, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, A, Bm, Cm, D, h0)
        ctx.chunk = chunk
        return ssd_scan(u, dt, A, Bm, Cm, D, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, A, Bm, Cm, D, h0 = ctx.saved_tensors
        dy = torch.zeros_like(u) if dy is None else dy.contiguous()
        grads = ssd_scan_bwd(u, dt, A, Bm, Cm, D, dy, chunk=ctx.chunk, h0=h0,
                             dh=None if dh is None else dh.contiguous())
        return grads + (None,)


def ssd_scan_op(u, dt, A, Bm, Cm, D, *, chunk: Optional[int] = None,
                h0: Optional[torch.Tensor] = None):
    """u (B, S, H, hp); dt (B, S, H); A/D (H,); Bm/Cm (B, S, N);
    h0 (B, H, N, hp) or None; chunk: the plain version's chunk length (CPU
    only, see ``ssd_scan``). → (y (B, S, H, hp), h (B, H, N, hp))."""
    args = [t.contiguous() for t in (u, dt, A, Bm, Cm, D)]
    h0 = None if h0 is None else h0.contiguous()
    if u.device.type == "cuda" and wants_grad(*args, *(
            () if h0 is None else (h0,))):
        return SsdScan.apply(*args, h0, chunk)
    return ssd_scan(*args, chunk=chunk, h0=h0)
