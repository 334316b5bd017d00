"""The model-facing flash attention op: makes its inputs contiguous (the
model's q, k, v are views of projections) and calls the wrapper, through an
autograd function where a gradient is wanted.

On the CPU the plain version runs under PyTorch's autograd as it is. On the
card a call whose inputs require a gradient (with grad mode on) goes
through ``FlashAttentionFn``: its forward launches the kernel of the
inputs' dtype (the f32 or the bf16 entry) and keeps the row log-sum-exp,
its backward launches that entry's backward kernels
(``flash_attention_bwd``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention, flash_attention_bwd


class FlashAttentionFn(torch.autograd.Function):
    """A kernel forward (f32 or bf16) and its backward kernel, for CUDA
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         **ctx.mask)
        return dq, dk, dv, None, None, None


def wants_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None):
    """q (B, S, H, hd); k/v (B, T, K, hd), H = K·G. → (B, S, H, hd)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.device.type == "cuda" and wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)
