"""The model-facing flash attention op: makes its inputs contiguous (the
model's q, k, v are views of projections) and calls the wrapper."""

from __future__ import annotations

from typing import Optional

from .kernel import flash_attention


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None):
    """q (B, S, H, hd); k/v (B, T, K, hd), H = K·G. → (B, S, H, hd)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)
