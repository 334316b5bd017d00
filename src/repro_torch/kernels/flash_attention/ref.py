"""Plain PyTorch version of flash attention.

The same function as the reference's Pallas ``flash_attention``
(``repro/kernels/flash_attention/kernel.py``) and its oracle
``attention_ref``: softmax attention with causal and sliding-window masks,
an optional soft-cap (``softcap · tanh(s / softcap)`` on the scaled scores,
before the mask, as the reference's ``_sdpa``) and GQA head grouping
(H = K·G, no copy of K or V), written as the full (S × T) score matrix.
Query row i sits at key position i + (T − S). A row with no live key gives
zeros. f32 math, returned in q's dtype.

This is the CPU path of
:func:`repro_torch.kernels.flash_attention.flash_attention` and the oracle of
the CUDA kernel (``csrc/flash_attention.cu``) on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """q (B, S, H, hd); k/v (B, T, K, hd) with H = K·G. → (B, S, H, hd)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    f32 = torch.float32
    qg = q.to(f32).reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(f32)) / math.sqrt(hd)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    scores = scores.masked_fill(~ok, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)                 # rows with no live key
    out = torch.einsum("bkgst,btkh->bskgh", p, v.to(f32))
    return out.reshape(B, S, H, hd).to(q.dtype)
