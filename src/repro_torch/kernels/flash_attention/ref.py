"""Plain PyTorch version of flash attention.

The same function as the reference's Pallas ``flash_attention``
(``repro/kernels/flash_attention/kernel.py``) and its oracle
``attention_ref``: softmax attention with causal and sliding-window masks,
an optional soft-cap (``softcap · tanh(s / softcap)`` on the scaled scores,
before the mask, as the reference's ``_sdpa``) and GQA head grouping
(H = K·G, no copy of K or V), written as the full (S × T) score matrix.
Query row i sits at key position i + (T − S). A row with no live key gives
zeros. f32 math, returned in q's dtype. For a V that is not f32 (bf16),
the unnormalised P = exp(s − max) is rounded to V's dtype before P·V and
the normaliser is summed from the unrounded P, as the Pallas kernel does
(``p.astype(vb.dtype)``, its ``l``); for f32 inputs the softmax is taken
as before.

This is the CPU path of
:func:`repro_torch.kernels.flash_attention.flash_attention` and the oracle of
the CUDA kernel (``csrc/flash_attention.cu``) on the card.
``flash_attention_lse_ref`` is the row log-sum-exp the f32 kernel saves for
its backward, and ``flash_attention_bwd_ref`` the gradients that autograd
takes of ``flash_attention_ref``: the CPU path and the oracle of the
backward kernel (``csrc/flash_attention_bwd.cu``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _masked_scores(q, k, causal, window, softcap):
    """The scaled, soft-capped scores (b, k, g, s, t), f32, -inf where the
    mask kills them."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, S, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg,
                          k.to(torch.float32)) / math.sqrt(hd)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return scores.masked_fill(~ok, float("-inf"))


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """q (B, S, H, hd); k/v (B, T, K, hd) with H = K·G. → (B, S, H, hd)."""
    B, S, H, hd = q.shape
    f32 = torch.float32
    scores = _masked_scores(q, k, causal, window, softcap)
    if v.dtype == f32:
        p = torch.softmax(scores, dim=-1)
        p = torch.nan_to_num(p, nan=0.0)             # rows with no live key
        out = torch.einsum("bkgst,btkh->bskgh", p, v.to(f32))
    else:
        m = scores.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(scores - m)                    # 0 where masked
        l = p.sum(dim=-1).clamp_min(1e-30)           # (b, k, g, s)
        out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).to(f32),
                           v.to(f32))
        out = out / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """Each query row's natural log-sum-exp of its scaled (soft-capped) live
    scores, (B, H, S) f32; +inf for a row with no live key (its P = 0)."""
    B, S, H, _ = q.shape
    lse = torch.logsumexp(_masked_scores(q, k, causal, window, softcap),
                          dim=-1)                       # (b, k, g, s)
    lse = torch.where(torch.isfinite(lse), lse,
                      torch.full_like(lse, float("inf")))
    return lse.reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, dout, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """(dq, dk, dv): autograd's gradients of ``flash_attention_ref`` at
    (q, k, v) for the output gradient ``dout``."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
        return torch.autograd.grad(out, (q, k, v), dout)
