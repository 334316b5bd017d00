"""Plain PyTorch version of the selective scan (Mamba-1).

The same function as the reference's Pallas ``selective_scan``
(``repro/kernels/mamba_scan/kernel.py``) and its oracle
``selective_scan_ref``: Mamba-1's diagonal-A recurrence

    h_t = exp(Δ_t ⊙ A) ⊙ h_{t−1} + (Δ_t u_t) ⊗ B_t
    y_t = ⟨h_t, C_t⟩ + D ⊙ u_t

walked sequentially over time at the (B, d_inner, d_state) level, all in
f32; y is returned in u's dtype (bf16 for bf16 u, as the Pallas kernel
returns it), the state in f32. This is the CPU path of :func:`repro_torch.kernels.mamba_scan.
selective_scan` and the oracle of the CUDA kernel
(``csrc/selective_scan.cu``) on the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def selective_scan_ref(u, dt, A, Bm, Cm, D, *,
                       h0: Optional[torch.Tensor] = None):
    """u/dt (B, S, dI); A (dI, N); Bm/Cm (B, S, N); D (dI,);
    h0 (B, dI, N) or None (zeros).

    Returns (y (B, S, dI) in u's dtype, h_final (B, dI, N) f32). All math
    in f32.
    """
    out_dtype = u.dtype
    B_, S, dI = u.shape
    N = A.shape[1]
    f32 = torch.float32
    u, dt, Bm, Cm = u.to(f32), dt.to(f32), Bm.to(f32), Cm.to(f32)
    A, D = A.to(f32), D.to(f32)
    h = (torch.zeros((B_, dI, N), dtype=f32, device=u.device)
         if h0 is None else h0.to(f32))
    y = torch.empty((B_, S, dI), dtype=f32, device=u.device)
    for t in range(S):
        dtt = dt[:, t]                                       # (B, dI)
        dA = torch.exp(dtt[:, :, None] * A[None])            # (B, dI, N)
        h = dA * h + (dtt * u[:, t])[:, :, None] * Bm[:, t, None, :]
        y[:, t] = (h * Cm[:, t, None, :]).sum(-1)
    return (y + u * D[None, None, :]).to(out_dtype), h
