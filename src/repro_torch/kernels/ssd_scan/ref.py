"""Plain PyTorch version of the fused SSD (Mamba-2) scan.

The same function as the reference's Pallas ``ssd_scan``
(``repro/kernels/ssd_scan/kernel.py``) and its oracle ``ssd_scan_ref``: the
scalar-decay-per-head SSM

    h_t = exp(Δ_t·A_h) · h_{t−1} + Δ_t · B_t ⊗ u_t
    y_t = C_t · h_t + D_h · u_t

computed in the chunked matmul form that the reference model's SSD core
uses (``repro/models/mamba.py:273-336``): within a chunk of Q steps the
(Q×Q) decay-masked products, across chunks a short recurrence of the
(N, hp) state. S is padded with zeros up to a multiple of Q; zero Δ makes
the padded steps inert, so the final state is unchanged. f32 math; y is
returned in u's dtype (bf16 for bf16 u, as the Pallas kernel returns it),
the state in f32.

This is the CPU path of :func:`repro_torch.kernels.ssd_scan.ssd_scan` and the
oracle of the CUDA kernel (``csrc/ssd_scan.cu``) on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ssd_scan_ref(u, dt, A, Bm, Cm, D, *, chunk: int = 64,
                 h0: Optional[torch.Tensor] = None):
    """u (B, S, H, hp); dt (B, S, H); A/D (H,); Bm/Cm (B, S, N);
    h0 (B, H, N, hp) or None (zeros).

    Returns (y (B, S, H, hp) in u's dtype, h_final (B, H, N, hp) f32).
    """
    out_dtype = u.dtype
    B_, S, H, hp = u.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    u, dt, Bm, Cm = u.to(f32), dt.to(f32), Bm.to(f32), Cm.to(f32)
    A, D = A.to(f32), D.to(f32)
    la = dt * A[None, None, :]                               # (B,S,H)

    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        uh2 = F.pad(u, (0, 0, 0, 0, 0, pad))
        Bm2, Cm2 = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
        la2, dt2 = F.pad(la, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    else:
        uh2, Bm2, Cm2, la2, dt2 = u, Bm, Cm, la, dt
    T = uh2.shape[1] // Q

    def tochunks(a):
        return a.reshape((B_, T, Q) + tuple(a.shape[2:]))

    uc, bc, cc, lc, dc = map(tochunks, (uh2, Bm2, Cm2, la2, dt2))
    Lc = torch.cumsum(lc, dim=2)                             # (B,T,Q,H)

    # intra-chunk: y[t] = Σ_{s≤t} C_t·B_s exp(L_t−L_s) Δ_s u_s
    # (masked in log space: exp(L_t−L_s) overflows for t<s before masking)
    cb = torch.einsum("btqn,btsn->btqs", cc, bc)             # (B,T,Q,Q)
    diff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]       # (B,T,Q,Q,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                  float("-inf")))
    M = cb[..., None] * decay
    y_intra = torch.einsum("btqsh,btsh,btshp->btqhp", M, dc, uc)

    # chunk states: S_c = Σ_s exp(L_Q − L_s) Δ_s B_s ⊗ u_s
    dec_end = torch.exp(Lc[:, :, -1:, :] - Lc)               # (B,T,Q,H)
    Sc = torch.einsum("btsh,btsh,btsn,btshp->bthnp", dec_end, dc, bc, uc)

    # inter-chunk recurrence over the T chunks
    chunk_decay = torch.exp(Lc[:, :, -1, :])                 # (B,T,H)
    h = (torch.zeros((B_, H, N, hp), dtype=f32, device=u.device)
         if h0 is None else h0.to(f32))
    h_in = []
    for t in range(T):
        h_in.append(h)
        h = h * chunk_decay[:, t, :, None, None] + Sc[:, t]
    h_in = torch.stack(h_in, dim=1)                          # (B,T,H,N,hp)

    # inter-chunk contribution: C_t exp(L_t) h_in
    y_inter = torch.einsum("btqn,btqh,bthnp->btqhp", cc, torch.exp(Lc), h_in)
    y = (y_intra + y_inter).reshape(B_, T * Q, H, hp)[:, :S]
    y = y + u * D[None, None, :, None]
    return y.to(out_dtype), h
