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


def selective_scan_bwd_ref(u, dt, A, Bm, Cm, D, dy, *,
                           h0: Optional[torch.Tensor] = None,
                           dh: Optional[torch.Tensor] = None,
                           chunk: int = 8):
    """The gradients of :func:`selective_scan_ref`'s outputs, by an explicit
    reverse scan: the plain version of the backward kernel
    (``csrc/selective_scan_bwd.cu``), which walks time the same way.

    u/dt (B, S, dI); A (dI, N); Bm/Cm (B, S, N); D (dI,); h0 (B, dI, N) or
    None; dy (B, S, dI), the gradient of y; dh (B, dI, N) or None, the
    gradient of the final state. A forward sweep keeps the state entering
    each chunk of ``chunk`` steps; the chunks are then walked last to first,
    each chunk's states recomputed from its boundary state, while the
    adjoint of the state

        g_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1},   g_{S-1} = C dy + dh

    is carried back:

        du_t  = dt_t Σ_n g_t B_t + D dy_t
        ddt_t = Σ_n g_t (A exp(dt_t A) h_{t-1} + u_t B_t)
        dA    = Σ_{b,t} g_t dt_t exp(dt_t A) h_{t-1}
        dB_t  = Σ_d g_t dt_t u_t,   dC_t = Σ_d dy_t h_t,   dD = Σ dy u
        dh0   = exp(dt_0 A) g_0.

    Returns (du, ddt, dA, dB, dC, dD, dh0 or None: None unless h0 is
    given), all f32. All math in f32.
    """
    B_, S, dI = u.shape
    N = A.shape[1]
    f32 = torch.float32
    u, dt, Bm, Cm, dy = (t.to(f32) for t in (u, dt, Bm, Cm, dy))
    A, D = A.to(f32), D.to(f32)
    h = (torch.zeros((B_, dI, N), dtype=f32, device=u.device)
         if h0 is None else h0.to(f32))

    def step(h, t):
        return (torch.exp(dt[:, t, :, None] * A[None]) * h
                + (dt[:, t] * u[:, t])[:, :, None] * Bm[:, t, None, :])

    starts = []                                   # the state entering each chunk
    for t in range(S):
        if t % chunk == 0:
            starts.append(h)
        h = step(h, t)
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    # gc = exp(dt_{t+1} A) g_{t+1}, the adjoint carried into step t
    gc = (torch.zeros((B_, dI, N), dtype=f32, device=u.device)
          if dh is None else dh.to(f32))
    for k in reversed(range(len(starts))):
        t0 = k * chunk
        hs = [starts[k]]                          # h_{t-1}, then h_t, ...
        for t in range(t0, min(S, t0 + chunk)):
            hs.append(step(hs[-1], t))
        for t in reversed(range(t0, min(S, t0 + chunk))):
            h_prev, h_t = hs[t - t0], hs[t - t0 + 1]
            a = torch.exp(dt[:, t, :, None] * A[None])         # (B, dI, N)
            g = gc + dy[:, t, :, None] * Cm[:, t, None, :]
            du[:, t] = dt[:, t] * (g * Bm[:, t, None, :]).sum(-1) \
                + D * dy[:, t]
            ddt[:, t] = (g * (A[None] * a * h_prev
                              + u[:, t, :, None] * Bm[:, t, None, :])).sum(-1)
            dA += (g * dt[:, t, :, None] * a * h_prev).sum(0)
            dB[:, t] = (g * (dt[:, t] * u[:, t])[:, :, None]).sum(1)
            dC[:, t] = (dy[:, t, :, None] * h_t).sum(1)
            gc = a * g
    dD = (dy * u).sum((0, 1))
    return du, ddt, dA, dB, dC, dD, (None if h0 is None else gc)
