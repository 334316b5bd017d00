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


def ssd_scan_bwd_ref(u, dt, A, Bm, Cm, D, dy, *, chunk: int = 64,
                     h0: Optional[torch.Tensor] = None,
                     dh: Optional[torch.Tensor] = None):
    """The gradients of :func:`ssd_scan_ref`'s outputs in the chunked form:
    the plain version of the backward kernel (``csrc/ssd_scan_bwd.cu``),
    which computes the same terms chunk by chunk.

    u (B, S, H, hp); dt (B, S, H); A/D (H,); Bm/Cm (B, S, N); h0
    (B, H, N, hp) or None; dy (B, S, H, hp), the gradient of y; dh
    (B, H, N, hp) or None, the gradient of the final state. With the
    within-chunk cumulative log-decay L (la = dt·A, L_t = Σ_{i≤t} la_i, L_Q
    the chunk's last), W_ts = exp(L_t − L_s) for s ≤ t, M = (C Bᵀ) ∘ W ∘
    dt_s:

    * the state entering each chunk (H_in) again by the forward's recurrence,
      then the adjoint of the state leaving each chunk (dH_out), carried
      from the last chunk to the first: dH_in = exp(L_Q) dH_out + Σ_t
      exp(L_t) C_t ⊗ dy_t, the gradient of h0 the first chunk's dH_in;
    * inside a chunk, the gradients of M·u (du = Mᵀ dy), of C·Bᵀ (summed over
      heads: dC = G Bᵀ, dB = Gᵀ C with G = (dy uᵀ) ∘ W ∘ dt_s), of the
      inter-chunk term exp(L_t) C_t·H_in and of the chunk's state
      contribution Σ_s exp(L_Q − L_s) dt_s B_s ⊗ u_s;
    * the gradient of each L_t gathered from every exponent it enters
      (always as a difference of L, never a lone exp(−L): exp(L_t − L_s)
      overflows for t < s), then carried to la by a reverse cumulative sum
      within the chunk: ddt += A·dla, dA = Σ dt·dla over (b, s);
    * dD = Σ dy·u over (b, s, p).

    u, B, C and dy may be bf16 (the bf16 entry's backward: dy is y's
    gradient, and y is bf16): the terms are computed in f32 from their
    values all the same, and du, dB and dC are rounded once to their
    inputs' dtype at the end.

    Returns (du, ddt, dA, dB, dC, dD, dh0 or None: None unless h0 is
    given): du, dB and dC in u's, B's and C's dtype, the rest f32.
    """
    B_, S, H, hp = u.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    du_dtype, dB_dtype, dC_dtype = u.dtype, Bm.dtype, Cm.dtype
    u, dt, Bm, Cm, dy = (t.to(f32) for t in (u, dt, Bm, Cm, dy))
    A, D = A.to(f32), D.to(f32)
    la = dt * A[None, None, :]

    Q = min(chunk, S)
    pad = (-S) % Q
    T = (S + pad) // Q

    def tochunks(a):
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape((B_, T, Q) + tuple(a.shape[2:]))

    uc, bc, cc, lc, dc, dyc = map(tochunks, (u, Bm, Cm, la, dt, dy))
    Lc = torch.cumsum(lc, dim=2)                             # (B,T,Q,H)
    Lend = Lc[:, :, -1, :]                                   # (B,T,H)
    expL = torch.exp(Lc)
    dec_end = torch.exp(Lend[:, :, None, :] - Lc)            # exp(L_Q − L_s)
    w_end = dec_end * dc

    # the states entering each chunk, as the forward computes them
    Sc = torch.einsum("btsh,btsn,btshp->bthnp", w_end, bc, uc)
    h = (torch.zeros((B_, H, N, hp), dtype=f32, device=u.device)
         if h0 is None else h0.to(f32))
    h_in = []
    for t in range(T):
        h_in.append(h)
        h = h * torch.exp(Lend[:, t, :, None, None]) + Sc[:, t]
    h_in = torch.stack(h_in, dim=1)                          # (B,T,H,N,hp)

    # the adjoint of the state leaving each chunk, last chunk first
    Gc = torch.einsum("btqn,btqh,btqhp->bthnp", cc, expL, dyc)
    g = (torch.zeros((B_, H, N, hp), dtype=f32, device=u.device)
         if dh is None else dh.to(f32))
    dh_out = [None] * T
    for t in reversed(range(T)):
        dh_out[t] = g
        g = g * torch.exp(Lend[:, t, :, None, None]) + Gc[:, t]
    dh_out = torch.stack(dh_out, dim=1)                      # (B,T,H,N,hp)

    # intra-chunk: y_t = Σ_{s≤t} (C_t·B_s) W_ts dt_s u_s
    cb = torch.einsum("btqn,btsn->btqs", cc, bc)             # (B,T,Q,Q)
    diff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]       # (B,T,Q,Q,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    W = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                              float("-inf")))
    dyu = torch.einsum("btqhp,btshp->btqsh", dyc, uc)        # dM
    dts = dc[:, :, None, :, :]                               # dt_s
    M = cb[..., None] * W * dts
    Gm = dyu * W * dts                                       # dM ∘ ∂M/∂(C·Bᵀ)
    Y = dyu * cb[..., None] * W                              # dM ∘ M / dt_s
    du = torch.einsum("btqsh,btqhp->btshp", M, dyc)
    dC = torch.einsum("btqsh,btsn->btqn", Gm, bc)
    dB = torch.einsum("btqsh,btqn->btsn", Gm, cc)
    colY = Y.sum(2)                                          # over t, (B,T,Q,H)
    ddt = colY
    dL = (Y * dts).sum(3) - dc * colY

    # inter-chunk: y_t += exp(L_t) C_t·H_in
    V = torch.einsum("bthnp,btqhp->btqhn", h_in, dyc)
    dC = dC + torch.einsum("btqh,btqhn->btqn", expL, V)
    dL = dL + expL * torch.einsum("btqn,btqhn->btqh", cc, V)

    # the chunk's state: H_out = exp(L_Q) H_in + Σ_s exp(L_Q − L_s) dt_s B_s⊗u_s
    R = torch.einsum("bthnp,btshp->btshn", dh_out, uc)
    dB = dB + torch.einsum("btsh,btshn->btsn", w_end, R)
    du = du + w_end[..., None] * torch.einsum("bthnp,btsn->btshp", dh_out, bc)
    z = dec_end * torch.einsum("btsn,btshn->btsh", bc, R)
    ddt = ddt + z
    dL = dL - dc * z
    end = (dc * z).sum(2) + torch.exp(Lend) * (dh_out * h_in).sum((-1, -2))
    dL = torch.cat([dL[:, :, :-1], dL[:, :, -1:] + end[:, :, None]], dim=2)

    # L = cumsum(la) within the chunk: dla is the reverse cumulative sum
    dla = torch.flip(torch.cumsum(torch.flip(dL, (2,)), 2), (2,))
    ddt = ddt + A * dla
    dA = (dc * dla).sum((0, 1, 2))

    def unchunk(a):
        return a.reshape((B_, T * Q) + tuple(a.shape[3:]))[:, :S]

    du = unchunk(du) + D[None, None, :, None] * dy
    dD = (dy * u).sum((0, 1, 3))
    return (du.to(du_dtype), unchunk(ddt), dA, unchunk(dB).to(dB_dtype),
            unchunk(dC).to(dC_dtype), dD, None if h0 is None else g)
