"""Plain PyTorch versions of the two sph_pair kernels.

Each computes what the reference's Pallas body computes
(``repro/kernels/sph_pair/kernel.py``): one (C × C) distance matrix per
pair in dot form, both directions of the pair from it (row reductions give
the i-side, column reductions the j-side), and the momentum contracted in
double-float (``_df_weighted_contract``: TwoProd, TwoSum, one rounding at
the end), so each pair's momentum exchange is antisymmetric to the f32
output-rounding floor.

Every reduction runs over the pair's slots in ascending index order, the
order the CUDA kernels use, and nothing here is contracted into an FMA, so
on the same inputs this version and the kernels round at the same places.

Pairs are processed in chunks: a (P, C, C, 3) temporary at the full Sedov
64³ size (P = 307,328, C = 40) would be 5.9 GB, and several are live at
once.

The wrappers in ``kernel.py`` call these for tensors on the CPU; the CUDA
check in ``chip_smoke.py`` holds the kernels against them on the card, bit
for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...sph.physics import EPS, dot3, pairwise_r2, sqrt_rn
from ...sph.smoothing import get_kernel

# elements of one (pairs, C, C) temporary per chunk: 16 MiB in f32
CHUNK_ELEMS = 1 << 22


def _chunks(P: int, C: int):
    step = max(CHUNK_ELEMS // max(C * C, 1), 1)
    for a in range(0, P, step):
        yield slice(a, min(a + step, P))


def _sum_asc(x, dim: int):
    """Σ over ``dim`` in ascending index order, starting from +0."""
    x = x.movedim(dim, 0)
    acc = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc


def two_sum(a, b):
    """Error-free f32 addition: (fl(a+b), rounding error)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def two_prod(a, b):
    """Error-free f32 product via Dekker splitting (each op rounded
    separately, as eager PyTorch does)."""
    p = a * b
    split = 4097.0          # 2**12 + 1 for float32 (24-bit significand)
    ca = split * a
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = split * b
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def df_weighted_contract(w, g, rhat, dim: int):
    """Σ_dim w·g·r̂ in double-float, rounded once at the end.

    ``g`` is (…, C, C), ``w`` broadcasts against it, ``rhat`` is
    (…, C, C, 3); ``dim`` is −1 (reduce over j) or −2 (over i).
    """
    p1, e1 = two_prod(torch.broadcast_to(w, g.shape), g)
    p2, e2 = two_prod(p1[..., None], rhat)
    lo = e2 + e1[..., None] * rhat
    hi = p2.movedim(dim - 1, 0)
    lo = lo.movedim(dim - 1, 0)
    s_hi = torch.zeros_like(hi[0])
    s_lo = torch.zeros_like(lo[0])
    for k in range(hi.shape[0]):
        s, e = two_sum(s_hi, hi[k])
        e = e + (s_lo + lo[k])
        s2 = s + e
        s_lo = e - (s2 - s)
        s_hi = s2
    return s_hi + s_lo


def _r(xi, xj):
    r2 = pairwise_r2(xi, xj)
    return r2, sqrt_rn(r2 + EPS)


def _density_chunk(pos_i, h_i, m_i, mask_i, pos_j, h_j, m_j, mask_j,
                   kernel):
    w_fn, dwdr_fn = get_kernel(kernel)
    _r2, r = _r(pos_i, pos_j)
    hi = h_i[:, :, None]
    hj = h_j[:, None, :]

    # i <- j (rows reduce over j)
    wi = w_fn(r, hi)
    mj = (m_j * mask_j)[:, None, :]
    rho_i = _sum_asc(mj * wi, -1)
    dwdh_i = -(3.0 * wi + r * dwdr_fn(r, hi)) / hi
    drho_i = _sum_asc(mj * dwdh_i, -1)
    nngb_i = _sum_asc((wi > 0.0) * mask_j[:, None, :], -1)

    # j <- i (columns reduce over i) — same r matrix, h_j kernel
    wj = w_fn(r, hj)
    mi = (m_i * mask_i)[:, :, None]
    rho_j = _sum_asc(mi * wj, -2)
    dwdh_j = -(3.0 * wj + r * dwdr_fn(r, hj)) / hj
    drho_j = _sum_asc(mi * dwdh_j, -2)
    nngb_j = _sum_asc((wj > 0.0) * mask_i[:, :, None], -2)
    return rho_i, drho_i, nngb_i, rho_j, drho_j, nngb_j


def density_pair_ref(pos_i, h_i, m_i, mask_i, pos_j, h_j, m_j, mask_j,
                     *, kernel: str = "cubic") -> Tuple[torch.Tensor, ...]:
    """Both directions of the density interaction for batched pairs.

    pos (P, C, 3) with pos_j already image-shifted; h/m/mask (P, C).
    Returns (rho_i, drho_i, nngb_i, rho_j, drho_j, nngb_j), each (P, C).
    """
    P, C, _ = pos_i.shape
    outs = [torch.empty((P, C), dtype=pos_i.dtype, device=pos_i.device)
            for _ in range(6)]
    args = (pos_i, h_i, m_i, mask_i, pos_j, h_j, m_j, mask_j)
    for sl in _chunks(P, C):
        res = _density_chunk(*(a[sl] for a in args), kernel)
        for o, v in zip(outs, res):
            o[sl] = v
    return tuple(outs)


def gather_density_blocks(pos, h, mass, mask, ci, cj, shift):
    """The density's eight (P, C[, 3]) blocks from the cell arrays: cells
    ``ci`` on the i-side, cells ``cj`` on the j-side with ``shift`` (P, 3)
    added to their positions (the periodic image)."""
    ci, cj = ci.long(), cj.long()
    gi = lambda a: a.index_select(0, ci)
    gj = lambda a: a.index_select(0, cj)
    return (gi(pos), gi(h), gi(mass), gi(mask),
            gj(pos) + shift[:, None, :], gj(h), gj(mass), gj(mask))


def density_pair_cells_ref(pos, h, mass, mask, ci, cj, shift, *,
                           kernel: str = "cubic") -> Tuple[torch.Tensor, ...]:
    """``density_pair_ref`` on the blocks gathered through ``ci``/``cj``:
    what the fused kernel computes from the cell arrays."""
    return density_pair_ref(
        *gather_density_blocks(pos, h, mass, mask, ci, cj, shift),
        kernel=kernel)


def _force_chunk(pos_i, vel_i, h_i, P_i, rho_i, om_i, cs_i, m_i, mask_i,
                 pos_j, vel_j, h_j, P_j, rho_j, om_j, cs_j, m_j, mask_j,
                 kernel, alpha_visc):
    _w_fn, dwdr_fn = get_kernel(kernel)
    hi = h_i[:, :, None]
    hj = h_j[:, None, :]
    r2, r = _r(pos_i, pos_j)
    dx = pos_i[:, :, None, :] - pos_j[:, None, :, :]
    rhat = dx / r[..., None]

    dwi = dwdr_fn(r, hi)
    dwj = dwdr_fn(r, hj)
    coef_i = P_i / (om_i * (rho_i * rho_i))
    coef_j = P_j / (om_j * (rho_j * rho_j))
    fmag = coef_i[:, :, None] * dwi + coef_j[:, None, :] * dwj

    valid = (mask_i[:, :, None] * mask_j[:, None, :]
             * (r < torch.maximum(hi, hj)) * (r2 > EPS))

    dvel = vel_i[:, :, None, :] - vel_j[:, None, :, :]
    vdotrhat = dot3(dvel, rhat)

    du_visc_i = torch.zeros_like(h_i)
    du_visc_j = torch.zeros_like(h_j)
    if alpha_visc > 0.0:
        vdotr = dot3(dvel, dx)
        hbar = 0.5 * (hi + hj)
        rhobar = 0.5 * (rho_i[:, :, None] + rho_j[:, None, :])
        csbar = 0.5 * (cs_i[:, :, None] + cs_j[:, None, :])
        mu = hbar * vdotr / (r2 + 0.01 * hbar * hbar)
        mu = torch.where(vdotr < 0.0, mu, 0.0)
        beta = 2.0 * alpha_visc
        piij = (-alpha_visc * csbar * mu + beta * mu * mu) / rhobar
        dwbar = 0.5 * (dwi + dwj)
        fmag = fmag + piij * dwbar
        vr = vdotr / r
        mvisc_i = m_j[:, None, :] * valid
        du_visc_i = 0.5 * _sum_asc(mvisc_i * piij * dwbar * vr, -1)
        mvisc_j = m_i[:, :, None] * valid
        du_visc_j = 0.5 * _sum_asc(mvisc_j * piij * dwbar * vr, -2)

    # both directions contract the same g and r̂ (Newton's third law)
    g = torch.where(valid > 0, fmag, 0.0) * valid
    dv_i = -df_weighted_contract(m_j[:, None, :], g, rhat, -1)
    dv_j = df_weighted_contract(m_i[:, :, None], g, rhat, -2)

    # energy eq. (4): per-side cutoff r < h_side
    valid_ui = mask_j[:, None, :] * (r < hi) * (r2 > EPS)
    du_i = coef_i * _sum_asc(
        m_j[:, None, :] * valid_ui * vdotrhat * dwi, -1) + du_visc_i
    valid_uj = mask_i[:, :, None] * (r < hj) * (r2 > EPS)
    du_j = coef_j * _sum_asc(
        m_i[:, :, None] * valid_uj * vdotrhat * dwj, -2) + du_visc_j
    return dv_i, du_i, dv_j, du_j


def force_pair_ref(pos_i, vel_i, h_i, press_i, rho_i, om_i, cs_i, m_i,
                   mask_i, pos_j, vel_j, h_j, press_j, rho_j, om_j, cs_j,
                   m_j, mask_j, *, kernel: str = "cubic",
                   alpha_visc: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Both directions of the force interaction for batched pairs.

    Returns (dv_i, du_i, dv_j, du_j): (P, C, 3), (P, C), (P, C, 3), (P, C).
    """
    P, C, _ = pos_i.shape
    kw = dict(dtype=pos_i.dtype, device=pos_i.device)
    outs = (torch.empty((P, C, 3), **kw), torch.empty((P, C), **kw),
            torch.empty((P, C, 3), **kw), torch.empty((P, C), **kw))
    args = (pos_i, vel_i, h_i, press_i, rho_i, om_i, cs_i, m_i, mask_i,
            pos_j, vel_j, h_j, press_j, rho_j, om_j, cs_j, m_j, mask_j)
    for sl in _chunks(P, C):
        res = _force_chunk(*(a[sl] for a in args), kernel, alpha_visc)
        for o, v in zip(outs, res):
            o[sl] = v
    return outs
