"""SPH pair physics: density (eq. 2), forces (eq. 3), energy (eq. 4).

Port of ``repro.sph.physics``. The block functions take a receiver block
``i`` (…, Ci, ·) and a source block ``j`` (…, Cj, ·); any leading batch
dimensions broadcast, which stands in for the reference's ``vmap``.

Distances keep the reference's dot form |xi−xj|² = |xi|² + |xj|² − 2·xi·xj,
with the three-term sums written out in a fixed order (no BLAS call, whose
FMA use and blocking would round differently from the CUDA kernels).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .smoothing import get_kernel

GAMMA = 5.0 / 3.0      # adiabatic index (monatomic ideal gas)
EPS = 1e-12


def sqrt_rn(x):
    """Correctly rounded square root of a float32 tensor.

    PyTorch's CPU float32 sqrt (SLEEF, ≤ 0.5001 ulp) misrounds ~0.7 % of
    inputs; XLA, numpy and the CUDA kernels round correctly. The root is
    taken in float64 and rounded once to float32, which is correctly
    rounded (53 ≥ 2·24 + 2 bits), so CPU and CUDA tensors give the
    reference's bits.
    """
    return torch.sqrt(x.double()).to(x.dtype)


def eos_pressure(rho, u, gamma: float = GAMMA):
    """P = (γ−1)·ρ·u."""
    return (gamma - 1.0) * rho * u


def sound_speed(rho, u, gamma: float = GAMMA):
    """c = sqrt(γ·P/ρ) = sqrt(γ(γ−1)u)."""
    return sqrt_rn(torch.clamp_min(gamma * (gamma - 1.0) * u, 0.0))


def dot3(a, b):
    """Σ_k a_k·b_k over a trailing axis of 3, as ((a0b0 + a1b1) + a2b2)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def pairwise_r2(pos_i, pos_j):
    """(…, Ci, Cj) squared distances via the dot form."""
    sq_i = dot3(pos_i, pos_i)                             # (…, Ci)
    sq_j = dot3(pos_j, pos_j)                             # (…, Cj)
    cross = dot3(pos_i[..., :, None, :], pos_j[..., None, :, :])
    r2 = sq_i[..., :, None] + sq_j[..., None, :] - 2.0 * cross
    return torch.clamp_min(r2, 0.0)


class DensityResult(NamedTuple):
    rho: torch.Tensor        # (…, Ci) Σ m_j W(r, h_i)
    drho_dh: torch.Tensor    # (…, Ci) Σ m_j ∂W/∂h(r, h_i)
    nngb: torch.Tensor       # (…, Ci) neighbour count (for h iteration)


def density_block(pos_i, h_i, pos_j, m_j, mask_j, *,
                  kernel: str = "cubic") -> DensityResult:
    """Density contributions of source block j onto receiver block i (eq. 2).

    Includes the self term when the blocks alias (W(0, h) is finite).
    ``mask_j`` zeroes padded slots.
    """
    w_fn, dwdr_fn = get_kernel(kernel)
    r2 = pairwise_r2(pos_i, pos_j)
    r = sqrt_rn(r2 + EPS)
    h = h_i[..., :, None]
    w = w_fn(r, h)
    mj = (m_j * mask_j)[..., None, :]
    rho = (mj * w).sum(-1)
    dwdh = -(3.0 * w + r * dwdr_fn(r, h)) / h
    drho_dh = (mj * dwdh).sum(-1)
    nngb = ((w > 0.0) * mask_j[..., None, :]).sum(-1)
    return DensityResult(rho, drho_dh, nngb)


class ForceResult(NamedTuple):
    dv: torch.Tensor      # (…, Ci, 3) acceleration contribution
    du: torch.Tensor      # (…, Ci)  du/dt contribution


def force_block(pos_i, vel_i, h_i, P_i, rho_i, omega_i, cs_i,
                pos_j, vel_j, h_j, P_j, rho_j, omega_j, cs_j,
                m_j, mask_j, *, kernel: str = "cubic",
                alpha_visc: float = 0.0) -> ForceResult:
    """Force and energy contributions of block j onto block i (eqs. 3, 4).

    The pair predicate is r < max(h_i, h_j) for the momentum equation and
    r < h_i for the energy equation, exactly as in the paper.
    """
    _w_fn, dwdr_fn = get_kernel(kernel)
    r2 = pairwise_r2(pos_i, pos_j)
    r = sqrt_rn(r2 + EPS)
    dx = pos_i[..., :, None, :] - pos_j[..., None, :, :]   # (…, Ci, Cj, 3)
    rhat = dx / r[..., None]

    hi = h_i[..., :, None]
    hj = h_j[..., None, :]
    dwi = dwdr_fn(r, hi)
    dwj = dwdr_fn(r, hj)

    ai = (P_i / (omega_i * (rho_i * rho_i)))[..., :, None]
    aj = (P_j / (omega_j * (rho_j * rho_j)))[..., None, :]
    fmag = ai * dwi + aj * dwj

    valid = mask_j[..., None, :] * (r < torch.maximum(hi, hj)) * (r2 > EPS)

    du_visc = torch.zeros_like(h_i)
    if alpha_visc > 0.0:
        dvel = vel_i[..., :, None, :] - vel_j[..., None, :, :]
        vdotr = dot3(dvel, dx)
        hbar = 0.5 * (hi + hj)
        rhobar = 0.5 * (rho_i[..., :, None] + rho_j[..., None, :])
        csbar = 0.5 * (cs_i[..., :, None] + cs_j[..., None, :])
        mu = hbar * vdotr / (r2 + 0.01 * hbar * hbar)
        mu = torch.where(vdotr < 0.0, mu, 0.0)
        beta = 2.0 * alpha_visc
        piij = (-alpha_visc * csbar * mu + beta * mu * mu) / rhobar
        dwbar = 0.5 * (dwi + dwj)
        fmag = fmag + piij * dwbar
        mvisc = m_j[..., None, :] * valid
        du_visc = 0.5 * (mvisc * piij * dwbar * (vdotr / r)).sum(-1)

    mj = m_j[..., None, :] * valid
    fmag = torch.where(valid > 0, fmag, 0.0)   # padded slots may be non-finite
    dv = -((mj * fmag)[..., None] * rhat).sum(-2)          # (…, Ci, 3)

    dvel = vel_i[..., :, None, :] - vel_j[..., None, :, :]
    vdotrhat = dot3(dvel, rhat)
    valid_u = mask_j[..., None, :] * (r < hi) * (r2 > EPS)
    du = (P_i / (omega_i * (rho_i * rho_i))) * (
        m_j[..., None, :] * valid_u * vdotrhat * dwi).sum(-1)
    return ForceResult(dv, du + du_visc)


def cfl_timestep_block(h, u, vel, mask, *, gamma: float = GAMMA,
                       cfl: float = 0.25):
    """Per-particle CFL time-step: dt_i = C_CFL · h_i / (c_i + |v_i|).

    Padded slots get +inf so reductions and bin assignment ignore them.
    |v| is summed in the fixed order sqrt((v0² + v1²) + v2²).
    """
    cs = sound_speed(torch.ones_like(u), u, gamma)
    speed = sqrt_rn(dot3(vel, vel)) + cs
    dt = cfl * h / torch.clamp_min(speed, EPS)
    return torch.where(mask > 0, dt, torch.inf)


def ghost_update(rho, drho_dh, u, h, *, gamma: float = GAMMA
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 'ghost' task: pressure, Ω = 1 + h/(3ρ)·∂ρ/∂h and sound speed
    once every density contribution of a cell has been accumulated."""
    rho_safe = torch.clamp_min(rho, EPS)
    omega = 1.0 + (h / (3.0 * rho_safe)) * drho_dh
    omega = torch.where(torch.abs(omega) < 1e-4, 1.0, omega)
    press = eos_pressure(rho_safe, u, gamma)
    cs = sound_speed(rho_safe, u, gamma)
    return press, omega, cs


def smoothing_length_update(h, rho, m, nngb, *, n_target: float = 48.0,
                            eta: float = 0.5, h_min: float = 1e-6,
                            h_max: float | None = None):
    """One damped fixed-point update of h towards ~constant neighbour
    number."""
    ratio = (torch.full_like(nngb, n_target)
             / torch.clamp_min(nngb, 1.0)) ** (1.0 / 3.0)
    h_new = h * (1.0 - eta + eta * ratio)
    if h_max is not None:
        h_new = torch.clamp_max(h_new, h_max)
    return torch.clamp_min(h_new, h_min)
