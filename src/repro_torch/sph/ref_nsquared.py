"""O(N²) brute-force SPH oracle (port of ``repro.sph.ref_nsquared``).

Direct evaluation of eqs. (2)–(4) over all particle pairs with periodic
minimum-image distances: the ground truth the cell/task engine and the
Hopper pair kernels are checked against. Every pair of particles is one
element of an (N, N) array, so it fits a test's or a check's size (4,096
particles make 201 MB of (N, N, 3) float32 offsets), not a simulation's.

The physics is the port's own (``physics``, ``smoothing``), and every root
goes through ``physics.sqrt_rn``, so CPU and CUDA tensors round alike. The
functions take numpy arrays or tensors and compute on ``device``: the CUDA
device by default, the CPU when asked (``device="cpu"``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import DeviceLike, resolve_device
from .physics import EPS, GAMMA, eos_pressure, sound_speed, sqrt_rn
from .smoothing import get_kernel


def _as_f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _min_image(dx, box: float):
    return dx - box * torch.round(dx / box)


def _offsets(pos, box: float):
    """(N, N, 3) minimum-image offsets x_i − x_j and (N, N) |·|²."""
    dx = _min_image(pos[:, None, :] - pos[None, :, :], box)
    return dx, torch.sum(dx * dx, dim=-1)


def nsq_density(pos, mass, h, box, *, kernel: str = "cubic",
                device: DeviceLike = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rho, drho_dh, nngb for all particles, O(N²)."""
    dev = resolve_device(device)
    pos, mass, h = (_as_f32(a, dev) for a in (pos, mass, h))
    box = float(box)
    w_fn, dwdr_fn = get_kernel(kernel)
    _, r2 = _offsets(pos, box)
    r = sqrt_rn(r2 + EPS)
    hi = h[:, None]
    w = w_fn(r, hi)
    rho = torch.sum(mass[None, :] * w, dim=1)
    dwdh = -(3.0 * w + r * dwdr_fn(r, hi)) / hi
    drho_dh = torch.sum(mass[None, :] * dwdh, dim=1)
    nngb = torch.sum(w > 0.0, dim=1).to(pos.dtype)
    return rho, drho_dh, nngb


def nsq_forces(pos, vel, mass, u, h, rho, omega, box, *,
               kernel: str = "cubic", alpha_visc: float = 0.0,
               gamma: float = GAMMA, device: DeviceLike = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dv/dt and du/dt for all particles, O(N²) (eqs. 3, 4)."""
    dev = resolve_device(device)
    pos, vel, mass, u, h, rho, omega = (
        _as_f32(a, dev) for a in (pos, vel, mass, u, h, rho, omega))
    box = float(box)
    _w_fn, dwdr_fn = get_kernel(kernel)
    press = eos_pressure(rho, u, gamma)
    cs = sound_speed(rho, u, gamma)
    dx, r2 = _offsets(pos, box)
    r = sqrt_rn(r2 + EPS)
    rhat = dx / r[:, :, None]
    hi, hj = h[:, None], h[None, :]
    dwi = dwdr_fn(r, hi)
    dwj = dwdr_fn(r, hj)
    a = press / (omega * rho ** 2)
    fmag = a[:, None] * dwi + a[None, :] * dwj

    valid = (r < torch.maximum(hi, hj)) & (r2 > EPS)
    zero = torch.zeros((), dtype=pos.dtype, device=dev)

    dvel = vel[:, None, :] - vel[None, :, :]
    du_visc = torch.zeros_like(rho)
    if alpha_visc > 0.0:
        vdotr = torch.sum(dvel * dx, dim=-1)
        hbar = 0.5 * (hi + hj)
        rhobar = 0.5 * (rho[:, None] + rho[None, :])
        csbar = 0.5 * (cs[:, None] + cs[None, :])
        mu = hbar * vdotr / (r2 + 0.01 * hbar * hbar)
        mu = torch.where(vdotr < 0.0, mu, zero)
        piij = (-alpha_visc * csbar * mu
                + 2.0 * alpha_visc * mu * mu) / rhobar
        dwbar = 0.5 * (dwi + dwj)
        fmag = fmag + piij * dwbar
        du_visc = 0.5 * torch.sum(
            torch.where(valid, mass[None, :] * piij * dwbar * (vdotr / r),
                        zero), dim=1)

    fmag = torch.where(valid, fmag, zero)
    mj = mass[None, :] * valid
    dv = -torch.sum((mj * fmag)[:, :, None] * rhat, dim=1)

    vdotrhat = torch.sum(dvel * rhat, dim=-1)
    valid_u = (r < hi) & (r2 > EPS)
    du = a * torch.sum(torch.where(valid_u, mass[None, :] * vdotrhat * dwi,
                                   zero), dim=1)
    return dv, du + du_visc
