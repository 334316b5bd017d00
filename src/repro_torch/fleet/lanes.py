"""Lanes: same-shape simulations stacked through one launch of each kernel.

The reference serves a batch with ``jax.jit(jax.vmap(step, in_axes=(0,
None, 0)))`` over a new leading fleet axis (``repro/fleet/runner.py``).
The port has no vmap. What it has instead are pair kernels that read the
cell arrays through the pair list's ``ci``/``cj`` and per-cell sums that
follow the list's fixed-order *incoming* table
(``kernels/sph_pair/ops.py``). So B simulations of one shape become one
simulation of B disjoint lanes:

* the cell arrays stack along the cell axis, ``(B·ncells, C, …)``, lane
  ``l`` owning rows ``[l·ncells, (l+1)·ncells)``;
* the pair list repeats per lane with ``ci``/``cj`` offset by
  ``l·ncells`` (:func:`~repro_torch.sph.cellgrid.stack_pair_list`, shared
  with the device-resident distributed engine, whose ranks are lanes), so
  no pair crosses lanes;
* each lane's dt and time are entries of ``(B,)`` vectors, expanded per
  cell where the step multiplies by dt (:func:`lane_step`).

Each step then launches ``density_pair_cells`` and ``force_pair`` once
for the whole batch. Every lane stays bit for bit its single run: a pair's
kernel work does not depend on where it sits in the list, each cell adds
its own lane's contributions in the single run's order with the single
run's table width, and every elementwise expression is the engine's
(``engine.step``), evaluated in the same order on the same operands —
only the broadcast of dt differs.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..sph.cellgrid import (PairList, ParticleCells,  # noqa: F401
                            stack_pair_list)
from ..sph.engine import SPHConfig, SPHState, cfl_timestep_particles, \
    compute_accelerations, periodic_wrap
from ..sph.physics import smoothing_length_update


def stack_cells(lanes: Sequence[ParticleCells], device=None) -> ParticleCells:
    """Lane cell arrays (host or device, one shape) stacked along the cell
    axis into one ``(B·ncells, C, …)`` array per field on ``device``."""
    return ParticleCells(*(torch.cat(list(fields)).to(device)
                           for fields in zip(*lanes)))


def take_lane(cells: ParticleCells, lane: int, ncells: int) -> ParticleCells:
    """Lane ``lane``'s rows of stacked cell arrays (views)."""
    lo = lane * ncells
    return ParticleCells(*(t[lo:lo + ncells] for t in cells))


def lane_init(cells: ParticleCells, pairs: PairList, cfg: SPHConfig,
              time: torch.Tensor) -> SPHState:
    """``engine.init_state`` over stacked lanes: one density and one force
    launch for all of them; ``time`` is the lanes' (B,) float32 times."""
    dv, du, rho, _ = compute_accelerations(cells, pairs, cfg)
    return SPHState(cells=cells, accel=dv, dudt=du, rho=rho, time=time)


def lane_step(state: SPHState, pairs: PairList, dts: torch.Tensor,
              box: float, cfg: SPHConfig) -> SPHState:
    """``engine.step`` over stacked lanes, lane ``l`` with step ``dts[l]``.

    The engine's expressions in the engine's order; each lane's dt is
    expanded per cell, as ``(B·ncells, 1, 1)`` against ``accel``/``vel``
    and ``(B·ncells, 1)`` against ``dudt``/``u``, so every element is
    computed from the same operands as in the 0-d case.
    """
    cells = state.cells
    dt = dts.repeat_interleave(cells.mass.shape[0] // dts.shape[0])
    dt3, dt2 = dt[:, None, None], dt[:, None]
    mask3 = cells.mask[..., None]
    v_half = cells.vel + 0.5 * dt3 * state.accel
    u_half = torch.clamp_min(cells.u + 0.5 * dt2 * state.dudt, 1e-12)
    pos = periodic_wrap(cells.pos + dt3 * v_half * mask3, box)
    cells = cells._replace(pos=pos, vel=v_half, u=u_half)
    dv, du, rho, nngb = compute_accelerations(cells, pairs, cfg)
    v_new = cells.vel + 0.5 * dt3 * dv
    u_new = torch.clamp_min(u_half + 0.5 * dt2 * du, 1e-12)
    h_new = cells.h
    if cfg.adapt_h:
        h_new = smoothing_length_update(cells.h, rho, cells.mass, nngb,
                                        n_target=cfg.n_target)
        h_new = torch.where(cells.mask > 0, h_new, cells.h)
    cells = cells._replace(vel=v_new, u=u_new, h=h_new)
    return SPHState(cells=cells, accel=dv, dudt=du, rho=rho,
                    time=state.time + dts)


def lane_cfl(state: SPHState, cfg: SPHConfig, bucket: int) -> torch.Tensor:
    """Each lane's CFL dt, ``min`` of ``cfl_timestep_particles`` over its
    rows: (B,) float32 (a minimum is exact in any order)."""
    return cfl_timestep_particles(state, cfg).reshape(bucket, -1).amin(1)


def lane_times(times: List[float], device=None) -> torch.Tensor:
    """Lanes' times as the (B,) float32 vector the step adds dt to."""
    return torch.from_numpy(np.asarray(times, np.float32)).to(device)
