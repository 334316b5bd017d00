"""Task-based SPH engine (single host, global dt) in PyTorch.

Port of ``repro.sph.engine``: the density → ghost → force chain of the
paper's Fig. 1 as batched wave passes over the cell-pair list, the KDK
leapfrog ``step``, and the host driver :class:`Simulation` with host-side
re-binning. The pair passes always go through the sph_pair wrappers
(``kernels/sph_pair/ops.py``): the Hopper kernels for CUDA tensors, their
plain PyTorch versions for CPU tensors.

``build_taskgraph`` builds the paper's Fig. 1 task graph over the cell
grid on the host (the port's ``core`` copy), the graph the distributed
engine's domain decomposition partitions.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import CostModel, TaskGraph
from ..device import DeviceLike, resolve_device, synchronize
from ..observability.tracer import NULL_TRACER
from .cellgrid import GridSpec, PairList, ParticleCells, bin_particles, \
    build_pair_list, choose_grid, unbin
from .physics import GAMMA, cfl_timestep_block, ghost_update, \
    smoothing_length_update


class SPHState(NamedTuple):
    cells: ParticleCells
    accel: torch.Tensor       # (ncells, C, 3)
    dudt: torch.Tensor        # (ncells, C)
    rho: torch.Tensor         # (ncells, C)
    time: torch.Tensor        # 0-d float32


@dataclass(frozen=True)
class SPHConfig:
    """SPH numerics, field for field the reference's ``SPHConfig``.

    ``use_pallas`` is kept so one config means the same run in both
    packages; in the port it selects nothing: CUDA tensors always go
    through the Hopper kernels and CPU tensors through their plain PyTorch
    versions.
    """
    kernel: str = "cubic"
    alpha_visc: float = 0.8
    gamma: float = GAMMA
    n_target: float = 48.0
    adapt_h: bool = False          # keep h fixed unless asked (conservation tests)
    cfl: float = 0.25
    use_pallas: bool = False


def periodic_wrap(x, box: float):
    """``jnp.mod(x, box)`` written out: fmod, then + box where the
    remainder's sign differs from the box's. A remainder below the
    smallest normal f32 counts as zero — XLA flushes subnormals, so a
    subnormal negative remainder stays as it is in the reference instead
    of becoming ``box``."""
    r = torch.fmod(x, box)
    nonzero = torch.abs(r) >= torch.finfo(torch.float32).tiny
    do_plus = ((r < 0.0) != (box < 0.0)) & nonzero
    return torch.where(do_plus, r + box, r)


# --------------------------------------------------------------- wave passes
def _density_pass(cells: ParticleCells, pairs: PairList, cfg: SPHConfig,
                  pair_mask: Optional[torch.Tensor] = None):
    """All density_self/density_pair tasks as one batched kernel launch.

    ``pair_mask`` (npairs,) zeroes the contributions of masked pair tasks
    (the time-bin engine's power-of-two padding).
    """
    from ..kernels.sph_pair import ops as pair_ops
    return pair_ops.density_pairs(cells, pairs, kernel=cfg.kernel,
                                  pair_mask=pair_mask)


def _force_pass(cells: ParticleCells, pairs: PairList, rho, press, omega, cs,
                cfg: SPHConfig, pair_mask: Optional[torch.Tensor] = None):
    """All force_self/force_pair tasks as one batched kernel launch."""
    from ..kernels.sph_pair import ops as pair_ops
    return pair_ops.force_pairs(cells, pairs, rho, press, omega, cs,
                                kernel=cfg.kernel, alpha_visc=cfg.alpha_visc,
                                pair_mask=pair_mask)


def compute_accelerations(cells: ParticleCells, pairs: PairList,
                          cfg: SPHConfig):
    """density → ghost → force (the Fig. 1 dependency chain)."""
    rho, drho_dh, nngb = _density_pass(cells, pairs, cfg)
    # padded slots: keep safe values so downstream divisions stay finite
    rho = torch.where(cells.mask > 0, rho, 1.0)
    drho_dh = torch.where(cells.mask > 0, drho_dh, 0.0)
    press, omega, cs = ghost_update(rho, drho_dh, cells.u, cells.h,
                                    gamma=cfg.gamma)
    press = torch.where(cells.mask > 0, press, 0.0)
    dv, du = _force_pass(cells, pairs, rho, press, omega, cs, cfg)
    mask3 = cells.mask[..., None]
    return dv * mask3, du * cells.mask, rho, nngb


def init_state(cells: ParticleCells, pairs: PairList,
               cfg: SPHConfig) -> SPHState:
    dv, du, rho, _ = compute_accelerations(cells, pairs, cfg)
    return SPHState(cells=cells, accel=dv, dudt=du, rho=rho,
                    time=torch.zeros((), dtype=cells.pos.dtype,
                                     device=cells.pos.device))


def step(state: SPHState, pairs: PairList, dt, box: float,
         cfg: SPHConfig) -> SPHState:
    """One KDK leapfrog step; ``dt`` is a 0-d float32 tensor."""
    cells = state.cells
    mask3 = cells.mask[..., None]
    # K: half kick with stored accelerations
    v_half = cells.vel + 0.5 * dt * state.accel
    u_half = torch.clamp_min(cells.u + 0.5 * dt * state.dudt, 1e-12)
    # D: drift
    pos = periodic_wrap(cells.pos + dt * v_half * mask3, box)
    cells = cells._replace(pos=pos, vel=v_half, u=u_half)
    # re-evaluate forces at the new positions
    dv, du, rho, nngb = compute_accelerations(cells, pairs, cfg)
    # K: second half kick
    v_new = cells.vel + 0.5 * dt * dv
    u_new = torch.clamp_min(u_half + 0.5 * dt * du, 1e-12)
    h_new = cells.h
    if cfg.adapt_h:
        h_new = smoothing_length_update(cells.h, rho, cells.mass, nngb,
                                        n_target=cfg.n_target)
        h_new = torch.where(cells.mask > 0, h_new, cells.h)
    cells = cells._replace(vel=v_new, u=u_new, h=h_new)
    return SPHState(cells=cells, accel=dv, dudt=du, rho=rho,
                    time=state.time + dt)


def cfl_timestep_particles(state: SPHState, cfg: SPHConfig) -> torch.Tensor:
    """Per-particle CFL dt (ncells, C); +inf on padded slots."""
    cells = state.cells
    return cfl_timestep_block(cells.h, cells.u, cells.vel, cells.mask,
                              gamma=cfg.gamma, cfl=cfg.cfl)


def cfl_timestep(state: SPHState, cfg: SPHConfig) -> torch.Tensor:
    """dt = C_CFL · min_i h_i / (c_i + |v_i|)."""
    return torch.min(cfl_timestep_particles(state, cfg))


def f32(x, device) -> torch.Tensor:
    """A host scalar as a 0-d float32 tensor on ``device`` (the reference
    passes ``jnp.float32(x)``)."""
    return torch.tensor(np.float32(x), device=device)


def diagnostics(cells: ParticleCells) -> Tuple[float, np.ndarray]:
    """(total energy, total momentum) over real particles (host numpy)."""
    m = (cells.mass * cells.mask).cpu().numpy()
    v = cells.vel.cpu().numpy()
    u = cells.u.cpu().numpy()
    ke = 0.5 * np.sum(m * np.sum(v * v, axis=-1))
    ie = np.sum(m * u)
    mom = np.sum(m[..., None] * v, axis=(0, 1))
    return float(ke + ie), mom


# -------------------------------------------------------------- task graph
def host_array(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def build_taskgraph(spec: GridSpec, pairs: PairList,
                    occupancy: np.ndarray,
                    cost_model: Optional[CostModel] = None, *,
                    cell_bins: Optional[np.ndarray] = None,
                    level: Optional[int] = None,
                    occupancy_by_bin: Optional[np.ndarray] = None,
                    time_average: bool = False) -> TaskGraph:
    """SWIFT's Fig. 1 task hierarchy for the current grid.

    Per cell: sort → … → ghost → … → kick; per pair (and per self-cell):
    density and force tasks with the dependencies of eqs. (2)–(4). Costs are
    the cost model's asymptotic estimates over the *actual* occupancies —
    the graph the domain decomposition partitions.

    Time-bin extensions (see ``timebins.py``):

    * ``cell_bins`` (ncells,) — each cell's deepest occupied time bin
      (−1 for empty cells). With ``level`` set, every task gets an
      *activation mask*: a per-cell task is active iff its cell holds a
      particle in a bin ≥ level; a pair task is active iff either cell
      does (an inactive neighbour still contributes to an active cell's
      sums, so the pair must run). ``wave_schedule(..., active_only=True)``
      then compiles a program over only the due work.
    * ``time_average`` with ``occupancy_by_bin`` (ncells, nbins) — task
      costs become cycle-averaged active work (bin b pays on a fraction
      2**(b−d) of sub-steps), so ``decompose_cells`` balances what
      actually runs rather than where particles merely sit.
    """
    cm = cost_model or CostModel(rates={})
    g = TaskGraph()
    nc = spec.ncells
    occ = host_array(occupancy).astype(np.int64)
    if time_average and occupancy_by_bin is None:
        raise ValueError("time_average=True requires occupancy_by_bin")
    bins_arr = None
    if cell_bins is not None:
        bins_arr = np.asarray(cell_bins, dtype=np.int64)
    obb = None
    max_bin = 0
    if occupancy_by_bin is not None:
        obb = np.asarray(occupancy_by_bin, dtype=np.int64)
        max_bin = obb.shape[1] - 1
    elif bins_arr is not None:
        max_bin = int(bins_arr.max()) if bins_arr.size else 0

    def cell_active(c: int) -> bool:
        if bins_arr is None or level is None:
            return True
        return bool(bins_arr[c] >= level)

    def cell_cost(kind: str, c: int) -> float:
        if time_average:
            return cm.timebin_units(kind, obb[c], max_bin=max_bin)
        return cm.units(kind, max(int(occ[c]), 1))

    def inter_cost(kind: str, a: int, b: Optional[int] = None) -> float:
        if time_average:
            return cm.timebin_units(kind, obb[a],
                                    obb[b] if b is not None else None,
                                    max_bin=max_bin)
        if b is None:
            return cm.units(kind, int(occ[a]))
        return cm.units(kind, int(occ[a]), int(occ[b]))

    sort = [g.add_task("sort", resources=(c,), writes=(c,),
                       cost=cell_cost("sort", c), active=cell_active(c))
            for c in range(nc)]
    ghost = [g.add_task("ghost", resources=(c,), writes=(c,),
                        cost=cell_cost("ghost", c), active=cell_active(c))
             for c in range(nc)]
    kick = [g.add_task("kick", resources=(c,), writes=(c,),
                       cost=cell_cost("kick", c), active=cell_active(c))
            for c in range(nc)]
    ci = host_array(pairs.ci)
    cj = host_array(pairs.cj)
    for a, b in zip(ci, cj):
        a, b = int(a), int(b)
        if a == b:
            act = cell_active(a)
            d = g.add_task("density_self", resources=(a,), writes=(a,),
                           cost=inter_cost("density_self", a), active=act)
            f = g.add_task("force_self", resources=(a,), writes=(a,),
                           cost=inter_cost("force_self", a), active=act)
            res = (a,)
        else:
            act = cell_active(a) or cell_active(b)
            d = g.add_task("density_pair", resources=(a, b), writes=(a, b),
                           cost=inter_cost("density_pair", a, b), active=act)
            f = g.add_task("force_pair", resources=(a, b), writes=(a, b),
                           cost=inter_cost("force_pair", a, b), active=act)
            res = (a, b)
        for c in res:
            g.add_dependency(d, sort[c])     # density after sort
            g.add_dependency(ghost[c], d)    # ghost after every density
            g.add_dependency(f, ghost[c])    # force after ghost
            g.add_dependency(kick[c], f)     # kick after every force
    return g


# ------------------------------------------------------------------ driver
class Simulation:
    """Host-side driver: binning, stepping, re-binning, diagnostics.

    .. deprecated:: constructing this directly is the legacy path; use
       ``repro_torch.sph.build_simulation(SimulationSpec(
       integrator="global", backend="local"))``.
    """

    def __init__(self, pos, vel, mass, u, h, *, box: float,
                 cfg: SPHConfig = SPHConfig(),
                 capacity_margin: float = 3.0,
                 rebin_every: int = 1, device: DeviceLike = None):
        if type(self) is Simulation:
            warnings.warn(
                "constructing repro_torch.sph.Simulation directly is "
                "deprecated; use repro_torch.sph.build_simulation("
                "SimulationSpec(...)) (integrator='global', backend='local')",
                DeprecationWarning, stacklevel=2)
        self.device = resolve_device(device)
        self.box = float(box)
        self.cfg = cfg
        self.n = len(pos)
        self.rebin_every = rebin_every
        h_max = float(np.max(h))
        self.spec = choose_grid(self.box, h_max, self.n,
                                capacity_margin=capacity_margin)
        self._rebin(np.asarray(pos), np.asarray(vel), np.asarray(mass),
                    np.asarray(u), np.asarray(h))
        self.state = init_state(self.cells, self.pairs, self.cfg)
        self._steps_since_rebin = 0
        self.tracer = NULL_TRACER
        self.device_metrics_enabled = False
        self.device_metrics_last = None
        self.device_metrics_pulls = 0
        self.device_cell_work_last = None

    def _rebin(self, pos, vel, mass, u, h):
        self.cells, self.perm = bin_particles(self.spec, pos, vel, mass, u,
                                              h, device=self.device)
        if self.cells.mass.shape[1] != self.spec.capacity:
            # capacity grew: record it so pair list block shapes stay valid
            object.__setattr__(self.spec, "capacity",
                               self.cells.mass.shape[1])
        self.pairs = build_pair_list(self.spec, device=self.device)

    def run(self, nsteps: int, dt: Optional[float] = None) -> Dict[str, list]:
        log: Dict[str, list] = {"t": [], "wall": [], "E": [], "px": []}
        for _ in range(nsteps):
            dt_step = dt if dt is not None else float(
                cfl_timestep(self.state, self.cfg))
            with self.tracer.timed("engine_step",
                                   pairs=int(self.pairs.ci.shape[0])) as sp:
                self.state = step(self.state, self.pairs,
                                  f32(dt_step, self.device), self.box,
                                  self.cfg)
                synchronize(self.device)
            wall = sp.elapsed
            self._steps_since_rebin += 1
            if self._steps_since_rebin >= self.rebin_every:
                flat = unbin(self.state.cells, self.perm, self.n)
                self._rebin(flat["pos"], flat["vel"], flat["mass"],
                            flat["u"], flat["h"])
                accel0 = init_state(self.cells, self.pairs, self.cfg)
                self.state = accel0._replace(time=self.state.time)
                self._steps_since_rebin = 0
            log["t"].append(float(self.state.time))
            log["wall"].append(wall)
            e, p = self.diagnostics()
            log["E"].append(e)
            log["px"].append(p[0])
        return log

    def diagnostics(self) -> Tuple[float, np.ndarray]:
        """(total energy, total momentum) over real particles."""
        return diagnostics(self.state.cells)
