"""Hierarchical time-bin integration: per-particle time-steps (1807.01341).

Port of ``repro.sph.timebins``. Each particle sits in a power-of-two time
bin: bin b steps with dt = dt_max / 2**b. One *cycle* spans dt_max in
2**depth sub-steps of the finest dt. At sub-step n the bins b ≥ depth −
tz(n) are active and get density → ghost → force → kick; the others are
drifted and contribute through their stored density and pressure. Kicks
close and re-open at bin boundaries: the KDK ladder of 1807.01341 Fig. 1,
which reduces to the global-dt leapfrog when depth = 0.

The cycle plan, bin limiter and pair subsets are numpy on the host, as in
the reference; the five ladder programs (``timebin_programs``) are plain
functions on device tensors. Float scalars that the reference passes as
``jnp.float32`` (dt_max, dt_min, u_floor) are 0-d float32 tensors here, so
every discrete decision (bins, wake floors) sees the reference's f32 bits.
The host pulls ``bins`` after every force sub-step, as the reference does.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, synchronize
from ..observability import device_metrics as dmetrics
from ..observability.tracer import NULL_TRACER
from .cellgrid import PairList, ParticleCells, bin_particles, choose_grid, \
    incoming_table, make_pair_list, pair_arrays, unbin
from .engine import SPHConfig, _density_pass, _force_pass, diagnostics, \
    f32, periodic_wrap
from .physics import cfl_timestep_block, ghost_update

MAX_DEPTH_DEFAULT = 10      # ≥3 decades of dt spread (2**10 = 1024)
_U_FLOOR = 1e-12
_DU_SAFETY = 0.25           # dt ≤ κ·u/|du/dt| — strong-shock heating limit


def particle_timesteps(cells: ParticleCells, dudt, *, gamma: float,
                       cfl: float, du_safety: float = _DU_SAFETY,
                       u_floor=0.0):
    """Per-particle dt: CFL ∧ the internal-energy criterion
    κ·(u + u_floor)/|du/dt| (device tensors; ``u_floor`` a 0-d tensor)."""
    dt = cfl_timestep_block(cells.h, cells.u, cells.vel, cells.mask,
                            gamma=gamma, cfl=cfl)
    dt_u = du_safety * (cells.u + u_floor) / torch.clamp_min(
        torch.abs(dudt), 1e-30)
    dt_u = torch.where(cells.mask > 0, dt_u, torch.inf)
    return torch.minimum(dt, dt_u)


# ------------------------------------------------------------------ bin math
# ratio > _BIN_THRESHOLDS[k-1] puts a particle at least in bin k: f32
# thresholds precomputed in float64, so the decision is a pure f32
# comparison and host and device plans agree bit for bit.
BIN_LADDER_MAX = 24
_BIN_THRESHOLDS = np.asarray(
    2.0 ** (np.arange(BIN_LADDER_MAX) + 1e-6), np.float32)
# dt_max / 2**b factors, exact powers of two for every bin of the ladder
_BIN_SCALE = np.asarray(2.0 ** -np.arange(BIN_LADDER_MAX + 1), np.float32)
_ON_DEVICE: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def device_table(name: str, device) -> torch.Tensor:
    """The bin ladder's constant table ``name`` (``"thresholds"`` or
    ``"scale"``) on ``device``, copied there once: a copy inside a
    device-scheduled segment would wait for the card."""
    key = (name, torch.device(device))
    if key not in _ON_DEVICE:
        src = {"thresholds": _BIN_THRESHOLDS, "scale": _BIN_SCALE}[name]
        _ON_DEVICE[key] = torch.from_numpy(src).to(device)
    return _ON_DEVICE[key]


def assign_bins(dt, dt_max, max_bin):
    """Smallest b with dt_max / 2**b ≤ dt, clipped to [0, max_bin].

    numpy arrays (host planning, ``dt_max`` a float) or tensors (device
    deepening, ``dt_max`` a 0-d float32 tensor; ``max_bin`` an int or,
    where only the card knows it, a 0-d int32 tensor); +inf entries land
    in bin 0.
    """
    if isinstance(dt, torch.Tensor):
        ratio = dt_max / torch.clamp_min(dt, 1e-30)
        thr = device_table("thresholds", dt.device)
        b = (ratio[..., None] > thr).sum(-1).to(torch.int32)
        return torch.clamp_max(b, max_bin).to(torch.int32)
    ratio = dt_max / np.maximum(dt, 1e-30)
    b = (ratio[..., None] > _BIN_THRESHOLDS).sum(axis=-1).astype(np.int32)
    return np.minimum(b, max_bin).astype(np.int32)


def bin_timestep(dt_max, bins: torch.Tensor) -> torch.Tensor:
    """dt of each bin: dt_max / 2**b, scaled by an exact power of two.

    (The reference computes ``exp2(-b)``; XLA's CPU exp2 is a few ulp off
    a power of two for b ≥ 13, beyond the default ladder depth.)
    """
    return dt_max * device_table("scale", bins.device)[bins.long()]


def active_level(n: int, depth: int) -> int:
    """Lowest active bin at sub-step ``n`` of a 2**depth cycle (n = 0
    activates every bin)."""
    if n == 0:
        return 0
    tz = (n & -n).bit_length() - 1
    return max(depth - tz, 0)


def trailing_zeros_table(nsub: int) -> np.ndarray:
    """tz(n) for n = 0..nsub as an int32 table (tz(0) := 0): the level of
    sub-step n of a depth-d cycle is max(d − tz[n], 0), as
    :func:`active_level` computes it."""
    return np.asarray(
        [0] + [(n & -n).bit_length() - 1 for n in range(1, nsub + 1)],
        np.int32)


def clip_bins(x, depth):
    """``clip(x, 0, depth)`` for an int or a 0-d int32 tensor ``depth``."""
    return torch.clamp_max(torch.clamp_min(x, 0), depth)


def dt_min_of(dt_max: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """dt_max / 2**depth for 0-d tensors, by an exact power of two (the
    host's ``dt_max / nsub`` in float64 rounds to the same float32)."""
    scale = device_table("scale", dt_max.device)
    # index_select, not scale[depth]: a 0-d index is read on the host
    return dt_max * scale.index_select(0, depth.long().reshape(1))[0]


# ---------------------------------------------------- reproducible reductions
def tree_sum(x):
    """Sum by fixed binary fold (pad to a power of two, halve repeatedly):
    a summation order that does not depend on the library. numpy arrays
    fold on the host, tensors on their device (never ``torch.sum``, whose
    order is not pinned), to the same bits."""
    on_device = isinstance(x, torch.Tensor)
    x = x.reshape(-1) if on_device else np.ravel(x)
    n = x.shape[0]
    p = 1
    while p < max(n, 1):
        p *= 2
    if p != n:
        x = (torch.cat([x, x.new_zeros((p - n,))]) if on_device else
             np.concatenate([x, np.zeros((p - n,), x.dtype)]))
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def mass_weighted_mean_u(mass_masked, u):
    """u_floor of :func:`particle_timesteps`: Σ m·u / Σ m via tree_sum
    (numpy arrays or tensors)."""
    num = tree_sum(mass_masked * u)
    if isinstance(num, torch.Tensor):
        return num / torch.clamp_min(tree_sum(mass_masked), 1e-30)
    den = np.maximum(tree_sum(mass_masked), 1e-30)
    return num / den


def speed_norm(vel: np.ndarray):
    """|v| with a pinned evaluation order: sqrt((v0² + v1²) + v2²) in f32."""
    v0, v1, v2 = vel[..., 0], vel[..., 1], vel[..., 2]
    return np.sqrt((v0 * v0 + v1 * v1) + v2 * v2)


def cell_max_bins(bins: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Deepest occupied bin per cell, −1 for empty cells: (ncells,)."""
    b = np.where(np.asarray(mask) > 0, np.asarray(bins), -1)
    return b.max(axis=1).astype(np.int64)


def cell_bin_histogram(bins: np.ndarray, mask: np.ndarray,
                       nbins: int) -> np.ndarray:
    """(ncells, nbins) occupancy histogram over time bins."""
    bins = np.asarray(bins)
    mask = np.asarray(mask) > 0
    ncells = bins.shape[0]
    out = np.zeros((ncells, nbins), dtype=np.int64)
    for c in range(ncells):
        bc = bins[c][mask[c]]
        if len(bc):
            out[c] = np.bincount(np.clip(bc, 0, nbins - 1), minlength=nbins)
    return out


def neighbour_table(ci: np.ndarray, cj: np.ndarray, ncells: int
                    ) -> np.ndarray:
    """(ncells, K) the cells each cell shares a pair with (padded with the
    cell itself): ``x[table].max(1)`` is the reference's
    ``np.maximum.at(x, ci, x[cj]); np.maximum.at(x, cj, x[ci])``."""
    cells, rows = incoming_table(ci, cj, ncells)
    P = len(ci)
    other = np.concatenate([np.asarray(cj, np.int64),
                            np.asarray(ci, np.int64), [-1]])
    nbr = other[rows]
    nbr = np.where(nbr < 0, cells[:, None], nbr)
    table = np.repeat(np.arange(ncells, dtype=np.int64)[:, None],
                      nbr.shape[1] if P else 1, axis=1)
    table[cells] = nbr
    return table


def _neighbour_max(x: np.ndarray, table: np.ndarray) -> np.ndarray:
    return np.maximum(x, x[table].max(axis=1))


def limit_neighbour_bins(bins: np.ndarray, mask: np.ndarray,
                         ci: np.ndarray, cj: np.ndarray, *,
                         delta: int = 2, max_bin: int,
                         max_iter: int = 256) -> np.ndarray:
    """Neighbour time-step limiter (Saitoh–Makino, at cell granularity):
    every particle's bin is floored at (deepest bin among its own and
    neighbouring cells) − delta, iterated to the fixpoint."""
    mask = np.asarray(mask) > 0
    bins = np.asarray(bins)
    deep = np.where(mask, bins, -10 ** 6).max(axis=1)
    table = neighbour_table(ci, cj, len(deep))
    for _ in range(max_iter):
        nb = _neighbour_max(deep, table)
        new_deep = np.maximum(deep, nb - delta)
        if (new_deep == deep).all():
            break
        deep = new_deep
    nb = _neighbour_max(deep, table)
    floor = np.clip(nb - delta, 0, max_bin)
    out = np.maximum(bins, floor[:, None])
    return np.where(mask, out, bins).astype(np.int32)


# -------------------------------------------------------------------- state
# the state layout, as field-name tuples (the reference's, for convert.py)
STATE_CELL_FIELDS = ("pos", "vel", "mass", "u", "h", "mask")
STATE_AUX_FIELDS = ("accel", "dudt", "rho", "omega", "bins", "t_start")


class TimeBinState(NamedTuple):
    """Multi-dt engine state: the global-dt state plus per-particle bins,
    the stored thermodynamics inactive particles expose to their active
    neighbours, and each particle's step-start time ``t_start``."""
    cells: ParticleCells
    accel: torch.Tensor       # (ncells, C, 3)
    dudt: torch.Tensor        # (ncells, C)
    rho: torch.Tensor         # (ncells, C)
    omega: torch.Tensor       # (ncells, C)
    bins: torch.Tensor        # (ncells, C) int32
    t_start: torch.Tensor     # (ncells, C)
    time: torch.Tensor        # 0-d float32


# --------------------------------------------------------- ladder programs
def _active_accelerations(cells: ParticleCells, pairs: PairList, pair_mask,
                          active, rho_prev, omega_prev, cfg: SPHConfig):
    """density → ghost → force over a (level-restricted) pair list; the
    inactive particles keep their stored rho / omega."""
    mask = cells.mask
    rho_new, drho_dh, nngb = _density_pass(cells, pairs, cfg,
                                           pair_mask=pair_mask)
    rho_new = torch.where(mask > 0, rho_new, 1.0)
    drho_dh = torch.where(mask > 0, drho_dh, 0.0)
    rho = torch.where(active > 0, rho_new, rho_prev)
    press, omega_new, cs = ghost_update(rho, drho_dh, cells.u, cells.h,
                                        gamma=cfg.gamma)
    omega = torch.where(active > 0, omega_new, omega_prev)
    press = torch.where(mask > 0, press, 0.0)
    dv, du = _force_pass(cells, pairs, rho, press, omega, cs, cfg,
                         pair_mask=pair_mask)
    mask3 = mask[..., None]
    return dv * mask3, du * mask, rho, omega


def _fill(like: torch.Tensor, scalar: torch.Tensor) -> torch.Tensor:
    """``jnp.full_like(like, scalar)`` for a 0-d tensor (no host sync)."""
    return scalar.expand_as(like).contiguous()


def timebin_init(cells: ParticleCells, pairs: PairList,
                 cfg: SPHConfig) -> TimeBinState:
    """Full (every-particle) force evaluation → synchronised initial state."""
    ones = cells.mask
    dv, du, rho, omega = _active_accelerations(
        cells, pairs, None, ones, torch.ones_like(cells.u),
        torch.ones_like(cells.u), cfg)
    zero = torch.zeros((), dtype=cells.pos.dtype, device=cells.pos.device)
    return TimeBinState(cells=cells, accel=dv, dudt=du, rho=rho, omega=omega,
                        bins=torch.zeros(cells.mass.shape, dtype=torch.int32,
                                         device=cells.pos.device),
                        t_start=torch.zeros_like(cells.mass),
                        time=zero)


def _kick(cells: ParticleCells, accel, dudt, active, half_dt
          ) -> ParticleCells:
    """Half-kick of the active particles (their own bin's dt)."""
    active3 = active[..., None]
    v = cells.vel + half_dt[..., None] * accel * active3
    u = torch.where(active > 0,
                    torch.clamp_min(cells.u + half_dt * dudt, _U_FLOOR),
                    cells.u)
    return cells._replace(vel=v, u=u)


def _cycle_start(state: TimeBinState, dt_max, *, cfg: SPHConfig
                 ) -> TimeBinState:
    """Opening half-kick: every bin starts its first step at n = 0."""
    active = state.cells.mask
    half_dt = 0.5 * bin_timestep(dt_max, state.bins)
    cells = _kick(state.cells, state.accel, state.dudt, active, half_dt)
    return state._replace(cells=cells, t_start=_fill(state.t_start,
                                                     state.time))


def _drift(state: TimeBinState, dt_min, *, box: float) -> TimeBinState:
    """Drift *all* particles: position-only prediction for inactive ones."""
    cells = state.cells
    pos = periodic_wrap(cells.pos + dt_min * cells.vel
                        * cells.mask[..., None], box)
    return state._replace(cells=cells._replace(pos=pos),
                          time=state.time + dt_min)


def _substep_density_phase(state: TimeBinState, pairs: PairList, pair_mask,
                           active, *, cfg: SPHConfig):
    """Density half of a bin-boundary update: fresh rho/omega for the
    ``active`` particles, press/cs for every particle."""
    cells = state.cells
    mask = cells.mask
    rho_new, drho_dh, nngb = _density_pass(cells, pairs, cfg,
                                           pair_mask=pair_mask)
    rho_new = torch.where(mask > 0, rho_new, 1.0)
    drho_dh = torch.where(mask > 0, drho_dh, 0.0)
    rho = torch.where(active > 0, rho_new, state.rho)
    press, omega_new, cs = ghost_update(rho, drho_dh, cells.u, cells.h,
                                        gamma=cfg.gamma)
    omega = torch.where(active > 0, omega_new, state.omega)
    press = torch.where(mask > 0, press, 0.0)
    return rho, omega, press, cs


def _apply_force_kick(state: TimeBinState, active, dv, du, rho, omega,
                      wake_floor, dt_max, depth, u_floor, *,
                      cfg: SPHConfig) -> Tuple[TimeBinState, torch.Tensor]:
    """Close/deepen/re-open the active bins given raw force-pass sums
    (``depth`` an int, or a 0-d int32 tensor where only the card knows
    it)."""
    cells = state.cells
    mask = cells.mask
    mask3 = mask[..., None]
    dv, du = dv * mask3, du * mask
    accel = torch.where(active[..., None] > 0, dv, state.accel)
    dudt = torch.where(active > 0, du, state.dudt)
    # close the ending step: v is at t_start + dt_bin/2, bring it to `t`
    elapsed = state.time - state.t_start
    close = elapsed - 0.5 * bin_timestep(dt_max, state.bins)
    cells = _kick(cells, accel, dudt, active, close)
    # deepen where the new CFL/heating step (or the wake floor) demands it
    dt_need = particle_timesteps(cells, dudt, gamma=cfg.gamma, cfl=cfg.cfl,
                                 u_floor=u_floor)
    b_need = torch.maximum(assign_bins(dt_need, dt_max, depth),
                           clip_bins(wake_floor, depth)[:, None])
    bins = torch.where(active > 0, torch.maximum(state.bins, b_need),
                       state.bins)
    # open the next step
    half_new = 0.5 * bin_timestep(dt_max, bins)
    cells = _kick(cells, accel, dudt, active, half_new)
    t_start = torch.where(active > 0, state.time, state.t_start)
    nact = torch.sum(active).to(torch.int32)
    return state._replace(cells=cells, accel=accel, dudt=dudt, rho=rho,
                          omega=omega, bins=bins, t_start=t_start), nact


def _substep_force_phase(state: TimeBinState, pairs: PairList, pair_mask,
                         active, rho, omega, press, cs, wake_floor, dt_max,
                         depth: int, u_floor, *, cfg: SPHConfig
                         ) -> Tuple[TimeBinState, torch.Tensor]:
    """Force + kick half of a bin-boundary update."""
    dv, du = _force_pass(state.cells, pairs, rho, press, omega, cs, cfg,
                         pair_mask=pair_mask)
    return _apply_force_kick(state, active, dv, du, rho, omega, wake_floor,
                             dt_max, depth, u_floor, cfg=cfg)


def substep_active_mask(state: TimeBinState, level: int, wake_floor
                        ) -> torch.Tensor:
    """Particles ending a step now: bin boundary (bins ≥ level) or woken by
    the neighbour limiter (their cell's wake floor exceeds their bin)."""
    at_boundary = state.bins >= level
    woken = state.bins < wake_floor[:, None]
    return ((at_boundary | woken)
            & (state.cells.mask > 0)).to(state.cells.pos.dtype)


def _force_substep(state: TimeBinState, pairs: PairList, pair_mask,
                   level: int, wake_floor, dt_max, depth: int, u_floor, *,
                   cfg: SPHConfig) -> Tuple[TimeBinState, torch.Tensor]:
    """Bin-boundary update at an interior sub-step: the density phase,
    then force + kick."""
    active = substep_active_mask(state, level, wake_floor)
    rho, omega, press, cs = _substep_density_phase(
        state, pairs, pair_mask, active, cfg=cfg)
    return _substep_force_phase(state, pairs, pair_mask, active, rho, omega,
                                press, cs, wake_floor, dt_max, depth,
                                u_floor, cfg=cfg)


def _apply_final_kick(state: TimeBinState, dv, du, rho, omega, dt_max,
                      *, cfg: SPHConfig) -> TimeBinState:
    """Closing kick of the cycle-ending boundary, given raw force sums."""
    cells = state.cells
    active = cells.mask
    mask3 = cells.mask[..., None]
    dv, du = dv * mask3, du * cells.mask
    elapsed = state.time - state.t_start
    close = elapsed - 0.5 * bin_timestep(dt_max, state.bins)
    cells = _kick(cells, dv, du, active, close)
    return state._replace(cells=cells, accel=dv, dudt=du, rho=rho,
                          omega=omega,
                          t_start=_fill(state.t_start, state.time))


def _final_force_phase(state: TimeBinState, pairs: PairList, pair_mask,
                       rho, omega, press, cs, dt_max, *, cfg: SPHConfig
                       ) -> TimeBinState:
    """Force + closing kick of the cycle-ending boundary."""
    dv, du = _force_pass(state.cells, pairs, rho, press, omega, cs, cfg,
                         pair_mask=pair_mask)
    return _apply_final_kick(state, dv, du, rho, omega, dt_max, cfg=cfg)


def _force_final(state: TimeBinState, pairs: PairList, pair_mask, dt_max,
                 *, cfg: SPHConfig) -> TimeBinState:
    """Cycle-closing boundary: every bin ends; no step is opened."""
    active = state.cells.mask
    rho, omega, press, cs = _substep_density_phase(
        state, pairs, pair_mask, active, cfg=cfg)
    return _final_force_phase(state, pairs, pair_mask, rho, omega, press,
                              cs, dt_max, cfg=cfg)


def timebin_programs(box: float, cfg: SPHConfig) -> Dict[str, object]:
    """The five ladder programs per (box, physics config), as plain
    functions (the reference's ``shared_timebin_programs``, unjitted)."""
    return {
        "init": functools.partial(timebin_init, cfg=cfg),
        "start": functools.partial(_cycle_start, cfg=cfg),
        "drift": functools.partial(_drift, box=box),
        "sub": functools.partial(_force_substep, cfg=cfg),
        "final": functools.partial(_force_final, cfg=cfg),
    }


# ------------------------------------------------------------------- driver
class TimeBinSimulation:
    """Host driver of the sub-step hierarchy (multi-dt ``Simulation``).

    Per cycle: quantise per-particle CFL steps into bins, pick depth =
    deepest occupied bin + headroom (bounded by ``max_depth``), run the KDK
    ladder over 2**depth sub-steps activating only due bins, then
    re-synchronise, re-bin particles into cells and carry the state over.
    Sub-steps run over the pairs touching an active cell, padded to a
    power-of-two length with masked repeats of pair 0, as in the reference.
    """

    def __init__(self, pos, vel, mass, u, h, *, box: float,
                 cfg: SPHConfig = SPHConfig(),
                 dt_max: Optional[float] = None,
                 max_depth: int = MAX_DEPTH_DEFAULT,
                 bin_delta: int = 2,
                 depth_headroom: int = 2,
                 capacity_margin: float = 3.0,
                 rebin_each_cycle: bool = True,
                 device: DeviceLike = None):
        if type(self) is TimeBinSimulation:
            warnings.warn(
                "constructing repro_torch.sph.TimeBinSimulation directly is "
                "deprecated; use repro_torch.sph.build_simulation("
                "SimulationSpec(...)) (integrator='timebin', "
                "backend='local')", DeprecationWarning, stacklevel=2)
        self.device = resolve_device(device)
        self.box = float(box)
        self.cfg = cfg
        self.n = len(pos)
        self.dt_max = dt_max
        if int(max_depth) > BIN_LADDER_MAX:
            raise ValueError(
                f"max_depth {max_depth} exceeds the assign_bins comparison "
                f"ladder ({BIN_LADDER_MAX} levels)")
        self.max_depth = int(max_depth)
        self.bin_delta = int(bin_delta)
        self.depth_headroom = int(depth_headroom)
        self.rebin_each_cycle = rebin_each_cycle
        h_max = float(np.max(h))
        self.spec = choose_grid(self.box, h_max, self.n,
                                capacity_margin=capacity_margin)
        self._rebin(np.asarray(pos), np.asarray(vel), np.asarray(mass),
                    np.asarray(u), np.asarray(h))
        progs = timebin_programs(self.box, cfg)
        self._init = progs["init"]
        self._start = progs["start"]
        self._drift = progs["drift"]
        self._sub = progs["sub"]
        self._final = progs["final"]
        self.state = self._init(self.cells, self.pairs)
        self.particle_updates = 0       # force evaluations actually received
        self.global_equiv_updates = 0   # what global-dt would have performed
        self.substeps = 0
        self.tracer = NULL_TRACER
        self.cycle_index = 0
        self.device_metrics_enabled = False
        self.device_metrics_last: Optional[Tuple[np.ndarray,
                                                 np.ndarray]] = None
        self.device_metrics_pulls = 0
        self.device_cell_work_last: Optional[Dict] = None

    # ------------------------------------------------------------- plumbing
    def _rebin(self, pos, vel, mass, u, h):
        self.cells, self.perm = bin_particles(self.spec, pos, vel, mass, u,
                                              h, device=self.device)
        if self.cells.mass.shape[1] != self.spec.capacity:
            object.__setattr__(self.spec, "capacity",
                               self.cells.mass.shape[1])
        self._ci, self._cj, self._shift = pair_arrays(self.spec)
        self.pairs = make_pair_list(self._ci, self._cj, self._shift,
                                    self.spec.ncells, self.device)
        self._nbr = neighbour_table(self._ci, self._cj, self.spec.ncells)

    def _flatten_aux(self, arr: torch.Tensor, fill) -> np.ndarray:
        valid = self.perm >= 0
        idx = self.perm[valid]
        a = arr.cpu().numpy()
        out = np.full((self.n,) + a.shape[2:], fill, dtype=a.dtype)
        out[idx] = a[valid]
        return out

    def _rebin_state(self):
        """Re-bin particles into cells, carrying the full multi-dt state
        (no extra force pass: accel/rho/omega/bins ride along)."""
        st = self.state
        flat = unbin(st.cells, self.perm, self.n)
        aux = {
            "accel": self._flatten_aux(st.accel, 0.0),
            "dudt": self._flatten_aux(st.dudt, 0.0),
            "rho": self._flatten_aux(st.rho, 1.0),
            "omega": self._flatten_aux(st.omega, 1.0),
            "bins": self._flatten_aux(st.bins, 0),
            "t_start": self._flatten_aux(st.t_start, 0.0),
        }
        self._rebin(flat["pos"], flat["vel"], flat["mass"], flat["u"],
                    flat["h"])
        valid = self.perm >= 0
        idx = self.perm[valid]

        def take(a, fill):
            out = np.full(self.perm.shape + a.shape[1:], fill, dtype=a.dtype)
            out[valid] = a[idx]
            return torch.from_numpy(out).to(self.device)

        self.state = TimeBinState(
            cells=self.cells,
            accel=take(aux["accel"], 0.0),
            dudt=take(aux["dudt"], 0.0),
            rho=take(aux["rho"], 1.0),
            omega=take(aux["omega"], 1.0),
            bins=take(aux["bins"], 0),
            t_start=take(aux["t_start"], 0.0),
            time=st.time)

    def _pair_subset(self, active_cells: np.ndarray
                     ) -> Tuple[PairList, torch.Tensor, int]:
        """Pairs touching an active cell, padded to a power-of-two length
        with masked repeats of pair 0 (left out of the incoming table)."""
        sel = active_cells[self._ci] | active_cells[self._cj]
        idx = np.nonzero(sel)[0]
        nlive = len(idx)
        npad = 1
        while npad < max(nlive, 1):
            npad *= 2
        pad = np.zeros(npad - nlive, dtype=idx.dtype)
        idxp = np.concatenate([idx, pad])
        pmask = np.zeros(npad, np.float32)
        pmask[:nlive] = 1.0
        sub = make_pair_list(self._ci[idxp], self._cj[idxp],
                             self._shift[idxp], self.spec.ncells,
                             self.device, nlive=nlive)
        return sub, torch.from_numpy(pmask).to(self.device), nlive

    def _wake_floor(self, bins_h: np.ndarray, mask_host: np.ndarray
                    ) -> np.ndarray:
        """Per-cell wake threshold: deepest bin in the 27-stencil − delta."""
        deep = np.where(mask_host > 0, bins_h, -10 ** 6).max(axis=1)
        nb = _neighbour_max(deep, self._nbr)
        return np.maximum(nb - self.bin_delta, 0).astype(np.int32)

    # -------------------------------------------------------------- cycling
    def _signal_speeds(self, vel: np.ndarray, u: np.ndarray,
                       mask: np.ndarray) -> np.ndarray:
        """Neighbourhood-max signal speed per cell (SWIFT's v_sig CFL):
        max_j(c_j + |v_j|) over the interaction stencil."""
        v = speed_norm(vel)
        g = self.cfg.gamma
        cs = np.sqrt(np.maximum(g * (g - 1.0) * u, 0.0))
        speed = np.where(mask > 0, cs + v, 0.0)
        return _neighbour_max(speed.max(axis=1), self._nbr)

    def _plan_cycle(self) -> Tuple[float, int]:
        """Assign bins from the signal-velocity CFL field; returns
        (dt_max_cycle, depth)."""
        cells = self.state.cells
        mask_f = cells.mask.cpu().numpy()
        s_nb = self._signal_speeds(cells.vel.cpu().numpy(),
                                   cells.u.cpu().numpy(), mask_f)
        h = cells.h.cpu().numpy()
        dts = self.cfg.cfl * h / np.maximum(s_nb[:, None], 1e-12)
        mask = mask_f > 0
        dts = np.where(mask, dts, np.inf)
        live = dts[mask]
        dt_min_req = float(live.min())
        dt_max_c = self.dt_max if self.dt_max is not None else float(
            live.max())
        # never let the ladder exceed max_depth: shorten the cycle instead
        # (the min is taken in f32, as the reference does)
        dt_max_c = float(min(np.float32(dt_max_c),
                             np.float32(dt_min_req)
                             * np.float32(2.0 ** self.max_depth)))
        bins = assign_bins(dts, dt_max_c, self.max_depth)
        bins = np.where(mask, bins, 0).astype(np.int32)
        bins = limit_neighbour_bins(bins, mask, self._ci, self._cj,
                                    delta=self.bin_delta,
                                    max_bin=self.max_depth)
        bins = np.where(mask, bins, 0).astype(np.int32)
        occupied = int(bins[mask].max()) if mask.any() else 0
        depth = min(occupied + self.depth_headroom, self.max_depth)
        self.state = self.state._replace(
            bins=torch.from_numpy(bins).to(self.device))
        return dt_max_c, depth

    def run_cycle(self) -> Dict[str, float]:
        """One dt_max cycle of the KDK ladder; returns cycle stats."""
        tr = self.tracer
        if tr.enabled:
            tr.ctx["cycle"] = self.cycle_index
            tr.ctx.pop("substep", None)
        with tr.timed("cycle") as cyc:
            stats = self._run_cycle_body(tr)
        if tr.enabled:
            tr.ctx.pop("substep", None)
        self.cycle_index += 1
        stats["wall"] = cyc.elapsed
        return stats

    def _run_cycle_body(self, tr) -> Dict[str, float]:
        dev = self.device
        with tr.span("plan"):
            dt_max_c, depth = self._plan_cycle()
        nsub = 1 << depth
        dt_min = dt_max_c / nsub
        cells = self.state.cells
        mask_host = cells.mask.cpu().numpy()
        nreal = int(mask_host.sum())
        bins_host = self.state.bins.cpu().numpy()
        m_h = (cells.mass * cells.mask).cpu().numpy()
        u_floor = float(mass_weighted_mean_u(m_h, cells.u.cpu().numpy()))
        hist = np.bincount(bins_host[mask_host > 0], minlength=depth + 1)
        dt_max_t = f32(dt_max_c, dev)
        u_floor_t = f32(u_floor, dev)

        with tr.span("start", units=nreal):
            state = self._start(self.state, dt_max_t)
            if tr.enabled:
                tr.fence(state.cells.pos)
        updates = 0
        pair_tasks = 0
        force_substeps = 0
        drifted_to = 0          # sub-steps of drift applied so far
        # host caches — bins only change at force sub-steps (deepening)
        bins_h = state.bins.cpu().numpy()
        wake_floor = self._wake_floor(bins_h, mask_host)
        wake_floor_t = torch.from_numpy(wake_floor).to(dev)
        dm_on = self.device_metrics_enabled
        met_counts, met_values = dmetrics.zero_rows(1)
        mVI = dmetrics.VALUE_INDEX
        cellw = cellw_rank = None
        if dm_on:
            # per-cell attribution: every pair charges its ci cell, drift
            # is the alive count per cell, exchange is zero (no halo)
            cellw, cellw_rank = dmetrics.zero_cell_work(self.spec.ncells, 1)
            cDI = dmetrics.CELL_INDEX
            alive_cell = (mask_host > 0).sum(axis=1).astype(np.float64)

            def attribute_cells(pair_idx):
                np.add.at(cellw[:, cDI["density"]], self._ci[pair_idx], 1.0)
                np.add.at(cellw[:, cDI["force"]], self._ci[pair_idx], 1.0)
                cellw[:, cDI["drift"]] += alive_cell
                cellw_rank[0, cDI["density"]] += len(pair_idx)
                cellw_rank[0, cDI["force"]] += len(pair_idx)
                cellw_rank[0, cDI["drift"]] += nreal
        for n in range(1, nsub):
            level = active_level(n, depth)
            active_p = ((bins_h >= level)
                        | (bins_h < wake_floor[:, None])) & (mask_host > 0)
            if not active_p.any():
                continue            # headroom level with nothing due
            if tr.enabled:
                tr.ctx["substep"] = n
            # lazily apply the accumulated drift up to time t0 + n·dt_min
            with tr.span("drift", units=nreal):
                state = self._drift(state, f32((n - drifted_to) * dt_min,
                                               dev))
                if tr.enabled:
                    tr.fence(state.cells.pos)
            drifted_to = n
            sub, pmask, nlive = self._pair_subset(active_p.any(axis=1))
            sub_attrs = {}
            if tr.enabled:
                sub_attrs = dict(level=level, units=nlive, pairs=nlive,
                                 active_frac=float(active_p.sum())
                                 / max(nreal, 1))
            with tr.span("substep", **sub_attrs):
                state, nact = self._sub(state, sub, pmask, level,
                                        wake_floor_t, dt_max_t, depth,
                                        u_floor_t)
                if tr.enabled:
                    tr.fence(state.cells.pos)
            updates += int(nact)
            pair_tasks += nlive
            force_substeps += 1
            # bins only change at force sub-steps (deepening / wake-up):
            # recompute the wake floors only when they actually did
            bins_new = state.bins.cpu().numpy()
            deepened = 0
            if not np.array_equal(bins_new, bins_h):
                deepened = int((bins_new != bins_h).sum())
                bins_h = bins_new
                wake_floor = self._wake_floor(bins_h, mask_host)
                wake_floor_t = torch.from_numpy(wake_floor).to(dev)
            if dm_on:
                met_counts[0] += dmetrics.host_row(
                    substeps=1, drift_active=nreal,
                    density_active=int(nact), force_active=int(nact),
                    pair_int=nlive, deepen_events=deepened,
                    wake_events=int(((bins_h < wake_floor[:, None])
                                     & (mask_host > 0)).sum()))[0]
                met_values[0, mVI["density_units"]] += nlive
                met_values[0, mVI["force_units"]] += nlive
                met_values[0, mVI["kick_units"]] += int(nact)
                acells = active_p.any(axis=1)
                attribute_cells(np.nonzero(acells[self._ci]
                                           | acells[self._cj])[0])
        if tr.enabled:
            tr.ctx["substep"] = nsub
        with tr.span("drift", units=nreal):
            state = self._drift(state, f32((nsub - drifted_to) * dt_min,
                                           dev))
            if tr.enabled:
                tr.fence(state.cells.pos)
        npairs = len(self._ci)
        with tr.span("final", units=npairs, pairs=npairs, active_frac=1.0):
            state = self._final(state, self.pairs,
                                torch.ones(npairs, dtype=torch.float32,
                                           device=dev), dt_max_t)
            synchronize(dev)
        updates += nreal
        pair_tasks += npairs
        if dm_on:
            met_counts[0] += dmetrics.host_row(
                substeps=1, drift_active=nreal, density_active=nreal,
                force_active=nreal, pair_int=npairs)[0]
            met_values[0, mVI["density_units"]] += npairs
            met_values[0, mVI["force_units"]] += npairs
            met_values[0, mVI["kick_units"]] += nreal
            attribute_cells(np.arange(npairs))
            c = state.cells
            dmetrics.state_health(c.mask.cpu().numpy(), c.vel.cpu().numpy(),
                                  c.u.cpu().numpy(), state.rho.cpu().numpy(),
                                  c.mass.cpu().numpy(), met_counts,
                                  met_values, rank=0)
            self.device_metrics_last = (met_counts, met_values)
            self.device_metrics_pulls += 1
            self.device_cell_work_last = {
                "columns": list(dmetrics.CELL_COLUMNS),
                "cells": cellw, "per_rank": cellw_rank}
        else:
            self.device_metrics_last = None
            self.device_cell_work_last = None
        self.state = state
        if self.rebin_each_cycle:
            with tr.span("rebin", units=nreal):
                self._rebin_state()
        self.particle_updates += updates
        self.global_equiv_updates += nsub * nreal
        self.substeps += nsub
        return {
            "t": float(self.state.time),
            "dt_max": dt_max_c,
            "depth": depth,
            "substeps": nsub,
            "force_substeps": force_substeps + 1,   # interior + final
            "bin_hist": hist,
            "updates": updates,
            "global_equiv_updates": nsub * nreal,
            "pair_tasks": pair_tasks,
            "global_equiv_pair_tasks": nsub * npairs,
        }

    def run(self, ncycles: int) -> Dict[str, list]:
        log: Dict[str, list] = {"t": [], "wall": [], "E": [], "px": [],
                                "depth": [], "updates": []}
        for _ in range(ncycles):
            stats = self.run_cycle()
            e, p = self.diagnostics()
            log["t"].append(stats["t"])
            log["wall"].append(stats["wall"])
            log["E"].append(e)
            log["px"].append(p[0])
            log["depth"].append(stats["depth"])
            log["updates"].append(stats["updates"])
        return log

    def diagnostics(self) -> Tuple[float, np.ndarray]:
        """(total energy, total momentum) over real particles."""
        return diagnostics(self.state.cells)
