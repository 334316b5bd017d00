"""Distributed SPH engine: graph-partitioned cells and two halo exchanges a
step, with the ranks stacked on one device.

Port of ``repro.sph.distributed``, the paper's §3.2 + §3.3 pipeline:

1. The cell graph (task costs projected onto cells, ``build_taskgraph``) is
   partitioned by the multilevel partitioner (``core.decompose_cells``):
   *work*, not data, is balanced.
2. Each rank owns its cells; a pair task spanning a cut is **duplicated on
   both sides** (the paper's Fig. 2), each side summing only into its own
   receivers.
3. Remote cells arrive by a halo exchange, twice a step as in the paper:
   positions before the density loop, densities (ρ, P, Ω, c_s, v) before
   the force loop.

The reference runs one rank per device under ``shard_map``. Here the ranks
are a leading dimension of every tensor on one device: rank d's K owned
cell slots are rows d·K … d·K + K − 1 of an ``(ndev·K, C, …)`` tensor, the
layout of the reference's ``residency="device"`` path. The exchanges
become index copies over that stacked axis:

* ``halo="allgather"``: every rank's export buffer is one row block of an
  ``(ndev·B, C, …)`` tensor, which is the reference's ``all_gather``
  flattened; each rank's imports are rows of it (``import_flat``).
* ``halo="ring"``: ``ring_rounds`` rounds of ``torch.roll(windows, 1,
  dims=0)`` over the ``(ndev, B, C, …)`` windows, the reference's
  ``lax.ppermute`` with ``ring_perm`` (i → i + 1); in round r rank d keeps
  the rows ``ring_pick[d, r]`` names.

Both are copies multiplied by 1.0 or 0.0, so the two schemes give the same
bits. The pair loops launch the Hopper pair kernels once each for all
ranks' plan entries (``density_pair_cells``, ``force_pair``) over the
ranks' extended arrays (K owned + Bi halo rows each) and keep each entry's
i-side; the j-side is computed and discarded (a one-sided launch is later
work). The per-rank sums add each owned slot's entries in plan order from
+0 through a one-sided incoming table (``cellgrid.gather_table``), with no
atomics, so a run repeats bit for bit. Multi-GPU ranks (NCCL) are not
ported: every rank lives on the one device.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import CostModel, decompose_cells
from ..device import DeviceLike, resolve_device, synchronize
from .cellgrid import GridSpec, PairList, ParticleCells, gather_table
from .engine import SPHConfig, build_taskgraph, diagnostics, f32, \
    host_array, periodic_wrap
from .physics import ghost_update


# ------------------------------------------------------------------- plan
@dataclass
class DistPlan:
    """Host-side (numpy) distribution plan for one decomposition."""
    ndev: int
    K: int                     # owned cell slots per device
    B: int                     # export buffer slots per device
    Bi: int                    # import buffer slots per device
    Pmax: int                  # pair entries per device
    assignment: np.ndarray     # (ncells,) -> device
    storage: np.ndarray        # (ncells,) -> owned slot on owner device
    # per-device arrays (leading dim ndev):
    export_slots: np.ndarray   # (ndev, B) local slot to export (0 pad)
    export_valid: np.ndarray   # (ndev, B) 1/0
    import_flat: np.ndarray    # (ndev, Bi) src_dev * B + src_slot (0 pad)
    import_valid: np.ndarray   # (ndev, Bi)
    pair_recv: np.ndarray      # (ndev, Pmax) receiver local slot
    pair_src: np.ndarray       # (ndev, Pmax) source ext slot (< K local, >= K halo)
    pair_shift: np.ndarray     # (ndev, Pmax, 3)
    pair_w: np.ndarray         # (ndev, Pmax) 1/0 validity
    ring_rounds: int = 0       # max ring distance (for halo="ring")
    ring_pick: Optional[np.ndarray] = None  # (ndev, R, Bi) slot in window or -1


def build_dist_plan(ncells: int, pairs: PairList, assignment: np.ndarray,
                    ndev: int) -> DistPlan:
    """The reference's plan, array for array, from the pair list (host
    arrays or tensors on any device) and the cell → rank assignment."""
    assignment = np.asarray(assignment, dtype=np.int64)
    ci = host_array(pairs.ci).astype(np.int64)
    cj = host_array(pairs.cj).astype(np.int64)
    shift = host_array(pairs.shift).astype(np.float32)

    # owned slots, in cell order
    storage = np.zeros(ncells, dtype=np.int64)
    counts = np.zeros(ndev, dtype=np.int64)
    for c in range(ncells):
        d = assignment[c]
        storage[c] = counts[d]
        counts[d] += 1
    K = int(counts.max())

    imports: List[Dict[int, int]] = [dict() for _ in range(ndev)]  # cell->idx
    exports: List[Dict[int, int]] = [dict() for _ in range(ndev)]
    entries: List[List[Tuple[int, int, np.ndarray]]] = [[] for _ in range(ndev)]

    def halo_index(dev: int, cell: int) -> int:
        if cell not in imports[dev]:
            imports[dev][cell] = len(imports[dev])
        src = int(assignment[cell])
        if cell not in exports[src]:
            exports[src][cell] = len(exports[src])
        return imports[dev][cell]

    for a, b, s in zip(ci, cj, shift):
        a, b = int(a), int(b)
        da, db = int(assignment[a]), int(assignment[b])
        if a == b:
            entries[da].append((storage[a], storage[a], s))
            continue
        if da == db:
            entries[da].append((storage[a], storage[b], s))
            entries[da].append((storage[b], storage[a], -s))
        else:
            ha = halo_index(da, b)   # device da imports cell b
            hb = halo_index(db, a)   # device db imports cell a
            entries[da].append((storage[a], -1 - ha, s))      # mark halo
            entries[db].append((storage[b], -1 - hb, -s))

    B = max((len(e) for e in exports), default=0)
    B = max(B, 1)
    Bi = max((len(i) for i in imports), default=0)
    Bi = max(Bi, 1)
    Pmax = max((len(e) for e in entries), default=1)
    Pmax = max(Pmax, 1)

    export_slots = np.zeros((ndev, B), dtype=np.int32)
    export_valid = np.zeros((ndev, B), dtype=np.float32)
    for d in range(ndev):
        for cell, idx in exports[d].items():
            export_slots[d, idx] = storage[cell]
            export_valid[d, idx] = 1.0

    import_flat = np.zeros((ndev, Bi), dtype=np.int32)
    import_valid = np.zeros((ndev, Bi), dtype=np.float32)
    import_src_dev = np.zeros((ndev, Bi), dtype=np.int32)
    for d in range(ndev):
        for cell, idx in imports[d].items():
            src = int(assignment[cell])
            slot = exports[src][cell]
            import_flat[d, idx] = src * B + slot
            import_src_dev[d, idx] = src
            import_valid[d, idx] = 1.0

    pair_recv = np.zeros((ndev, Pmax), dtype=np.int32)
    pair_src = np.zeros((ndev, Pmax), dtype=np.int32)
    pair_shift = np.zeros((ndev, Pmax, 3), dtype=np.float32)
    pair_w = np.zeros((ndev, Pmax), dtype=np.float32)
    for d in range(ndev):
        for p, (r, s_idx, s) in enumerate(entries[d]):
            pair_recv[d, p] = r
            pair_src[d, p] = (K + (-1 - s_idx)) if s_idx < 0 else s_idx
            pair_shift[d, p] = s
            pair_w[d, p] = 1.0

    # ring schedule: round r delivers the window of device (d - r) mod ndev
    R = 0
    for d in range(ndev):
        for idx in range(Bi):
            if import_valid[d, idx] > 0:
                dist = (d - int(import_src_dev[d, idx])) % ndev
                R = max(R, dist)
    ring_pick = np.full((ndev, max(R, 1), Bi), -1, dtype=np.int32)
    for d in range(ndev):
        for idx in range(Bi):
            if import_valid[d, idx] > 0:
                src = int(import_src_dev[d, idx])
                dist = (d - src) % ndev
                if dist >= 1:
                    slot = import_flat[d, idx] - src * B
                    ring_pick[d, dist - 1, idx] = slot

    return DistPlan(ndev=ndev, K=K, B=B, Bi=Bi, Pmax=Pmax,
                    assignment=assignment, storage=storage,
                    export_slots=export_slots, export_valid=export_valid,
                    import_flat=import_flat, import_valid=import_valid,
                    pair_recv=pair_recv, pair_src=pair_src,
                    pair_shift=pair_shift, pair_w=pair_w,
                    ring_rounds=R, ring_pick=ring_pick)


def _owned_rows(plan: DistPlan, device) -> torch.Tensor:
    """Each cell's row in the stacked (ndev·K, …) layout."""
    return torch.from_numpy(plan.assignment * plan.K + plan.storage).to(
        device)


def scatter_to_devices(cells: ParticleCells, plan: DistPlan) -> ParticleCells:
    """(ncells, C, …) → (ndev·K, C, …) stacked storage layout, on the cells'
    device; slots no cell owns are zero."""
    dst = _owned_rows(plan, cells.pos.device)

    def place(a):
        out = a.new_zeros((plan.ndev * plan.K,) + a.shape[1:])
        return out.index_copy_(0, dst, a)

    return ParticleCells(*(place(a) for a in cells))


def gather_from_devices(cells: ParticleCells, plan: DistPlan,
                        ncells: int) -> ParticleCells:
    """(ndev·K, C, …) stacked layout → (ncells, C, …) in cell order."""
    src = _owned_rows(plan, cells.pos.device)
    return ParticleCells(*(a.index_select(0, src) for a in cells))


# --------------------------------------------------------------- device code
class DistTables(NamedTuple):
    """A plan's index tables on the device, for the stacked layout: rank
    d's owned slot s is row d·K + s of the local arrays, and row
    d·(K + Bi) + s of the extended ones, whose rows d·(K + Bi) + K + h
    hold its halo slot h."""
    ndev: int
    K: int
    B: int
    Bi: int
    rounds: int                  # ring rounds
    export_rows: torch.Tensor    # (ndev·B,) int64 local row to export
    export_valid: torch.Tensor   # (ndev·B,) f32 1/0
    import_rows: torch.Tensor    # (ndev·Bi,) int64 row of the gathered exports
    import_valid: torch.Tensor   # (ndev·Bi,) f32 1/0
    ring_take: torch.Tensor      # (R, ndev·Bi) int64 row of the rolled windows
    ring_sel: torch.Tensor       # (R, ndev·Bi) bool
    recv: torch.Tensor           # (ndev·Pmax,) int32 extended receiver row
    src: torch.Tensor            # (ndev·Pmax,) int32 extended source row
    shift: torch.Tensor          # (ndev·Pmax, 3) f32
    w: torch.Tensor              # (ndev·Pmax,) f32 1/0
    sums: Tuple[torch.Tensor, torch.Tensor]   # one-sided incoming table


def dist_tables(plan: DistPlan, device) -> DistTables:
    """The plan's index tables for the stacked layout, on ``device``.

    The sums' table lists, for each owned slot, its valid entries in plan
    order. Padding entries (``pair_w = 0``) are left out of it, as
    ``cellgrid.incoming_table`` leaves out masked padding: each repeats
    slot 0's self entry (receiver 0, source 0, no shift), so its x·0 is ±0
    (which leaves a sum from +0 as it is) or NaN only where that self
    entry has already made slot 0's sum NaN."""
    nd, K, B, Bi, P = plan.ndev, plan.K, plan.B, plan.Bi, plan.Pmax
    dev = np.arange(nd)[:, None]
    pick = plan.ring_pick
    valid = plan.pair_w > 0
    keys = (dev * K + plan.pair_recv)[valid]
    rows = (dev * P + np.arange(P)[None, :])[valid]
    ext = K + Bi

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return DistTables(
        ndev=nd, K=K, B=B, Bi=Bi, rounds=plan.ring_rounds,
        export_rows=t((dev * K + plan.export_slots).reshape(-1), torch.int64),
        export_valid=t(plan.export_valid.reshape(-1)),
        import_rows=t(plan.import_flat.reshape(-1), torch.int64),
        import_valid=t(plan.import_valid.reshape(-1)),
        ring_take=t((dev[:, None] * B + np.maximum(pick, 0)).transpose(
            1, 0, 2).reshape(pick.shape[1], -1), torch.int64),
        ring_sel=t((pick >= 0).transpose(1, 0, 2).reshape(
            pick.shape[1], -1)),
        recv=t((dev * ext + plan.pair_recv).reshape(-1), torch.int32),
        src=t((dev * ext + plan.pair_src).reshape(-1), torch.int32),
        shift=t(plan.pair_shift.reshape(-1, 3)),
        w=t(plan.pair_w.reshape(-1)),
        sums=tuple(t(a) for a in gather_table(keys, rows, nd * K, nd * P)))


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row vector (rows,) viewed to broadcast over ``like``'s
    trailing dimensions."""
    return v.reshape(v.shape[:1] + (1,) * (like.dim() - 1))


def _exchange(fields: Tuple[torch.Tensor, ...], t: DistTables, halo: str
              ) -> Tuple[torch.Tensor, ...]:
    """Halo exchange of per-cell fields over the stacked rank axis.

    ``fields`` are (ndev·K, C, …) each; returns each field's halo buffers,
    (ndev·Bi, C, …), rank d's in rows d·Bi … d·Bi + Bi − 1."""
    exports = [f.index_select(0, t.export_rows) * _bcast(t.export_valid, f)
               for f in fields]                          # (ndev·B, C, …)
    if halo == "allgather":
        return tuple(e.index_select(0, t.import_rows)
                     * _bcast(t.import_valid, e) for e in exports)
    if halo == "ring":
        halos = [e.new_zeros((t.ndev * t.Bi,) + e.shape[1:]) for e in exports]
        windows = [e.view((t.ndev, t.B) + e.shape[1:]) for e in exports]
        for r in range(t.rounds):
            # one ppermute round, i -> i + 1: rank d now holds d − r − 1's
            windows = [torch.roll(w, 1, dims=0) for w in windows]
            for i, w in enumerate(windows):
                got = w.reshape((t.ndev * t.B,) + w.shape[2:]).index_select(
                    0, t.ring_take[r])
                halos[i] = torch.where(_bcast(t.ring_sel[r], got), got,
                                       halos[i])
        return tuple(h * _bcast(t.import_valid, h) for h in halos)
    raise ValueError(f"unknown halo scheme {halo!r}")


def _extend(local: torch.Tensor, halo: torch.Tensor, t: DistTables
            ) -> torch.Tensor:
    """Each rank's K owned rows then its Bi halo rows: (ndev·(K+Bi), C, …)."""
    tail = local.shape[1:]
    return torch.cat([local.reshape((t.ndev, t.K) + tail),
                      halo.reshape((t.ndev, t.Bi) + tail)], 1).reshape(
        (t.ndev * (t.K + t.Bi),) + tail)


def _rank_sums(side: torch.Tensor, t: DistTables) -> torch.Tensor:
    """(ndev·Pmax, C, F) per-entry contributions → (ndev·K, C, F) per owned
    slot, each slot's entries added in plan order from +0."""
    from ..kernels.sph_pair.ops import table_sums
    return table_sums([side * _bcast(t.w, side)], t.sums, t.ndev * t.K)


def _pair_density(pos, h, mass, mask, t: DistTables, cfg: SPHConfig):
    """All ranks' density entries in one launch over the extended arrays;
    (rho, drho_dh, nngb) of every owned slot."""
    from ..kernels.sph_pair.kernel import density_pair_cells
    rho, drho, nngb, _, _, _ = density_pair_cells(
        pos, h, mass, mask, t.recv, t.src, t.shift, kernel=cfg.kernel)
    sums = _rank_sums(torch.stack([rho, drho, nngb], -1), t)
    return sums[..., 0], sums[..., 1], sums[..., 2]


def _force_blocks(fields, t: DistTables):
    """The force kernel's eighteen (ndev·Pmax, C[, 3]) blocks from its nine
    extended fields (pos, vel, h, press, rho, omega, cs, mass, mask):
    receivers' rows, then sources' rows with the image shift added to
    positions."""
    ri, rj = t.recv.long(), t.src.long()
    side_i = [a.index_select(0, ri) for a in fields]
    side_j = [a.index_select(0, rj) for a in fields]
    side_j[0] = side_j[0] + t.shift[:, None, :]
    return side_i + side_j


def _pair_force(fields, t: DistTables, cfg: SPHConfig):
    """All ranks' force entries in one launch over the nine extended fields
    of ``_force_blocks``; (dv, du) of every owned slot."""
    from ..kernels.sph_pair.kernel import force_pair
    dv, du, _, _ = force_pair(*_force_blocks(fields, t), kernel=cfg.kernel,
                              alpha_visc=cfg.alpha_visc)
    sums = _rank_sums(torch.cat([dv, du[..., None]], -1), t)
    return sums[..., :3], sums[..., 3]


def _safe_halo_fields(h_rho, h_om):
    """Halo padding slots must stay division-safe."""
    h_rho = torch.where(h_rho <= 0, 1.0, h_rho)
    h_om = torch.where(torch.abs(h_om) < 1e-4, 1.0, h_om)
    return h_rho, h_om


def make_dist_step(plan: DistPlan, cfg: SPHConfig, box: float, *,
                   halo: str = "allgather", device: DeviceLike = None):
    """The distributed KDK step and the force initialiser, as functions of
    the stacked state on ``device``:

    * ``step(cells, accel, dudt, dt) -> (cells, accel, dudt, rho)``, ``dt``
      a 0-d float32 tensor;
    * ``init(cells) -> (accel, dudt, rho)``.

    Each runs the two halo exchanges and one launch of each pair kernel.
    """
    if halo not in ("allgather", "ring"):
        raise ValueError(f"unknown halo scheme {halo!r}")
    t = dist_tables(plan, resolve_device(device))

    def forces(local: ParticleCells):
        # ---- phase 1: ship positions, run density (paper: 1st comm)
        shipped = (local.pos, local.h, local.mass, local.mask)
        pos, h, mass, mask = (_extend(f, g, t) for f, g in
                              zip(shipped, _exchange(shipped, t, halo)))
        rho, drho_dh, _ = _pair_density(pos, h, mass, mask, t, cfg)
        rho = torch.where(local.mask > 0, rho, 1.0)
        drho_dh = torch.where(local.mask > 0, drho_dh, 0.0)
        press, omega, cs = ghost_update(rho, drho_dh, local.u, local.h,
                                        gamma=cfg.gamma)
        press = torch.where(local.mask > 0, press, 0.0)

        # ---- phase 2: ship densities, run forces (paper: 2nd comm)
        h_vel, h_rho, h_press, h_om, h_cs = _exchange(
            (local.vel, rho, press, omega, cs), t, halo)
        h_rho, h_om = _safe_halo_fields(h_rho, h_om)
        dv, du = _pair_force(
            (pos, _extend(local.vel, h_vel, t), h,
             _extend(press, h_press, t), _extend(rho, h_rho, t),
             _extend(omega, h_om, t), _extend(cs, h_cs, t), mass, mask),
            t, cfg)
        mask3 = local.mask[..., None]
        return dv * mask3, du * local.mask, rho

    def step(cells: ParticleCells, accel, dudt, dt):
        mask3 = cells.mask[..., None]
        v_half = cells.vel + 0.5 * dt * accel
        u_half = torch.clamp_min(cells.u + 0.5 * dt * dudt, 1e-12)
        pos = periodic_wrap(cells.pos + dt * v_half * mask3, box)
        cells = cells._replace(pos=pos, vel=v_half, u=u_half)
        dv, du, rho = forces(cells)
        v_new = cells.vel + 0.5 * dt * dv
        u_new = torch.clamp_min(u_half + 0.5 * dt * du, 1e-12)
        cells = cells._replace(vel=v_new, u=u_new)
        return cells, dv, du, rho

    return step, forces


# ------------------------------------------------------------------ driver
class DistSimulation:
    """Graph-partitioned SPH driver, ``ranks`` ranks stacked on one device.

    ``taskgraph`` is the task graph the decomposition partitioned;
    ``setup_s`` holds the host seconds of the decomposition's three steps
    (``taskgraph``, ``decompose``, ``plan``).
    """

    def __init__(self, cells: ParticleCells, pairs: PairList,
                 spec: GridSpec, *, ranks: int = 1,
                 cfg: SPHConfig = SPHConfig(), halo: str = "allgather",
                 cost_model: Optional[CostModel] = None, seed: int = 0,
                 device: DeviceLike = None):
        if type(self) is DistSimulation:
            warnings.warn(
                "constructing DistSimulation directly is deprecated; use "
                "repro_torch.sph.build_simulation(SimulationSpec(...)) "
                "(integrator='global', backend='distributed')",
                DeprecationWarning, stacklevel=2)
        if int(ranks) < 1:
            raise ValueError(f"ranks must be >= 1, got {ranks!r}")
        self.device = resolve_device(device)
        self.spec = spec
        self.cfg = cfg
        self.halo = halo
        ndev = int(ranks)
        occupancy = host_array(cells.mask.sum(1))
        t0 = time.perf_counter()
        self.taskgraph = build_taskgraph(spec, pairs, occupancy, cost_model)
        t1 = time.perf_counter()
        self.decomp = decompose_cells(self.taskgraph, spec.ncells, ndev,
                                      seed=seed)
        t2 = time.perf_counter()
        self.plan = build_dist_plan(spec.ncells, pairs,
                                    self.decomp.assignment, ndev)
        self.setup_s = {"taskgraph": t1 - t0, "decompose": t2 - t1,
                        "plan": time.perf_counter() - t2}
        self.dcells = scatter_to_devices(
            ParticleCells(*(a.to(self.device) for a in cells)), self.plan)
        self._step, self._init = make_dist_step(self.plan, cfg, spec.box,
                                                halo=halo,
                                                device=self.device)
        self.accel, self.dudt, self.rho = self._init(self.dcells)
        # the device-metrics carry is the observability slice's (not ported)
        self.device_metrics_enabled = False
        self.device_metrics_last = None
        self.device_metrics_pulls = 0
        self.device_cell_work_last = None

    def step(self, dt: float):
        self.dcells, self.accel, self.dudt, self.rho = self._step(
            self.dcells, self.accel, self.dudt, f32(dt, self.device))
        synchronize(self.device)

    def gather_cells(self) -> ParticleCells:
        return gather_from_devices(self.dcells, self.plan, self.spec.ncells)

    def diagnostics(self) -> Tuple[float, np.ndarray]:
        """(total energy, total momentum) over real particles."""
        return diagnostics(self.gather_cells())
