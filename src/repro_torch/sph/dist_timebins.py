"""Distributed hierarchical time-bin integration with activity-aware halos.

Port of ``repro.sph.dist_timebins`` (its host residency and host schedule):
per-particle power-of-two time-steps (``timebins.py``) over a
graph-partitioned cell decomposition (``core.decompose``), where halo
exchanges are **activity-aware** — at each sub-step only the cut cells with
bins active at that sub-step contribute to the export buffer. An inactive
boundary cell's replica stays valid on the importing rank because drift is
elementwise: the importer drifts its halo copies with exactly the owner's
arithmetic, so data only has to ship when a kick changes it. This is the
time-axis extension of SWIFT's halo protocol (§3.3): the volume a sub-step
ships tracks the *active* fraction of the cut, not its size.

One force sub-step on each rank (two comm phases, as the paper's step):

1. density phase (``timebins._substep_density_phase``) over the rank's
   activity-restricted pair list → fresh rho/omega/press/cs for active
   particles;
2. **exchange 1**: owners ship (rho, omega, press, cs) of *active* cut
   cells — the importer's values for those rows are partial sums and are
   overwritten;
3. force phase (``timebins._substep_force_phase``) → kick + bin deepening;
4. **exchange 2**: owners ship the kicked state (vel, u, bins, t_start,
   accel, dudt) of active cut cells so replicas stay current.

Cut pair tasks are duplicated on both ranks (the paper's Fig. 2): every
rank's pair list covers all pairs touching its owned cells, in global pair
order, and its incoming table sums i-sides then j-sides, each in pair
order (``kernels/sph_pair/ops.py``), so an owned cell adds the same
contributions in the same order as the single-host ladder — the engine is
bit for bit ``TimeBinSimulation`` for any rank count and wire.

Two residencies (``residency="host" | "device"``):

* **host** — a list of per-rank ``TimeBinState``s, each of ``(K + H, C,
  …)`` tensors on the device (owned rows, then halo replicas), with one
  call of each phase per rank — so each rank's density and force phases
  launch the two pair kernels once each. The wire is a pluggable
  **transport** (``transport="host" | "collective"``): ``HostTransport``
  copies rows through numpy, ``CollectiveTransport``
  (``sph/collectives.py``) does the same copies on the device over the
  stacked ranks. Both are pure row copies and give the same bits.
* **device** (collective wire) — the ranks' extended states stacked as
  one ``(nranks, K + H, C, …)`` tensor per field
  (:class:`~repro_torch.distributed.transport.ResidentBuffers`), on the
  device for the whole cycle, and one fused program per force sub-step
  (``collectives.build_fused_substep_program``) over all ranks: one launch
  of each pair kernel a sub-step. Each rank's pair table is padded to one
  bucket and its incoming table stacked as a fleet lane's
  (``cellgrid.stack_incoming``), so each owned cell adds the same
  contributions in the same order as at host residency: the two
  residencies are bit for bit the same. Inside a cycle only control moves
  between host and device — index tables, the per-rank ``changed`` flags,
  and the ``bins`` rows of a deepening — and the transfer probe records
  every byte.

Two schedules at device residency (``schedule="host" | "device"``):

* **host** — the host plans each cycle and walks its ladder, building
  each sub-step's tables from its mirror of ``bins`` (above);
* **device** — whole segments of ``segment_cycles`` cycles: the first
  cycle is planned by the host, each further one on the device
  (``collectives.build_plan_program``), and each cycle runs as one
  program (``collectives.build_cycle_scan_program``) that derives its
  ladder from the resident ``bins`` over static full-touch tables,
  uploaded once a segment. Between that upload and one pull of every
  cycle's counters, metrics rows and flags at the segment's end, the host
  reads nothing. If a health sentinel, a cell crossing or the ladder's
  capacity tripped, the pre-segment state comes back and the segment
  replays on the host schedule (``segment_aborts``, ``replayed``): the
  two schedules give the same bits, so a replay is only slower.

Repartitioning uses per-rank **bin occupancy**: the decomposition is
retriggered when the time-averaged active work per rank
(``core.decompose.timebin_node_weights``) drifts out of balance, and the
new partition is computed from the cycle-averaged task costs.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import CostModel, decompose_cells
from ..core.decompose import timebin_node_weights
from ..device import synchronize
from ..distributed.transport import (RESIDENCIES, TRANSPORTS, BucketPolicy,
                                     CompileProbe, ResidentBuffers,
                                     ShipSlots, TransferProbe, make_transport,
                                     next_pow2, pack_allgather, pack_rounds)
from ..observability import device_metrics as dmetrics
from .cellgrid import (PairList, ParticleCells, incoming_table,
                       make_pair_list, stack_incoming)
from .collectives import (_EX1_FIELDS, _EX2_FIELDS,
                          build_cycle_scan_program,
                          build_fused_substep_program, build_plan_program)
from .engine import SPHConfig, build_taskgraph, f32, host_array
from .timebins import (STATE_AUX_FIELDS, STATE_CELL_FIELDS,
                       TimeBinSimulation, TimeBinState, _final_force_phase,
                       _substep_density_phase, _substep_force_phase,
                       active_level, cell_bin_histogram,
                       mass_weighted_mean_u, substep_active_mask)

_PAD_H = 1e-6          # padded-slot smoothing length (division-safe)


# ------------------------------------------------------------------ rank plan
@dataclass
class RankPlan:
    """Host-side plan of one decomposition: who owns what, who imports what.

    Extended row layout per rank: rows [0, K) hold owned cells (global cell
    order), rows [K, K+H) hold halo replicas; both padded uniformly across
    the ranks.
    """
    nranks: int
    K: int                              # owned rows per rank (padded max)
    H: int                              # halo rows per rank (padded max)
    assignment: np.ndarray              # (ncells,) -> rank
    owned: List[np.ndarray]             # per rank: global cell ids, in order
    halo: List[np.ndarray]              # per rank: imported global cell ids
    ext_row: np.ndarray                 # (nranks, ncells) cell -> ext row (-1)
    # cut cells: cell -> (owner rank, owner ext row, [(imp rank, imp row)])
    cut: Dict[int, Tuple[int, int, List[Tuple[int, int]]]] = \
        field(default_factory=dict)
    # per-rank global-pair membership and ext-index maps
    touch: List[np.ndarray] = field(default_factory=list)   # (npairs,) bool
    ci_ext: List[np.ndarray] = field(default_factory=list)  # (npairs,) int32
    cj_ext: List[np.ndarray] = field(default_factory=list)  # (npairs,) int32

    @property
    def cut_slots(self) -> int:
        """Total (cell, importer) slots across the cut = full-boundary
        export volume of one exchange."""
        return sum(len(imps) for _, _, imps in self.cut.values())

    def export_edges(self) -> List[Tuple[int, int]]:
        """Directed rank-to-rank edges of the cut (the comm planner's
        export edge list — input to ``ppermute_rounds``)."""
        edges = {(o, ir) for _, (o, _, imps) in self.cut.items()
                 for (ir, _) in imps}
        return sorted(edges)

    def ship_slots(self, cells_due: List[int]) -> ShipSlots:
        """This sub-step's exchange: owner row → importer rows per edge."""
        slots = ShipSlots()
        for c in cells_due:
            o, orow, imps = self.cut[c]
            for (ir, irow) in imps:
                slots.add(o, ir, orow, irow)
        return slots


def build_rank_plan(assignment: np.ndarray, ci: np.ndarray, cj: np.ndarray,
                    nranks: Optional[int] = None) -> RankPlan:
    """Ownership + halo-import plan over the global cell-pair list."""
    assignment = np.asarray(assignment, dtype=np.int64)
    ncells = len(assignment)
    if nranks is None:
        nranks = int(assignment.max()) + 1 if ncells else 1
    owned = [np.nonzero(assignment == r)[0] for r in range(nranks)]
    K = max((len(o) for o in owned), default=1)
    K = max(K, 1)

    imports: List[Dict[int, int]] = [dict() for _ in range(nranks)]
    for a, b in zip(np.asarray(ci), np.asarray(cj)):
        a, b = int(a), int(b)
        ra, rb = int(assignment[a]), int(assignment[b])
        if ra == rb:
            continue
        if b not in imports[ra]:
            imports[ra][b] = len(imports[ra])
        if a not in imports[rb]:
            imports[rb][a] = len(imports[rb])
    H = max((len(i) for i in imports), default=0)

    halo = []
    ext_row = np.full((nranks, ncells), -1, dtype=np.int64)
    for r in range(nranks):
        for slot, c in enumerate(owned[r]):
            ext_row[r, c] = slot
        hl = np.empty(len(imports[r]), dtype=np.int64)
        for c, idx in imports[r].items():
            hl[idx] = c
            ext_row[r, c] = K + idx
        halo.append(hl)

    cut: Dict[int, Tuple[int, int, List[Tuple[int, int]]]] = {}
    for r in range(nranks):
        for c, idx in imports[r].items():
            o = int(assignment[c])
            if c not in cut:
                cut[c] = (o, int(ext_row[o, c]), [])
            cut[c][2].append((r, K + idx))

    plan = RankPlan(nranks=nranks, K=K, H=H, assignment=assignment,
                    owned=owned, halo=halo, ext_row=ext_row, cut=cut)
    ci_np = np.asarray(ci, dtype=np.int64)
    cj_np = np.asarray(cj, dtype=np.int64)
    for r in range(nranks):
        touch = (assignment[ci_np] == r) | (assignment[cj_np] == r)
        cie = np.where(touch, ext_row[r, ci_np], 0).astype(np.int32)
        cje = np.where(touch, ext_row[r, cj_np], 0).astype(np.int32)
        plan.touch.append(touch)
        plan.ci_ext.append(cie)
        plan.cj_ext.append(cje)
    return plan


def halo_export_schedule(cell_bins: np.ndarray, plan: RankPlan, depth: int
                         ) -> Dict[str, np.ndarray]:
    """Static per-sub-step export volumes over one 2**depth cycle.

    ``cell_bins`` is each cell's deepest occupied bin (−1 empty). A cut cell
    ships to each of its importers when active (bin ≥ level of the
    sub-step); the full-boundary baseline ships every cut cell at every
    force sub-step. Pure host arithmetic — the fast check that
    activity-aware halos beat the baseline, without running the engine.
    """
    nsub = 1 << depth
    active_slots = np.zeros(nsub, dtype=np.int64)
    full_slots = np.zeros(nsub, dtype=np.int64)
    bins = np.asarray(cell_bins)
    for n in range(1, nsub + 1):
        level = 0 if n == nsub else active_level(n, depth)
        any_active = bool((bins >= level).any())
        if not any_active:
            continue
        full = plan.cut_slots
        act = sum(len(imps) for c, (_, _, imps) in plan.cut.items()
                  if bins[c] >= level)
        active_slots[n - 1] = act
        full_slots[n - 1] = full
    return {"active": active_slots, "full": full_slots}


# ------------------------------------------------------------------- engine
class DistTimeBinSimulation(TimeBinSimulation):
    """Rank-partitioned multi-dt engine (the distributed ``timebin`` one).

    Inherits the cycle planner, bin math and host bookkeeping from
    :class:`TimeBinSimulation`; overrides the sub-step ladder to run on
    per-rank extended (owned ⊕ halo) states with the two activity-aware
    exchanges described in the module docstring. Export volumes are
    accumulated in ``halo_exported_slots`` / ``halo_full_slots``;
    ``halo_log`` holds the *latest cycle's* per-sub-step breakdown.
    ``setup_s`` holds the host seconds of the decomposition (task graph,
    partition, rank plan), ``repartition_seconds`` those of each
    repartition.
    """

    def __init__(self, pos, vel, mass, u, h, *, box: float,
                 cfg: SPHConfig = SPHConfig(),
                 nranks: int = 1,
                 activity_aware: bool = True,
                 repartition_threshold: float = 1.5,
                 cost_model: Optional[CostModel] = None,
                 seed: int = 0,
                 transport: str = "host",
                 transport_mode: str = "auto",
                 residency: str = "host",
                 schedule: str = "host",
                 segment_cycles: int = 1,
                 **kw):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, "
                             f"got {transport!r}")
        if residency not in RESIDENCIES:
            raise ValueError(f"residency must be one of {RESIDENCIES}, "
                             f"got {residency!r}")
        if residency == "device":
            if transport != "collective":
                raise ValueError(
                    "residency='device' fuses the exchange into the "
                    "sub-step programs and therefore requires "
                    "transport='collective' (the host wire has no device "
                    "mesh to keep the state resident on)")
            if cfg.use_pallas:
                raise ValueError(
                    "residency='device' compiles the vmap pair phases "
                    "into the fused shard_map programs; use_pallas=True "
                    "is not supported on this path yet")
        if schedule not in ("host", "device"):
            raise ValueError(f"schedule must be 'host' or 'device', "
                             f"got {schedule!r}")
        if schedule == "device" and residency != "device":
            raise ValueError(
                "schedule='device' derives the sub-step ladder inside the "
                "compiled segment program from the device-resident bins "
                "array and therefore requires residency='device'")
        if int(segment_cycles) < 1:
            raise ValueError("segment_cycles must be >= 1")
        if int(segment_cycles) > 1 and schedule != "device":
            raise ValueError(
                "segment_cycles > 1 fuses consecutive cycles into one "
                "device segment and requires schedule='device'")
        self.residency = residency
        self.schedule = schedule
        self.segment_cycles = int(segment_cycles)
        self.nranks = int(nranks)
        self.activity_aware = bool(activity_aware)
        self.repartition_threshold = float(repartition_threshold)
        self._cost_model = cost_model or CostModel(rates={})
        self._seed = seed
        self.transport_kind = transport
        super().__init__(pos, vel, mass, u, h, box=box, cfg=cfg, **kw)
        # the program-signature probe: every phase program of this engine
        # is registered (see distributed/transport.CompileProbe)
        self.probe = CompileProbe()
        self._drift = self.probe.register("drift", self._drift)
        self._start = self.probe.register("cycle_start", self._start)
        self._sub_density_p = self.probe.register(
            "density", lambda *a: self._sub_density(*a, cfg=cfg))
        self._sub_force_p = self.probe.register(
            "force", lambda *a: _substep_force_phase(*a, cfg=cfg))
        self._final_density_p = self.probe.register(
            "final_density", lambda *a: self._final_density(*a, cfg=cfg))
        self._final_force_p = self.probe.register(
            "final_force", lambda *a: _final_force_phase(*a, cfg=cfg))
        self.program_keys: set = set()      # (program, level, bucket) seen
        self._transport = make_transport(transport, nranks=self.nranks,
                                         probe=self.probe,
                                         mode=transport_mode)
        self._plan_cache: Optional[RankPlan] = None
        self._plan_cache_key: Optional[bytes] = None
        self._rows_cache: Optional[Tuple[RankPlan, List[Tuple[
            torch.Tensor, ...]]]] = None
        self.setup_s: Dict[str, float] = {}
        self._assignment = self._initial_assignment()
        t0 = time.perf_counter()
        self._get_plan()
        self.setup_s["plan"] = time.perf_counter() - t0
        self.repartitions = 0
        self.repartition_seconds: List[float] = []
        self.halo_exported_slots = 0
        self.halo_full_slots = 0
        self.halo_log: List[Dict[str, float]] = []
        # intra-cycle host↔device ledger (the device residency's proof of
        # residency) and its count of mid-cycle bins-mirror refreshes
        self.transfers = TransferProbe()
        self.bins_refreshes = 0
        # fused-program buckets never shrink: demand dips must not mint
        # new input signatures (growth still adds one, once per
        # power-of-two crossing per stream)
        self._fused_buckets = BucketPolicy(min_bucket=8,
                                           shrink_patience=10 ** 9)
        self._resident_rows_cache: Optional[Tuple[RankPlan, Tuple[
            torch.Tensor, ...]]] = None
        # schedule="device": whole segments run as device programs;
        # run_cycle() pops one cycle's stats a call from this queue. A
        # segment aborts to the host schedule, bit for bit recoverably,
        # when a health sentinel, a crossing or the capacity flag trips.
        self._segment_queue: List[Dict] = []
        self.segments = 0
        self.segment_aborts = 0
        # the last segment's trip counts: health sentinels, crossed
        # particles, capacity overflows (any nonzero one aborted it)
        self.segment_flags_last: Optional[Dict[str, int]] = None
        # with sync_debug on a CUDA device, a segment's programs run under
        # torch.cuda.set_sync_debug_mode("error"): any host read raises
        self.sync_debug = False

    # ------------------------------------------------------- phase wrappers
    @staticmethod
    def _sub_density(state, pairs, pair_mask, level, wake_floor, *, cfg):
        active = substep_active_mask(state, level, wake_floor)
        rho, omega, press, cs = _substep_density_phase(
            state, pairs, pair_mask, active, cfg=cfg)
        return active, rho, omega, press, cs

    @staticmethod
    def _final_density(state, pairs, pair_mask, *, cfg):
        active = state.cells.mask
        return _substep_density_phase(state, pairs, pair_mask, active,
                                      cfg=cfg)

    # ---------------------------------------------------------- partitioning
    def _initial_assignment(self) -> np.ndarray:
        """The task graph's cells partitioned over the ranks; its host
        seconds go to ``setup_s`` (``taskgraph``, ``decompose``)."""
        if self.nranks <= 1:
            return np.zeros(self.spec.ncells, dtype=np.int64)
        t0 = time.perf_counter()
        occ = self.state.cells.mask.sum(1).cpu().numpy().astype(np.int64)
        g = build_taskgraph(self.spec, self.pairs, occ, self._cost_model)
        t1 = time.perf_counter()
        dec = decompose_cells(g, self.spec.ncells, self.nranks,
                              seed=self._seed)
        self.setup_s.update(taskgraph=t1 - t0,
                            decompose=time.perf_counter() - t1)
        return np.asarray(dec.assignment, dtype=np.int64)

    def _maybe_repartition(self, bins_h: np.ndarray, mask_h: np.ndarray,
                           depth: int) -> None:
        """Per-rank bin-occupancy repartition trigger.

        The quantity balanced is the *time-averaged active work* per rank
        (``timebin_node_weights``): deep-bin (short-step) cells cost their
        rank every sub-step, shallow ones almost never. When the max/mean
        ratio exceeds the threshold, re-decompose with cycle-averaged task
        costs (``CostModel.timebin_units`` — send/recv weighted by
        activation frequency).
        """
        if self.nranks <= 1:
            return
        obb = cell_bin_histogram(bins_h, mask_h, depth + 1)
        w = timebin_node_weights(obb)
        rank_w = np.zeros(self.nranks)
        np.add.at(rank_w, self._assignment, w)
        mean = rank_w.mean()
        if mean <= 0 or rank_w.max() / mean <= self.repartition_threshold:
            return
        t0 = time.perf_counter()
        occ = (mask_h > 0).sum(axis=1).astype(np.int64)
        deep = (obb.shape[1] - 1 - np.argmax(obb[:, ::-1] > 0, axis=1))
        cb = np.where(obb.sum(axis=1) > 0, deep, -1)
        g = build_taskgraph(self.spec, self.pairs, occ, self._cost_model,
                            cell_bins=cb, occupancy_by_bin=obb,
                            time_average=True)
        dec = decompose_cells(g, self.spec.ncells, self.nranks,
                              seed=self._seed, occupancy_by_bin=obb)
        self._assignment = np.asarray(dec.assignment, dtype=np.int64)
        self.repartitions += 1
        self.repartition_seconds.append(time.perf_counter() - t0)

    # ------------------------------------------------------ scatter / gather
    _FILLS = {"pos": 0.0, "vel": 0.0, "mass": 0.0, "u": 0.0, "h": _PAD_H,
              "mask": 0.0, "accel": 0.0, "dudt": 0.0, "rho": 1.0,
              "omega": 1.0, "bins": 0, "t_start": 0.0}
    _CELL_FIELDS = STATE_CELL_FIELDS
    _AUX_FIELDS = STATE_AUX_FIELDS

    def _plan_rows(self, plan: RankPlan) -> List[Tuple[torch.Tensor, ...]]:
        """Per rank, on the device: (owned cells, their ext rows, halo
        cells, their ext rows) — the index tensors of scatter and
        gather, built once per plan."""
        if self._rows_cache is None or self._rows_cache[0] is not plan:
            dev = self.device
            T = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
            rows = []
            for r in range(plan.nranks):
                own, hl = plan.owned[r], plan.halo[r]
                rows.append((T(own), T(np.arange(len(own))), T(hl),
                             T(plan.K + np.arange(len(hl)))))
            self._rows_cache = (plan, rows)
        return self._rows_cache[1]

    def _scatter_state(self, plan: RankPlan) -> List[TimeBinState]:
        """Global mirror → per-rank extended TimeBinStates (device copies:
        owned rows, then halo rows, the rest padding)."""
        st = self.state
        fills = self._FILLS
        nrows = plan.K + plan.H
        states = []
        for own, own_at, hl, hl_at in self._plan_rows(plan):

            def ext(a, fill):
                out = torch.full((nrows,) + tuple(a.shape[1:]), fill,
                                 dtype=a.dtype, device=a.device)
                out.index_copy_(0, own_at, a.index_select(0, own))
                out.index_copy_(0, hl_at, a.index_select(0, hl))
                return out

            cells = ParticleCells(**{k: ext(getattr(st.cells, k), fills[k])
                                     for k in self._CELL_FIELDS})
            states.append(TimeBinState(
                cells=cells, time=st.time,
                **{k: ext(getattr(st, k), fills[k])
                   for k in self._AUX_FIELDS}))
        return states

    def _gather_state(self, plan: RankPlan, states: List[TimeBinState]
                      ) -> None:
        """Per-rank owned rows → global mirror (halo replicas discarded)."""
        st = self.state
        rows = self._plan_rows(plan)

        def gather(name, get):
            out = get(st).clone()
            for r, (own, own_at, _, _) in enumerate(rows):
                if len(own):
                    out.index_copy_(0, own, get(states[r]).index_select(
                        0, own_at))
            return out

        cells = ParticleCells(**{
            k: gather(k, lambda s, k=k: getattr(s.cells, k))
            for k in self._CELL_FIELDS})
        self.state = TimeBinState(
            cells=cells, time=states[0].time,
            **{k: gather(k, lambda s, k=k: getattr(s, k))
               for k in self._AUX_FIELDS})

    # ------------------------------------------------------------ rank plan
    def _get_plan(self) -> RankPlan:
        """The cycle's rank plan; cached per assignment (the pair list is
        static, so the plan only changes when the partition does)."""
        key = self._assignment.tobytes()
        if self._plan_cache is None or self._plan_cache_key != key:
            self._plan_cache = build_rank_plan(
                np.asarray(self._assignment), self._ci, self._cj,
                nranks=self.nranks)
            self._plan_cache_key = key
            self._transport.prepare(self._plan_cache.export_edges())
        return self._plan_cache

    # --------------------------------------------------------- pair subsets
    def _select_rank_pairs(self, plan: RankPlan,
                           active_cells: Optional[np.ndarray]
                           ) -> Tuple[List[np.ndarray], int]:
        """Per-rank live pair indices, in global pair order: the rank's
        touch set, restricted to pairs touching an active cell when given.
        """
        act = None
        if active_cells is not None:
            act = active_cells[self._ci] | active_cells[self._cj]
        idxs = []
        nmax = 1
        for r in range(plan.nranks):
            sel = plan.touch[r] if act is None else plan.touch[r] & act
            idx = np.nonzero(sel)[0]
            idxs.append(idx)
            nmax = max(nmax, len(idx))
        return idxs, nmax

    def _rank_pair_subsets(self, plan: RankPlan,
                           active_cells: Optional[np.ndarray]
                           ) -> Tuple[List[Tuple[PairList, torch.Tensor,
                                                 int]], int]:
        """All ranks' pair subsets, padded to one **shared** power-of-two
        bucket (the max across ranks). Padded entries repeat pair 0 with a
        zero mask and are left out of each rank's incoming table, which
        spans the rank's K + H extended rows."""
        idxs, nmax = self._select_rank_pairs(plan, active_cells)
        npad = next_pow2(nmax)
        nrows = plan.K + plan.H
        out = []
        for r in range(plan.nranks):
            idx = idxs[r]
            nlive = len(idx)
            idxp = np.concatenate(
                [idx, np.zeros(npad - nlive, dtype=idx.dtype)])
            pmask = np.zeros(npad, np.float32)
            pmask[:nlive] = 1.0
            sub = make_pair_list(plan.ci_ext[r][idxp], plan.cj_ext[r][idxp],
                                 self._shift[idxp], nrows, self.device,
                                 nlive=nlive)
            out.append((sub, torch.from_numpy(pmask).to(self.device), nlive))
        return out, npad

    # ------------------------------------------------------------ exchanges
    def _exchange_set(self, plan: RankPlan, active_cells: np.ndarray
                      ) -> List[int]:
        """Cut cells due for shipping this sub-step."""
        if not self.activity_aware:
            return list(plan.cut.keys())
        return [c for c in plan.cut if active_cells[c]]

    def transport_stats(self) -> Dict[str, object]:
        """Wire-level accounting of the active transport + program probe."""
        out = dict(self._transport.stats())
        out["compiles"] = self.probe.counts()
        out["program_keys"] = len(self.program_keys)
        out["residency"] = self.residency
        out["transfers"] = self.transfers.stats()
        out["bins_refreshes"] = self.bins_refreshes
        return out

    # -------------------------------------------------------------- cycling
    def run_cycle(self) -> Dict[str, float]:
        tr = self.tracer
        if tr.enabled:
            tr.ctx["cycle"] = self.cycle_index
            tr.ctx.pop("substep", None)
        if self.schedule == "device":
            # whole segments run at once; each call pops one cycle's stats
            if not self._segment_queue:
                with tr.timed("cycle") as seg:
                    self._segment_queue = self._run_segment()
                wall = seg.elapsed / max(len(self._segment_queue), 1)
                for s in self._segment_queue:
                    s["wall"] = wall
            stats = self._segment_queue.pop(0)
            if "_met" in stats:
                # the rows came in the segment's boundary pull (or a
                # replayed cycle's own pull): adopting them moves nothing
                self.device_metrics_last = stats.pop("_met")
                self.device_cell_work_last = stats.pop("_cellw", None)
                if not stats.get("replayed"):
                    self.device_metrics_pulls += 1
            self.cycle_index += 1
            return stats
        with tr.timed("cycle") as cyc:
            ctx = self._cycle_prologue()
            if self.residency == "device":
                body = self._cycle_substeps_device(ctx)
            else:
                body = self._cycle_substeps_host(ctx)
            stats = self._cycle_epilogue(ctx, body)
        if tr.enabled:
            tr.ctx.pop("substep", None)
        self.cycle_index += 1
        stats["wall"] = cyc.elapsed
        return stats

    def _cycle_prologue(self) -> Dict[str, object]:
        """Plan the cycle and open it on the global mirror."""
        tr = self.tracer
        t0 = tr.now() if tr.enabled else 0.0
        dt_max_c, depth = self._plan_cycle()
        nsub = 1 << depth
        cells = self.state.cells
        mask_host = cells.mask.cpu().numpy()
        nreal = int(mask_host.sum())
        bins_host = self.state.bins.cpu().numpy()
        m_h = (cells.mass * cells.mask).cpu().numpy()
        # the fixed-order tree fold of the single-host ladder
        u_floor = float(mass_weighted_mean_u(m_h, cells.u.cpu().numpy()))
        hist = np.bincount(bins_host[mask_host > 0], minlength=depth + 1)
        # opening half-kick on the global mirror, then scatter to ranks
        self.state = self._start(self.state, f32(dt_max_c, self.device))
        plan = self._get_plan()
        if tr.enabled:
            tr.fence(self.state.cells.pos)
            tr.record_all(range(plan.nranks), "plan", t0, units=nreal,
                          collective=1)
        return {"dt_max_c": dt_max_c, "depth": depth, "nsub": nsub,
                "dt_min": dt_max_c / nsub, "nreal": nreal,
                "bins_host": bins_host, "mask_host": mask_host,
                "u_floor": u_floor, "hist": hist, "plan": plan}

    def _cycle_epilogue(self, ctx: Dict[str, object],
                        body: Dict[str, int]) -> Dict[str, float]:
        """Close the cycle: repartition check, re-bin, counters, stats."""
        tr = self.tracer
        nsub, nreal = ctx["nsub"], ctx["nreal"]
        self._maybe_repartition(self.state.bins.cpu().numpy(),
                                self.state.cells.mask.cpu().numpy(),
                                ctx["depth"])
        if self.rebin_each_cycle:
            with tr.span("rebin", units=nreal):
                self._rebin_state()
        self.particle_updates += body["updates"]
        self.global_equiv_updates += nsub * nreal
        self.substeps += nsub
        self.halo_exported_slots += body["cycle_exported"]
        self.halo_full_slots += body["cycle_full"]
        return {
            "t": float(self.state.time),
            "dt_max": ctx["dt_max_c"],
            "depth": ctx["depth"],
            "substeps": nsub,
            "force_substeps": body["force_substeps"] + 1,
            "bin_hist": ctx["hist"],
            "updates": body["updates"],
            "global_equiv_updates": nsub * nreal,
            "pair_tasks": body["pair_tasks"],
            "global_equiv_pair_tasks": nsub * len(self._ci),
            "halo_exported_slots": body["cycle_exported"],
            "halo_full_slots": body["cycle_full"],
            "nranks": ctx["plan"].nranks,
            "residency": self.residency,
        }

    # ------------------------------------------------- device-metrics pull
    def _metrics_pull(self, counts, values, cells=None,
                      plan: Optional[RankPlan] = None) -> None:
        """Adopt one cycle's accumulated telemetry rows as
        ``device_metrics_last`` — one ledgered boundary transfer a cycle.
        The device residency's per-cell rows (``cells``, stacked extended
        rows) ride in the same transfer and are folded onto global cells
        through the plan's row maps into ``device_cell_work_last``."""
        counts_h = host_array(counts)
        values_h = host_array(values)
        nbytes = counts_h.nbytes + values_h.nbytes
        if cells is not None and plan is not None:
            cells_h = host_array(cells)
            nbytes += cells_h.nbytes
            self.device_cell_work_last = dmetrics.fold_cell_rows(
                cells_h, plan.owned, plan.halo, self.spec.ncells, plan.K)
        self.transfers.record("metrics", nbytes, boundary=True)
        self.device_metrics_pulls += 1
        self.device_metrics_last = (counts_h, values_h)

    def _mirror_metrics_finish(self, plan: RankPlan, counts: np.ndarray,
                               values: np.ndarray) -> None:
        """Sentinel flags and per-rank state fingerprints from the
        gathered global mirror."""
        st = self.state
        mask = st.cells.mask.cpu().numpy()
        vel = st.cells.vel.cpu().numpy()
        u = st.cells.u.cpu().numpy()
        rho = st.rho.cpu().numpy()
        mass = st.cells.mass.cpu().numpy()
        for r in range(plan.nranks):
            own = plan.owned[r]
            if not len(own):
                continue
            dmetrics.state_health(mask[own], vel[own], u[own], rho[own],
                                  mass[own], counts, values, rank=r)

    @staticmethod
    def _pull_owned_bins(plan: RankPlan, states: List[TimeBinState],
                         active_cells: np.ndarray
                         ) -> List[Tuple[int, np.ndarray]]:
        """The owned rows' ``bins`` of every rank with an active owned
        cell, on the host (only those ranks can have deepened): the
        sub-step's host sync."""
        out = []
        for r in range(plan.nranks):
            own = plan.owned[r]
            if len(own) and active_cells[own].any():
                out.append((r, states[r].bins[:len(own)].cpu().numpy()))
        return out

    def _cycle_substeps_host(self, ctx: Dict[str, object]) -> Dict[str, int]:
        """The host-orchestrated ladder: per-rank phase calls with the
        transport's exchanges (host or collective wire) in between."""
        plan: RankPlan = ctx["plan"]
        depth, nsub = ctx["depth"], ctx["nsub"]
        dt_max_c, dt_min = ctx["dt_max_c"], ctx["dt_min"]
        mask_host, u_floor = ctx["mask_host"], ctx["u_floor"]
        nreal = ctx["nreal"]
        dev = self.device
        dt_max_t = f32(dt_max_c, dev)
        u_floor_t = f32(u_floor, dev)
        tr = self.tracer
        t0 = tr.now() if tr.enabled else 0.0
        states = self._scatter_state(plan)
        if tr.enabled:
            tr.record_all(range(plan.nranks), "scatter", t0, collective=1)

        updates = 0
        pair_tasks = 0
        force_substeps = 0
        drifted_to = 0
        cycle_exported = 0
        cycle_full = 0
        self.halo_log = []          # latest cycle only (bounded memory)
        bins_h = ctx["bins_host"].copy()
        wake_floor = self._wake_floor(bins_h, mask_host)
        dm_on = self.device_metrics_enabled
        met_counts, met_values = dmetrics.zero_rows(plan.nranks)
        mCI, mVI = dmetrics.COUNT_INDEX, dmetrics.VALUE_INDEX
        alive_per_rank = [int((mask_host[plan.owned[r]] > 0).sum())
                          if len(plan.owned[r]) else 0
                          for r in range(plan.nranks)]
        # per-cell attribution: each pair charges the rank's owned
        # endpoint; the exchange column is receiver-side
        cDI = dmetrics.CELL_INDEX
        cellw = cellw_rank = None
        if dm_on:
            cellw, cellw_rank = dmetrics.zero_cell_work(
                self.spec.ncells, plan.nranks)
            alive_cell = (mask_host > 0).sum(axis=1).astype(np.float64)

        def attribute_cells(idxs_r, ship_cells, nexch):
            for r in range(plan.nranks):
                gi = self._ci[idxs_r[r]]
                gj = self._cj[idxs_r[r]]
                tgt = np.where(self._assignment[gi] == r, gi, gj)
                np.add.at(cellw[:, cDI["density"]], tgt, 1.0)
                np.add.at(cellw[:, cDI["force"]], tgt, 1.0)
                cellw_rank[r, cDI["density"]] += len(tgt)
                cellw_rank[r, cDI["force"]] += len(tgt)
                own = plan.owned[r]
                if len(own):
                    cellw[own, cDI["drift"]] += alive_cell[own]
                cellw_rank[r, cDI["drift"]] += alive_per_rank[r]
            for c in ship_cells:
                _, _, imps = plan.cut[c]
                cellw[c, cDI["exchange"]] += nexch * len(imps)
                for (ir, _) in imps:
                    cellw_rank[ir, cDI["exchange"]] += nexch

        # the extended wake floors are rebuilt only when the wake floor
        # itself changes (a wake-up or deepening), not every sub-step
        wake_ext_cache: Dict[int, torch.Tensor] = {}

        def wake_ext(r):
            if r not in wake_ext_cache:
                wf = np.zeros(plan.K + plan.H, np.int32)
                wf[:len(plan.owned[r])] = wake_floor[plan.owned[r]]
                wf[plan.K:plan.K + len(plan.halo[r])] = \
                    wake_floor[plan.halo[r]]
                wake_ext_cache[r] = torch.from_numpy(wf).to(dev)
            return wake_ext_cache[r]

        for n in range(1, nsub):
            level = active_level(n, depth)
            active_p = ((bins_h >= level)
                        | (bins_h < wake_floor[:, None])) & (mask_host > 0)
            if not active_p.any():
                continue
            active_cells = active_p.any(axis=1)
            ship = self._exchange_set(plan, active_cells)
            slots = plan.ship_slots(ship) if ship else None
            nship = slots.total if slots else 0
            cycle_exported += nship
            cycle_full += plan.cut_slots
            self.halo_log.append({
                "substep": self.substeps + n, "level": level,
                "exported_slots": nship, "full_slots": plan.cut_slots})

            dt_d = f32((n - drifted_to) * dt_min, dev)
            drifted_to = n
            if tr.enabled:
                tr.ctx["substep"] = n
                active_frac = float(active_p.sum()) / max(nreal, 1)
            subs, pair_bucket = self._rank_pair_subsets(plan, active_cells)
            self.program_keys.add(("density", level, pair_bucket))
            self.program_keys.add(("force", level, pair_bucket))
            phase1 = []
            for r in range(plan.nranks):
                with tr.span("drift", rank=r):
                    states[r] = self._drift(states[r], dt_d)
                    if tr.enabled:
                        tr.fence(states[r].cells.pos)
                sub, pmask, nlive = subs[r]
                d_attrs = {}
                if tr.enabled:
                    d_attrs = dict(level=level, units=nlive, pairs=nlive,
                                   bucket=pair_bucket,
                                   active_frac=active_frac)
                with tr.span("density", rank=r, **d_attrs):
                    act, rho, om, pr, cs = self._sub_density_p(
                        states[r], sub, pmask, level, wake_ext(r))
                    if tr.enabled:
                        tr.fence(rho)
                phase1.append([sub, pmask, nlive, act, rho, om, pr, cs])
            # exchange 1: owner's fresh rho/omega/press/cs -> replicas
            if slots:
                fields = [[phase1[r][4 + f] for r in range(plan.nranks)]
                          for f in range(4)]
                fields = self._transport.exchange(slots, fields,
                                                  label="exchange1")
                for r in range(plan.nranks):
                    phase1[r][4:] = [fields[f][r] for f in range(4)]
            for r in range(plan.nranks):
                sub, pmask, nlive, act, rho, om, pr, cs = phase1[r]
                f_attrs = {}
                if tr.enabled:
                    f_attrs = dict(level=level, units=nlive, pairs=nlive,
                                   bucket=pair_bucket,
                                   active_frac=active_frac)
                with tr.span("force", rank=r, **f_attrs):
                    states[r], _ = self._sub_force_p(
                        states[r], sub, pmask, act, rho, om, pr, cs,
                        wake_ext(r), dt_max_t, depth, u_floor_t)
                    if tr.enabled:
                        tr.fence(states[r].cells.vel)
            # exchange 2: kicked state of shipped cells -> replicas
            if slots:
                fields = [[getattr(states[r].cells, nm)
                           for r in range(plan.nranks)]
                          for nm in ("vel", "u")]
                fields += [[getattr(states[r], nm)
                            for r in range(plan.nranks)]
                           for nm in ("bins", "t_start", "accel", "dudt")]
                vel, uu, bb, ts, ac, dd = self._transport.exchange(
                    slots, fields, label="exchange2")
                for r in range(plan.nranks):
                    states[r] = states[r]._replace(
                        cells=states[r].cells._replace(
                            vel=vel[r], u=uu[r]),
                        bins=bb[r], t_start=ts[r], accel=ac[r], dudt=dd[r])
            # refresh the global bins mirror (deepening): only ranks whose
            # owned cells were active can have deepened
            floor_dirty = False
            for r, new_bins in self._pull_owned_bins(plan, states,
                                                     active_cells):
                own = plan.owned[r]
                if not np.array_equal(bins_h[own], new_bins):
                    if dm_on:
                        met_counts[r, mCI["deepen_events"]] += int(
                            (bins_h[own] != new_bins).sum())
                    bins_h[own] = new_bins
                    floor_dirty = True
            if floor_dirty:
                new_floor = self._wake_floor(bins_h, mask_host)
                if not np.array_equal(new_floor, wake_floor):
                    wake_floor = new_floor
                    wake_ext_cache.clear()     # invalidate on wake-up
            updates += int(active_p.sum())
            pair_tasks += int((active_cells[self._ci]
                               | active_cells[self._cj]).sum())
            force_substeps += 1
            if dm_on:
                sslots = nship // plan.nranks
                sbytes = sslots * mask_host.shape[1] * 4 \
                    * (_EX1_FIELDS + _EX2_FIELDS)
                for r in range(plan.nranks):
                    own = plan.owned[r]
                    act_r = int(active_p[own].sum()) if len(own) else 0
                    nlive = subs[r][2]
                    met_counts[r] += dmetrics.host_row(
                        substeps=1, drift_active=alive_per_rank[r],
                        density_active=act_r, force_active=act_r,
                        pair_int=nlive, exch_slots=2 * sslots,
                        exch_bytes=sbytes,
                        wake_events=int((bins_h[own]
                                         < wake_floor[own, None]).sum())
                        if len(own) else 0)[0]
                    met_values[r, mVI["density_units"]] += nlive
                    met_values[r, mVI["force_units"]] += nlive
                    met_values[r, mVI["exchange_units"]] += sslots
                    met_values[r, mVI["kick_units"]] += act_r
                attribute_cells(self._select_rank_pairs(plan,
                                                        active_cells)[0],
                                ship, 2.0)

        # final sync sub-step: everyone active, full pair lists, full cut
        dt_d = f32((nsub - drifted_to) * dt_min, dev)
        if tr.enabled:
            tr.ctx["substep"] = nsub
        subs, pair_bucket = self._rank_pair_subsets(plan, None)
        self.program_keys.add(("final_density", 0, pair_bucket))
        self.program_keys.add(("final_force", 0, pair_bucket))
        phase1 = []
        for r in range(plan.nranks):
            with tr.span("drift", rank=r):
                states[r] = self._drift(states[r], dt_d)
                if tr.enabled:
                    tr.fence(states[r].cells.pos)
            sub, pmask, nlive = subs[r]
            with tr.span("density", rank=r, units=nlive, pairs=nlive,
                         bucket=pair_bucket, active_frac=1.0):
                rho, om, pr, cs = self._final_density_p(states[r], sub,
                                                        pmask)
                if tr.enabled:
                    tr.fence(rho)
            phase1.append([sub, pmask, nlive, rho, om, pr, cs])
        if plan.cut:
            ship = list(plan.cut.keys())
            slots = plan.ship_slots(ship)
            cycle_exported += slots.total
            cycle_full += plan.cut_slots
            fields = [[phase1[r][3 + f] for r in range(plan.nranks)]
                      for f in range(4)]
            fields = self._transport.exchange(slots, fields, stream="final",
                                              label="exchange_final")
            for r in range(plan.nranks):
                phase1[r][3:] = [fields[f][r] for f in range(4)]
        for r in range(plan.nranks):
            sub, pmask, nlive, rho, om, pr, cs = phase1[r]
            with tr.span("force", rank=r, units=nlive, pairs=nlive,
                         bucket=pair_bucket, active_frac=1.0):
                states[r] = self._final_force_p(
                    states[r], sub, pmask, rho, om, pr, cs, dt_max_t)
                if tr.enabled:
                    tr.fence(states[r].cells.vel)
        synchronize(dev)
        updates += nreal
        pair_tasks += len(self._ci)
        if dm_on:
            fslots = plan.cut_slots // plan.nranks if plan.cut else 0
            fbytes = fslots * mask_host.shape[1] * 4 * _EX1_FIELDS
            for r in range(plan.nranks):
                nlive = subs[r][2]
                met_counts[r] += dmetrics.host_row(
                    substeps=1, drift_active=alive_per_rank[r],
                    density_active=alive_per_rank[r],
                    force_active=alive_per_rank[r],
                    pair_int=nlive, exch_slots=fslots,
                    exch_bytes=fbytes)[0]
                met_values[r, mVI["density_units"]] += nlive
                met_values[r, mVI["force_units"]] += nlive
                met_values[r, mVI["exchange_units"]] += fslots
                met_values[r, mVI["kick_units"]] += alive_per_rank[r]
            attribute_cells(self._select_rank_pairs(plan, None)[0],
                            list(plan.cut) if plan.cut else [], 1.0)

        tg = tr.now() if tr.enabled else 0.0
        self._gather_state(plan, states)
        if tr.enabled:
            tr.record_all(range(plan.nranks), "gather", tg, collective=1)
        if dm_on:
            self._mirror_metrics_finish(plan, met_counts, met_values)
            self.device_cell_work_last = {
                "columns": list(dmetrics.CELL_COLUMNS),
                "cells": cellw, "per_rank": cellw_rank}
            self._metrics_pull(met_counts, met_values)
        else:
            self.device_metrics_last = None
            self.device_cell_work_last = None
        return {"updates": updates, "pair_tasks": pair_tasks,
                "force_substeps": force_substeps,
                "cycle_exported": cycle_exported,
                "cycle_full": cycle_full}

    # ------------------------------------------------- device-resident cycle
    def _resident_rows(self, plan: RankPlan) -> Tuple[torch.Tensor, ...]:
        """Stacked scatter / gather indices of a plan, on the device:
        (global cells, their rows in the flattened ``(nranks·(K+H))``
        buffers; global owned cells, their rows in the flattened owned
        block ``(nranks·K)``), built once per plan."""
        if self._resident_rows_cache is None \
                or self._resident_rows_cache[0] is not plan:
            nrows = plan.K + plan.H
            src, dst, own, own_at = [], [], [], []
            for r in range(plan.nranks):
                o, hl = plan.owned[r], plan.halo[r]
                src += [o, hl]
                dst += [r * nrows + np.arange(len(o)),
                        r * nrows + plan.K + np.arange(len(hl))]
                own.append(o)
                own_at.append(r * plan.K + np.arange(len(o)))
            T = lambda parts: torch.from_numpy(np.concatenate(
                parts).astype(np.int64)).to(self.device)
            self._resident_rows_cache = (plan, (T(src), T(dst), T(own),
                                                T(own_at)))
        return self._resident_rows_cache[1]

    def _scatter_resident(self, plan: RankPlan) -> ResidentBuffers:
        """Global mirror → one stacked ``(nranks, K+H, …)`` buffer per
        field for the whole cycle, padded as ``_scatter_state`` pads (the
        two residencies must agree on every row). The global mirror lives
        on the device, so this is a device copy; ``put`` ledgers it as the
        cycle boundary's traffic."""
        st = self.state
        nrows = plan.K + plan.H
        src, dst, _, _ = self._resident_rows(plan)
        res = ResidentBuffers(self.transfers)
        keep = lambda a: a

        def ext_stacked(a, fill):
            out = torch.full((plan.nranks * nrows,) + tuple(a.shape[1:]),
                             fill, dtype=a.dtype, device=a.device)
            out.index_copy_(0, dst, a.index_select(0, src))
            return out.reshape((plan.nranks, nrows) + tuple(a.shape[1:]))

        for name in self._CELL_FIELDS:
            res.put(name, ext_stacked(getattr(st.cells, name),
                                      self._FILLS[name]), keep)
        for name in self._AUX_FIELDS:
            res.put(name, ext_stacked(getattr(st, name),
                                      self._FILLS[name]), keep)
        res.put("time", st.time.reshape(1).repeat(plan.nranks), keep)
        return res

    def _gather_resident(self, plan: RankPlan, res: ResidentBuffers) -> None:
        """Stacked owned rows → global mirror (halo replicas discarded:
        only the owned rows are pulled)."""
        st = self.state
        dev = self.device
        _, _, own, own_at = self._resident_rows(plan)
        owned_rows = (slice(None), slice(0, plan.K))

        def gather(name, current):
            got = res.pull(name, index=owned_rows, device=dev)
            got = got.reshape((-1,) + tuple(got.shape[2:]))
            return current.clone().index_copy_(0, own,
                                               got.index_select(0, own_at))

        cells = ParticleCells(**{k: gather(k, getattr(st.cells, k))
                                 for k in self._CELL_FIELDS})
        self.state = TimeBinState(
            cells=cells, time=res.pull("time", device=dev)[0],
            **{k: gather(k, getattr(st, k)) for k in self._AUX_FIELDS})

    def _pair_tables(self, plan: RankPlan, idxs: List[np.ndarray], fit
                     ) -> Tuple[Dict[str, np.ndarray], Tuple[int, ...]]:
        """The ranks' pair tables as the stacked programs take them, and
        their widths ``(B, Bi, Bc, Bw)``.

        Rank r's pairs ``idxs[r]`` (global pair order) are numbered in its
        extended rows and padded to one width ``B`` with masked repeats of
        pair 0; its incoming table (over its live pairs, as at host
        residency) is stacked as a lane's (``cellgrid.stack_incoming``) to
        a width ``Bw`` and over every row, so the shapes follow the widths
        only. The interior / cut positions (a pair is cut iff it touches a
        halo row ≥ K) feed the metrics rows' ``pair_int`` / ``pair_cut``.
        ``fit(kind, demand)`` sizes each width (kind ``"pairs"``,
        ``"int"``, ``"cut"`` or ``"width"``).
        """
        nranks, K = plan.nranks, plan.K
        nrows = plan.K + plan.H
        halo = [(plan.ci_ext[r][idx] >= K) | (plan.cj_ext[r][idx] >= K)
                for r, idx in enumerate(idxs)]
        B = fit("pairs", max(len(idx) for idx in idxs))
        Bi = fit("int", max(int((~h).sum()) for h in halo))
        Bc = fit("cut", max(int(h.sum()) for h in halo))
        t = {"ci": np.zeros((nranks, B), np.int32),
             "cj": np.zeros((nranks, B), np.int32),
             "shift": np.zeros((nranks, B, 3), self._shift.dtype),
             "pmask": np.zeros((nranks, B), np.float32),
             "int_pos": np.zeros((nranks, Bi), np.int32),
             "int_valid": np.zeros((nranks, Bi), np.float32),
             "cut_pos": np.zeros((nranks, Bc), np.int32),
             "cut_valid": np.zeros((nranks, Bc), np.float32)}
        incoming = []
        for r in range(nranks):
            idx, halo_pair = idxs[r], halo[r]
            nlive = len(idx)
            idxp = np.concatenate(
                [idx, np.zeros(B - nlive, dtype=idx.dtype)])
            t["ci"][r] = plan.ci_ext[r][idxp]
            t["cj"][r] = plan.cj_ext[r][idxp]
            t["shift"][r] = self._shift[idxp]
            t["pmask"][r, :nlive] = 1.0
            for kind, pos in (("int", np.nonzero(~halo_pair)[0]),
                              ("cut", np.nonzero(halo_pair)[0])):
                t[kind + "_pos"][r, :len(pos)] = pos
                t[kind + "_valid"][r, :len(pos)] = 1.0
            incoming.append(incoming_table(t["ci"][r], t["cj"][r], nrows,
                                           nlive))
        Bw = fit("width", max(tb.shape[1] for _, tb in incoming))
        t["in_rows"], t["in_table"] = stack_incoming(
            incoming, B, nrows, width=Bw, every_row=True)
        return t, (B, Bi, Bc, Bw)

    def _exchange_tables(self, plan: RankPlan, slots: ShipSlots, fit
                         ) -> Tuple[Dict[str, np.ndarray], Tuple]:
        """The index tables of one exchange of ``slots`` over the
        transport's round schedule (or its all-gather), and their part of
        the shape signature; ``fit(kind, demand)`` sizes the buckets (kind
        ``"edge"``, ``"ag_out"`` or ``"ag_in"``)."""
        t, nranks = self._transport, plan.nranks
        if t.mode == "ppermute":
            Be = fit("edge", slots.max_edge_slots)
            pack, unpack, valid = pack_rounds(t.rounds, slots, nranks, Be)
            return ({"e_pack": pack, "e_unpack": unpack, "e_valid": valid},
                    ("ppermute", Be, t._perms_sig))
        Bo = fit("ag_out", slots.max_rank_exports(nranks))
        Bn = fit("ag_in", slots.max_rank_imports(nranks))
        pack, usrc, urows, valid = pack_allgather(slots, nranks, Bo, Bn)
        return ({"e_pack": pack, "e_usrc": usrc, "e_urows": urows,
                 "e_valid": valid}, ("allgather", Bo, Bn))

    def _to_device(self, tables: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        dev = self.device
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in tables.items()}

    def _fused_tables(self, plan: RankPlan,
                      active_cells: Optional[np.ndarray], slots: ShipSlots,
                      stream: str, wake_stacked: Optional[np.ndarray],
                      level: int = 0) -> Tuple[Dict[str, torch.Tensor],
                                               Tuple]:
        """One sub-step's control tables for the fused program, and the
        shape signature that keys it: :meth:`_select_rank_pairs`'s subset
        as :meth:`_pair_tables` lays it out, the wake floors, and the
        exchange tables of ``slots``. Every bucket goes through the
        no-shrink policy keyed per (stream, level). All of it is control —
        int32/int64 indices and float32 masks — and is ledgered as
        ``tables``, the resident path's intra-cycle uploads.
        """
        nrows = plan.K + plan.H
        idxs, _ = self._select_rank_pairs(plan, active_cells)
        buckets = self._fused_buckets
        tables, widths = self._pair_tables(
            plan, idxs, lambda kind, n: buckets.fit((stream, kind, level), n))
        tables["wake"] = (wake_stacked if wake_stacked is not None else
                          np.zeros((plan.nranks, nrows), np.int32))
        exch, exch_sig = self._exchange_tables(
            plan, slots, lambda kind, n: buckets.fit((kind, stream), n))
        tables.update(exch)
        self.transfers.record(
            "tables", sum(a.nbytes for a in tables.values()), boundary=False)
        sig = (plan.nranks, nrows, plan.K) + widths + (
            exch_sig, int(self.state.cells.mass.shape[1]))
        return self._to_device(tables), sig

    def _fused_program(self, sig: Tuple, *, final: bool):
        """The fused sub-step program of this shape signature, built once
        and cached with the transport's exchange programs, so the probe
        counts each one's input signatures."""
        t = self._transport
        key = ("fused_final" if final else "fused_force",) + sig + (t.mode,)
        return t.programs.get(key, lambda: build_fused_substep_program(
            mode=t.mode, rounds=t.rounds, nranks=sig[0], nrows=sig[1],
            K=sig[2], cfg=self.cfg, box=self.box, device=self.device,
            final=final))

    def _scalar(self, x) -> torch.Tensor:
        """A host float as a 0-d float32 tensor on the device, ledgered
        with the tables (a sub-step's scalars are control too)."""
        self.transfers.record("tables", 4, boundary=False)
        return f32(x, self.device)

    def _cycle_substeps_device(self, ctx: Dict[str, object]
                               ) -> Dict[str, int]:
        """The device-resident ladder: the stacked extended states stay on
        the device for the whole cycle; every force sub-step is one fused
        program over all ranks (drift → density → exchange → force → kick
        → exchange). Host traffic inside the cycle is control tables in
        and one ``changed`` flag per rank out, plus the ``bins`` rows of
        the ranks that deepened."""
        plan: RankPlan = ctx["plan"]
        depth, nsub = ctx["depth"], ctx["nsub"]
        dt_max_c, dt_min = ctx["dt_max_c"], ctx["dt_min"]
        mask_host, u_floor = ctx["mask_host"], ctx["u_floor"]
        nreal = ctx["nreal"]
        tr = self.tracer
        t0 = tr.now() if tr.enabled else 0.0
        res = self._scatter_resident(plan)
        if tr.enabled:
            tr.fence(res["pos"])
            tr.record_all(range(plan.nranks), "scatter", t0, collective=1)

        updates = 0
        pair_tasks = 0
        force_substeps = 0
        drifted_to = 0
        cycle_exported = 0
        cycle_full = 0
        self.halo_log = []
        bins_h = ctx["bins_host"].copy()
        wake_floor = self._wake_floor(bins_h, mask_host)
        wake_stacked: Optional[np.ndarray] = None
        # a sub-step's tables depend only on (level, bins mirror): every
        # sub-step of a level reuses the tables already on the device
        # until a deepening invalidates them all — a depth-d cycle uploads
        # O(d) table sets, not O(2**d)
        table_cache: Dict[int, Tuple] = {}

        def wake_tbl() -> np.ndarray:
            nonlocal wake_stacked
            if wake_stacked is None:
                w = np.zeros((plan.nranks, plan.K + plan.H), np.int32)
                for r in range(plan.nranks):
                    own, hal = plan.owned[r], plan.halo[r]
                    w[r, :len(own)] = wake_floor[own]
                    w[r, plan.K:plan.K + len(hal)] = wake_floor[hal]
                wake_stacked = w
            return wake_stacked

        def level_plan(level: int) -> Tuple:
            if level not in table_cache:
                active_p = ((bins_h >= level)
                            | (bins_h < wake_floor[:, None])) \
                    & (mask_host > 0)
                if not active_p.any():
                    table_cache[level] = (active_p, None, None, None, None)
                else:
                    active_cells = active_p.any(axis=1)
                    ship = self._exchange_set(plan, active_cells)
                    slots = plan.ship_slots(ship) if ship else ShipSlots()
                    tables, sig = self._fused_tables(
                        plan, active_cells, slots, "fused_sub", wake_tbl(),
                        level=level)
                    table_cache[level] = (active_p, active_cells, slots,
                                          tables, sig)
            return table_cache[level]

        dm_on = self.device_metrics_enabled
        acc: List = []          # [(counts, values), cells] on the device

        def run_fused(tables, sig, scalars, final):
            prog = self._fused_program(sig, final=final)
            state_in = {name: res[name] for name in
                        self._CELL_FIELDS + self._AUX_FIELDS + ("time",)}
            out_state, changed, met = prog(state_in, tables, scalars,
                                           metrics=dm_on)
            res.update(out_state)
            if met is not None:
                row = (met["counts"], met["values"])
                if not acc:
                    acc.extend([row, met["cells"]])
                else:
                    # folded on the device: no host read
                    acc[0] = dmetrics.combine(acc[0], row)
                    acc[1] = acc[1] + met["cells"]
            return changed

        dt_max_t = self._scalar(dt_max_c)
        u_floor_t = self._scalar(u_floor)
        for n in range(1, nsub):
            level = active_level(n, depth)
            active_p, active_cells, slots, tables, sig = level_plan(level)
            if not active_p.any():
                continue
            cycle_exported += slots.total
            cycle_full += plan.cut_slots
            self.halo_log.append({
                "substep": self.substeps + n, "level": level,
                "exported_slots": slots.total,
                "full_slots": plan.cut_slots})

            dt_d = (n - drifted_to) * dt_min
            drifted_to = n
            if tr.enabled:
                tr.ctx["substep"] = n
            self.program_keys.add(("fused_force", level, sig[3]))
            scalars = {"dt_drift": self._scalar(dt_d), "level": level,
                       "dt_max": dt_max_t, "depth": depth,
                       "u_floor": u_floor_t}
            ts = tr.now() if tr.enabled else 0.0
            changed = run_fused(tables, sig, scalars, final=False)
            if tr.enabled:
                # one task on every rank's row; fenced so its device time
                # lands inside this span, not the next
                tr.fence(res["pos"])
                tr.record_all(
                    range(plan.nranks), "fused_substep", ts,
                    level=level, bucket=sig[3],
                    units=int((active_cells[self._ci]
                               | active_cells[self._cj]).sum()),
                    slots=slots.total,
                    active_frac=float(active_p.sum()) / max(nreal, 1),
                    collective=1)
            changed_h = changed.cpu().numpy()
            self.transfers.record("flags", changed_h.nbytes, boundary=False)
            if changed_h.any():
                # a deepening: refresh the bins mirror from the ranks that
                # deepened only, then re-derive the wake floors — the one
                # mid-cycle state-array pull, ledgered per row
                with tr.span("bins_refresh"):
                    for r in np.nonzero(changed_h)[0]:
                        own = plan.owned[int(r)]
                        if not len(own):
                            continue
                        row = res.pull("bins", boundary=False, index=int(r))
                        bins_h[own] = row[:len(own)]
                    self.bins_refreshes += 1
                    table_cache.clear()
                    new_floor = self._wake_floor(bins_h, mask_host)
                    if not np.array_equal(new_floor, wake_floor):
                        wake_floor = new_floor
                        wake_stacked = None
            updates += int(active_p.sum())
            pair_tasks += int((active_cells[self._ci]
                               | active_cells[self._cj]).sum())
            force_substeps += 1

        # final sync sub-step: everyone active, full pair lists, full cut
        dt_d = (nsub - drifted_to) * dt_min
        slots = plan.ship_slots(list(plan.cut)) if plan.cut else ShipSlots()
        cycle_exported += slots.total
        if plan.cut:
            cycle_full += plan.cut_slots
        tables, sig = self._fused_tables(plan, None, slots, "fused_final",
                                         None)
        self.program_keys.add(("fused_final", 0, sig[3]))
        if tr.enabled:
            tr.ctx["substep"] = nsub
        scalars = {"dt_drift": self._scalar(dt_d), "level": 0,
                   "dt_max": dt_max_t, "depth": depth, "u_floor": u_floor_t}
        ts = tr.now() if tr.enabled else 0.0
        run_fused(tables, sig, scalars, final=True)
        if tr.enabled:
            tr.fence(res["pos"])
            tr.record_all(range(plan.nranks), "fused_final", ts,
                          level=0, bucket=sig[3], units=len(self._ci),
                          slots=slots.total, active_frac=1.0, collective=1)
        updates += nreal
        pair_tasks += len(self._ci)

        if dm_on and acc:
            # one pull a cycle: the accumulated rows, per-cell rows too
            self._metrics_pull(*acc[0], cells=acc[1], plan=plan)
        elif not dm_on:
            self.device_metrics_last = None
            self.device_cell_work_last = None

        tg = tr.now() if tr.enabled else 0.0
        self._gather_resident(plan, res)
        synchronize(self.device)
        if tr.enabled:
            tr.record_all(range(plan.nranks), "gather", tg, collective=1)
        return {"updates": updates, "pair_tasks": pair_tasks,
                "force_substeps": force_substeps,
                "cycle_exported": cycle_exported,
                "cycle_full": cycle_full}

    # ---------------------------------------------- device-scheduled segments
    def _segment_tables(self, plan: RankPlan
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor], Tuple]:
        """The static tables of one device-scheduled segment, and the shape
        signature that keys its programs.

        Unlike :meth:`_fused_tables` they do not depend on activity: each
        rank's **full touch set** (:meth:`_select_rank_pairs` with no
        restriction, in ascending global pair order — every per-level
        table of the host schedule is a subsequence of it, so a masked row
        sum adds the same contributions in the same order), laid out by
        :meth:`_pair_tables` at plain ``next_pow2`` widths, which move only
        with the partition; the full-cut exchange tables; and the side
        tables the programs derive the schedule with: ``own_pair`` (the
        rank owning a pair's ``ci`` cell counts it, so the ranks' counts
        sum to the host's), ``rowcell`` (each row's global cell, for the
        crossing sentinel) and ``gather_idx`` (each global cell's row in
        the ranks' flattened owned rows, for u_floor). One upload a
        segment, ledgered as a boundary transfer: a segment has no
        intra-segment entry.
        """
        nranks, K = plan.nranks, plan.K
        nrows = plan.K + plan.H
        idxs, _ = self._select_rank_pairs(plan, None)
        pow2 = lambda kind, n: next_pow2(n)
        tables, widths = self._pair_tables(plan, idxs, pow2)
        own_pair = np.zeros_like(tables["pmask"])
        rowcell = np.full((nranks, nrows), -1, np.int32)
        gidx = np.zeros(self.spec.ncells, np.int64)
        for r in range(nranks):
            idx, own, hal = idxs[r], plan.owned[r], plan.halo[r]
            own_pair[r, :len(idx)] = self._assignment[self._ci[idx]] == r
            rowcell[r, :len(own)] = own
            rowcell[r, K:K + len(hal)] = hal
            gidx[own] = r * K + np.arange(len(own))
        slots = plan.ship_slots(list(plan.cut)) if plan.cut else ShipSlots()
        exch, exch_sig = self._exchange_tables(plan, slots, pow2)
        tables.update(exch, own_pair=own_pair, rowcell=rowcell)
        consts = {"gather_idx": gidx}
        self.transfers.record("segment_tables", sum(
            a.nbytes for a in list(tables.values()) + [gidx]), boundary=True)
        sig = (nranks, nrows, K) + widths + (
            exch_sig, int(self.state.cells.mass.shape[1]))
        return self._to_device(tables), self._to_device(consts), sig

    def _cycle_scan_program(self, sig: Tuple, nsub_static: int):
        t = self._transport
        key = ("cycle_scan", nsub_static, self.activity_aware) + sig \
            + (t.mode,)
        return t.programs.get(key, lambda: build_cycle_scan_program(
            mode=t.mode, rounds=t.rounds, nranks=sig[0], nrows=sig[1],
            K=sig[2], cfg=self.cfg, box=self.box, nsub_static=nsub_static,
            bin_delta=self.bin_delta, activity_aware=self.activity_aware,
            device=self.device))

    def _plan_program(self, sig: Tuple, nsub_static: int):
        t = self._transport
        key = ("segment_plan", nsub_static, self.dt_max) + sig + (t.mode,)
        return t.programs.get(key, lambda: build_plan_program(
            mode=t.mode, rounds=t.rounds, nranks=sig[0], nrows=sig[1],
            K=sig[2], cfg=self.cfg, box=self.box,
            ncells_side=self.spec.ncells_side, max_depth=self.max_depth,
            bin_delta=self.bin_delta, depth_headroom=self.depth_headroom,
            nsub_static=nsub_static, dt_max_static=self.dt_max,
            device=self.device))

    def _place_scalars(self, ctx: Dict[str, object]
                       ) -> Dict[str, torch.Tensor]:
        """The host-planned first cycle's scalars as 0-d device tensors,
        ledgered with the segment's tables."""
        dev = self.device
        vals = {"dt_max": torch.tensor(np.float32(ctx["dt_max_c"])),
                "depth": torch.tensor(ctx["depth"], dtype=torch.int32),
                "nsub": torch.tensor(ctx["nsub"], dtype=torch.int32),
                "u_floor": torch.tensor(np.float32(ctx["u_floor"]))}
        self.transfers.record("segment_tables", 4 * len(vals), boundary=True)
        return {k: v.to(dev) for k, v in vals.items()}

    def _segment_guard(self):
        """The context a segment's programs run in: with ``sync_debug`` on
        a CUDA device, any synchronising call inside raises."""
        if not (self.sync_debug and self.device.type == "cuda"):
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def guard():
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(before)
        return guard()

    def _pull_segment(self, *groups: List[Dict[str, torch.Tensor]]
                      ) -> List[List[Dict[str, np.ndarray]]]:
        """The segment's one boundary pull: each group's dicts of device
        tensors on the host, ledgered as one ``segment_stats`` transfer."""
        pulled = [[{k: v.cpu().numpy() for k, v in d.items()} for d in g]
                  for g in groups]
        self.transfers.record("segment_stats", sum(
            a.nbytes for g in pulled for d in g for a in d.values()),
            boundary=True)
        return pulled

    def _run_segment(self) -> List[Dict]:
        """Run one device-scheduled segment of ``segment_cycles`` cycles.

        Cycle 1 is planned by the host prologue, which also sizes the
        static ladder of the scan; each further cycle is planned on the
        device by the plan program, its scalars passed on as device
        tensors. Between the table upload and the one boundary pull of
        every cycle's counters, metrics rows, scalars and flags, the host
        reads nothing and moves no byte (the transfer ledger has no
        intra-segment entry). If a health sentinel (NaN, Inf, a
        non-positive density), a crossing or the capacity flag tripped,
        the pre-segment state comes back and the segment replays on the
        host schedule, which gives the same bits.
        """
        K_cycles = self.segment_cycles
        tr = self.tracer
        stash = self.state
        ctx = self._cycle_prologue()
        plan: RankPlan = ctx["plan"]
        nsub_static = ctx["nsub"]
        t0 = tr.now() if tr.enabled else 0.0
        res = self._scatter_resident(plan)
        tables, consts, sig = self._segment_tables(plan)
        cyc_prog = self._cycle_scan_program(sig, nsub_static)
        self.program_keys.add(("cycle_scan", ctx["depth"], sig[3]))
        plan_prog = None
        if K_cycles > 1:
            plan_prog = self._plan_program(sig, nsub_static)
            self.program_keys.add(("segment_plan", ctx["depth"], sig[3]))
        scalars = self._place_scalars(ctx)
        if tr.enabled:
            tr.fence(res["pos"])
            tr.record_all(range(plan.nranks), "segment_tables", t0,
                          collective=1)
        names = self._CELL_FIELDS + self._AUX_FIELDS + ("time",)
        per_cnt, per_met, per_scal, per_flags = [], [], [scalars], []
        with self._segment_guard():
            for j in range(K_cycles):
                if j > 0:
                    with tr.span("segment_plan", cycle=j):
                        upd, scalars, flags = plan_prog(
                            {nm: res[nm] for nm in names}, tables, consts)
                    res.update(upd)
                    per_scal.append(scalars)
                    per_flags.append(flags)
                with tr.span("cycle_scan", cycle=j, trips=nsub_static):
                    out_state, cnt, met = cyc_prog(
                        {nm: res[nm] for nm in names}, tables, scalars)
                res.update(out_state)
                per_cnt.append(cnt)
                per_met.append(met)
        # ---- the one boundary pull: every cycle's counters, metrics
        # rows, device-planned scalars and flags
        t1 = tr.now() if tr.enabled else 0.0
        pulled_cnt, pulled_met, pulled_scal, pulled_flags = \
            self._pull_segment(per_cnt, per_met, per_scal, per_flags)
        if tr.enabled:
            tr.record_all(range(plan.nranks), "boundary_pull", t1,
                          collective=1)
        self.segments += 1

        mci = dmetrics.COUNT_INDEX
        sentinels = sum(int(m["counts"][:, mci[f]].sum()) for m in pulled_met
                        for f in ("flag_nan", "flag_inf", "flag_neg_rho"))
        crossed = sum(int(f["crossed"]) for f in pulled_flags)
        over = sum(int(f["capacity"]) for f in pulled_flags)
        self.segment_flags_last = {"sentinels": sentinels,
                                   "crossed": crossed, "capacity": over}
        if sentinels or crossed or over:
            # discard the segment, bring back the state it started from
            # and replay it on the host schedule: the same bits, NaNs
            # included
            self.segment_aborts += 1
            self.state = stash
            return self._replay_segment_host(K_cycles)

        tg = tr.now() if tr.enabled else 0.0
        self._gather_resident(plan, res)
        if tr.enabled:
            tr.record_all(range(plan.nranks), "gather", tg, collective=1)
        depth_last = int(pulled_scal[-1]["depth"])
        with tr.span("repartition_check"):
            self._maybe_repartition(self.state.bins.cpu().numpy(),
                                    self.state.cells.mask.cpu().numpy(),
                                    depth_last)
        if self.rebin_each_cycle:
            with tr.span("rebin", units=ctx["nreal"]):
                self._rebin_state()

        nreal = ctx["nreal"]
        cut_slots = plan.cut_slots
        self.halo_log = []          # the per-sub-step log is host-side only
        dm_on = self.device_metrics_enabled
        stats_list: List[Dict] = []
        for j in range(K_cycles):
            cnt, scal = pulled_cnt[j], pulled_scal[j]
            depth_j = int(scal["depth"])
            nsub_j = int(scal["nsub"])
            updates_j = int(cnt["updates"].sum())
            exported_j = int(cnt["exported"].sum())
            full_j = int(cnt["live_trips"][0]) * cut_slots
            self.particle_updates += updates_j
            self.global_equiv_updates += nsub_j * nreal
            self.substeps += nsub_j
            self.halo_exported_slots += exported_j
            self.halo_full_slots += full_j
            hist_j = (ctx["hist"] if j == 0
                      else pulled_flags[j - 1]["hist"][:depth_j + 1])
            stats = {
                "t": float(cnt["t_end"][0]),
                "dt_max": float(scal["dt_max"]),
                "depth": depth_j,
                "substeps": nsub_j,
                "force_substeps": int(cnt["force_substeps"][0]) + 1,
                "bin_hist": np.asarray(hist_j, np.int64),
                "updates": updates_j,
                "global_equiv_updates": nsub_j * nreal,
                "pair_tasks": int(cnt["pair_tasks"].sum()),
                "global_equiv_pair_tasks": nsub_j * len(self._ci),
                "halo_exported_slots": exported_j,
                "halo_full_slots": full_j,
                "nranks": plan.nranks,
                "residency": self.residency,
                "schedule": "device",
                "segment_cycles": K_cycles,
            }
            if dm_on:
                met = pulled_met[j]
                stats["_met"] = (met["counts"], met["values"])
                stats["_cellw"] = dmetrics.fold_cell_rows(
                    met["cells"], plan.owned, plan.halo, self.spec.ncells,
                    plan.K)
            stats_list.append(stats)
        if not dm_on:
            self.device_metrics_last = None
            self.device_cell_work_last = None
        return stats_list

    def _replay_segment_host(self, K_cycles: int) -> List[Dict]:
        """The abort path: the segment's cycles again on the host-scheduled
        resident ladder, each cycle's metrics rows carried with its stats."""
        out = []
        for _ in range(K_cycles):
            ctx = self._cycle_prologue()
            body = self._cycle_substeps_device(ctx)
            stats = self._cycle_epilogue(ctx, body)
            stats.update(schedule="device", segment_cycles=K_cycles,
                         replayed=True)
            if self.device_metrics_enabled:
                stats["_met"] = self.device_metrics_last
                stats["_cellw"] = self.device_cell_work_last
            out.append(stats)
        return out
