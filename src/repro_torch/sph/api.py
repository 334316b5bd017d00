"""One front-end over the engines: ``SimulationSpec`` → simulation.

Port of ``repro.sph.api`` for the four quadrants:

==============  =================  ========================================
integrator      backend            engine
==============  =================  ========================================
``"global"``    ``"local"``        ``engine.Simulation`` (KDK waves)
``"timebin"``   ``"local"``        ``timebins.TimeBinSimulation`` (KDK
                                   ladder)
``"global"``    ``"distributed"``  ``distributed.DistSimulation`` (graph-
                                   partitioned cells, ``ranks`` stacked on
                                   the one device; halos allgather / ring)
``"timebin"``   ``"distributed"``  ``dist_timebins.DistTimeBinSimulation``
                                   (activity-aware halos, the ranks'
                                   states on the one device; host or
                                   collective wire; host or device
                                   residency)
==============  =================  ========================================

:class:`SimulationSpec` has exactly the reference's fields, so one spec
means the same run in both packages. The time-bin × distributed quadrant
runs the reference's host schedule at either residency
(``residency="device"`` with ``transport="collective"``: the stacked states
stay on the card for the cycle, one fused program a sub-step), and at
device residency also its device schedule (``schedule="device"``, with
``segment_cycles`` cycles a segment: one program a cycle, planned on the
card, the host reading nothing inside a segment).
``SimulationSpec.program_signature()`` / ``signature_key()`` are the fleet's
(:mod:`repro_torch.fleet.signature`): equal specs in the two packages get
the same key, letter for letter.

``observe`` takes what the reference's takes (``False``, ``True``, an
:class:`~repro_torch.observability.ObserveSpec` or a mapping of its
fields): when enabled, :func:`build_simulation` attaches a
:class:`~repro_torch.observability.RunObserver` whose tracer is wired
through the engine and its transport, and ``sim.observer`` holds the
per-cycle schema-v3 records and the trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..observability.observer import ObserveSpec
from ..observability.tracer import NULL_TRACER
from .engine import SPHConfig, host_array


@contextlib.contextmanager
def _engine_layer():
    """The API building the engines is not a deprecated use of them."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


INTEGRATORS = ("global", "timebin")
BACKENDS = ("local", "distributed")

# ------------------------------------------------------------ scenario registry
SCENARIOS: Dict[str, Callable[..., Dict[str, np.ndarray]]] = {}


def register_scenario(name: str):
    """Register an initial-condition factory under ``name``.

    The factory returns the standard IC dict: ``pos`` (n, 3), ``vel``,
    ``mass``, ``u``, ``h`` arrays plus the scalar ``box``.
    """
    def deco(fn):
        SCENARIOS[name] = fn
        return fn
    return deco


def make_ic(scenario: str, **params) -> Dict[str, np.ndarray]:
    """Instantiate a registered scenario's initial conditions."""
    try:
        fn = SCENARIOS[scenario]
    except KeyError:
        raise KeyError(
            f"unknown scenario {scenario!r}; registered: "
            f"{sorted(SCENARIOS)}") from None
    return fn(**params)


def _register_builtin_scenarios():
    from . import ic
    SCENARIOS.setdefault("uniform", ic.uniform_ic)
    SCENARIOS.setdefault("clustered", ic.clustered_ic)
    SCENARIOS.setdefault("sedov", ic.sedov_ic)
    SCENARIOS.setdefault("kelvin_helmholtz", ic.kelvin_helmholtz_ic)


_register_builtin_scenarios()


class FrozenParams(Mapping):
    """Canonical immutable mapping for ``SimulationSpec.scenario_params``:
    items sorted by key with values in canonical hashable form, so equal
    content means an equal, equally hashed spec."""

    __slots__ = ("_items", "_dict")

    def __init__(self, mapping: Mapping[str, Any] = ()):
        from ..fleet.signature import canonical
        items = tuple(sorted((str(k), canonical(v))
                             for k, v in dict(mapping).items()))
        object.__setattr__(self, "_items", items)
        object.__setattr__(self, "_dict", dict(items))

    def __getitem__(self, key):
        return self._dict[key]

    def __iter__(self):
        return iter(self._dict)

    def __len__(self):
        return len(self._dict)

    def __hash__(self):
        return hash(self._items)

    def __eq__(self, other):
        if isinstance(other, FrozenParams):
            return self._items == other._items
        if isinstance(other, Mapping):
            return self._items == FrozenParams(other)._items
        return NotImplemented

    def __repr__(self):
        return f"FrozenParams({self._dict!r})"


# ------------------------------------------------------------------------ spec
@dataclass(frozen=True)
class SimulationSpec:
    """Frozen description of a run; field for field the reference's.

    The time-bin × distributed policy (``transport``, ``residency``,
    ``schedule``, ``segment_cycles``, …) is validated as the reference
    validates it. ``mesh_axis`` names nothing in the port: the ranks share
    one device.
    """
    scenario: str = "uniform"
    scenario_params: Mapping[str, Any] = field(default_factory=dict)
    physics: SPHConfig = field(default_factory=SPHConfig)
    integrator: str = "global"             # "global" | "timebin"
    backend: str = "local"                 # "local" | "distributed"

    # global-dt policy
    dt: Optional[float] = None             # fixed step; None → per-step CFL
    rebin_every: int = 1

    # time-bin policy
    dt_max: Optional[float] = None         # cycle span; None → CFL max
    max_depth: int = 10
    bin_delta: int = 2
    depth_headroom: int = 2

    # distributed policy
    ranks: Optional[int] = None
    halo: str = "allgather"
    mesh_axis: str = "data"
    activity_aware_halos: bool = True
    repartition_threshold: float = 1.5
    seed: int = 0
    transport: str = "host"
    transport_mode: str = "auto"
    residency: str = "host"
    schedule: str = "host"
    segment_cycles: int = 1

    # shared
    capacity_margin: float = 3.0
    observe: Any = False

    def __post_init__(self):
        if not isinstance(self.scenario_params, FrozenParams):
            object.__setattr__(self, "scenario_params",
                               FrozenParams(self.scenario_params))
        if self.integrator not in INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {INTEGRATORS}, "
                f"got {self.integrator!r}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.scenario not in SCENARIOS:
            raise ValueError(
                f"unknown scenario {self.scenario!r}; registered: "
                f"{sorted(SCENARIOS)}")
        if self.halo not in ("allgather", "ring"):
            raise ValueError(f"halo must be 'allgather' or 'ring', "
                             f"got {self.halo!r}")
        if self.transport not in ("host", "collective"):
            raise ValueError(f"transport must be 'host' or 'collective', "
                             f"got {self.transport!r}")
        if self.transport_mode not in ("auto", "ppermute", "allgather"):
            raise ValueError(
                f"transport_mode must be 'auto', 'ppermute' or "
                f"'allgather', got {self.transport_mode!r}")
        if self.residency not in ("host", "device"):
            raise ValueError(f"residency must be 'host' or 'device', "
                             f"got {self.residency!r}")
        if self.residency == "device" and self.transport != "collective":
            raise ValueError(
                "residency='device' requires transport='collective'")
        if self.schedule not in ("host", "device"):
            raise ValueError(f"schedule must be 'host' or 'device', "
                             f"got {self.schedule!r}")
        if self.schedule == "device" and self.residency != "device":
            raise ValueError("schedule='device' requires residency='device'")
        if int(self.segment_cycles) < 1:
            raise ValueError(f"segment_cycles must be >= 1, "
                             f"got {self.segment_cycles!r}")
        if self.segment_cycles > 1 and self.schedule != "device":
            raise ValueError(
                "segment_cycles > 1 requires schedule='device'")
        ob = self.observe
        if not isinstance(ob, ObserveSpec):
            if isinstance(ob, bool):
                ob = ObserveSpec(enabled=ob)
            elif isinstance(ob, Mapping):
                ob = ObserveSpec(enabled=True, **dict(ob))
            else:
                raise ValueError(
                    f"observe must be a bool, an ObserveSpec or a mapping "
                    f"of its fields, got {self.observe!r}")
            object.__setattr__(self, "observe", ob)

    def with_(self, **changes) -> "SimulationSpec":
        """A copy with the given fields replaced (specs are frozen)."""
        return dataclasses.replace(self, **changes)

    def program_signature(self) -> tuple:
        """The program signature this spec maps to: quadrant × engine
        policy × physics × scenario *shape* (value-only scenario params
        excluded, so two Sedov requests differing only in ``e0`` share a
        signature and can batch). See :mod:`repro_torch.fleet.signature`."""
        from ..fleet.signature import signature
        return signature(self)

    def signature_key(self) -> str:
        """Short stable digest of :meth:`program_signature` (logs, cache
        keys, trace attrs)."""
        from ..fleet.signature import signature_key
        return signature_key(self)


# ------------------------------------------------------------------- adapters
class _SimulationBase:
    """Shared ``run`` / log / observability plumbing of the adapters."""

    spec: SimulationSpec
    observer = None               # RunObserver when spec.observe is enabled
    _tracer = NULL_TRACER

    @property
    def time(self) -> float:
        raise NotImplementedError

    def _step_impl(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        """Advance one step (global dt) or one cycle (time bins); closes
        the observer's cycle record."""
        stats = self._step_impl()
        if self.observer is not None:
            self.observer.end_cycle(self, stats)
        return stats

    def _init_observer(self) -> None:
        """Attach a RunObserver and wire its tracer through the engine
        layers (called by :func:`build_simulation` once the engine
        exists)."""
        ospec = self.spec.observe
        if not ospec.enabled:
            return
        from ..observability.observer import RunObserver
        self.observer = RunObserver(ospec)
        tr = self.observer.tracer
        self._tracer = tr
        eng = self.engine
        if hasattr(eng, "tracer"):
            eng.tracer = tr
        eng.device_metrics_enabled = bool(ospec.device_metrics)
        transport = getattr(eng, "_transport", None)
        if transport is not None:
            transport.tracer = tr

    def diagnostics(self) -> Tuple[float, np.ndarray]:
        return self.engine.diagnostics()

    @property
    def state(self):
        return self.engine.state

    def run(self, t_end: float, callbacks: Tuple[Callable, ...] = ()
            ) -> Dict[str, list]:
        log: Dict[str, list] = {"t": [], "dt": [], "E": [], "px": [],
                                "wall": []}
        # slack sized for float32 time accumulation (ulp ~1e-7 per step)
        while self.time < t_end * (1.0 - 1e-5):
            stats = self.step()
            e, p = self.diagnostics()
            log["t"].append(float(stats["t"]))
            log["dt"].append(float(stats.get("dt", stats.get("dt_max", 0.0))))
            log["E"].append(e)
            log["px"].append(float(p[0]))
            log["wall"].append(float(stats.get("wall", 0.0)))
            for cb in callbacks:
                cb(self, stats)
        return log


def _global_metrics_row(counts, values, rank, *, nreal, npairs, nslots=0):
    """One global-dt step's telemetry row (host-mirror path): every real
    particle is active every step, work units are the full pair list."""
    from ..observability import device_metrics as dmetrics
    counts[rank] += dmetrics.host_row(
        substeps=1, drift_active=nreal, density_active=nreal,
        force_active=nreal, pair_int=npairs, exch_slots=nslots)[0]
    vi = dmetrics.VALUE_INDEX
    values[rank, vi["density_units"]] += npairs
    values[rank, vi["force_units"]] += npairs
    values[rank, vi["exchange_units"]] += nslots
    values[rank, vi["kick_units"]] += nreal


class _LocalGlobal(_SimulationBase):
    """global × local: the single-host KDK engine."""

    def __init__(self, spec: SimulationSpec, ic: Dict[str, np.ndarray],
                 device: DeviceLike):
        from .engine import Simulation as _Engine
        self.spec = spec
        with _engine_layer():
            self.engine = _Engine(ic["pos"], ic["vel"], ic["mass"], ic["u"],
                                  ic["h"], box=float(ic["box"]),
                                  cfg=spec.physics,
                                  capacity_margin=spec.capacity_margin,
                                  rebin_every=spec.rebin_every,
                                  device=device)

    @property
    def time(self) -> float:
        return float(self.engine.state.time)

    def _step_impl(self) -> Dict[str, Any]:
        with self._tracer.timed("step") as sp:
            if self.spec.dt is not None:
                dt = float(self.spec.dt)
            else:
                from .engine import cfl_timestep
                dt = float(cfl_timestep(self.engine.state,
                                        self.spec.physics))
            self.engine.run(1, dt=dt)
        eng = self.engine
        if eng.device_metrics_enabled:
            from ..observability import device_metrics as dmetrics
            st = eng.state
            c = st.cells
            mask = host_array(c.mask)
            counts, values = dmetrics.zero_rows(1)
            ci = host_array(eng.pairs.ci)
            npairs = int(ci.shape[0])
            _global_metrics_row(counts, values, 0,
                                nreal=int((mask > 0).sum()),
                                npairs=npairs)
            dmetrics.state_health(mask, host_array(c.vel), host_array(c.u),
                                  host_array(st.rho), host_array(c.mass),
                                  counts, values, rank=0)
            # per-cell attribution: density/force charged at the pair's
            # i-cell, drift = alive particles per cell (all active on the
            # global-dt path), no exchange on a single rank.
            cDI = dmetrics.CELL_INDEX
            cellw, cellw_rank = dmetrics.zero_cell_work(mask.shape[0], 1)
            np.add.at(cellw[:, cDI["density"]], ci, 1.0)
            np.add.at(cellw[:, cDI["force"]], ci, 1.0)
            cellw[:, cDI["drift"]] += (mask > 0).sum(axis=1)
            cellw_rank[0] = cellw.sum(axis=0)
            eng.device_cell_work_last = {
                "columns": list(dmetrics.CELL_COLUMNS),
                "cells": cellw, "per_rank": cellw_rank}
            eng.device_metrics_last = (counts, values)
            eng.device_metrics_pulls += 1
        else:
            eng.device_metrics_last = None
            eng.device_cell_work_last = None
        return {"t": self.time, "dt": dt, "wall": sp.elapsed}


class _LocalTimeBin(_SimulationBase):
    """timebin × local: the hierarchical KDK ladder."""

    def __init__(self, spec: SimulationSpec, ic: Dict[str, np.ndarray],
                 device: DeviceLike):
        from .timebins import TimeBinSimulation
        self.spec = spec
        with _engine_layer():
            self.engine = TimeBinSimulation(
                ic["pos"], ic["vel"], ic["mass"], ic["u"], ic["h"],
                box=float(ic["box"]), cfg=spec.physics, dt_max=spec.dt_max,
                max_depth=spec.max_depth, bin_delta=spec.bin_delta,
                depth_headroom=spec.depth_headroom,
                capacity_margin=spec.capacity_margin, device=device)

    @property
    def time(self) -> float:
        return float(self.engine.state.time)

    def _step_impl(self) -> Dict[str, Any]:
        stats = self.engine.run_cycle()
        stats["dt"] = stats["dt_max"]
        return stats


class _DistGlobal(_SimulationBase):
    """global × distributed: graph-partitioned cells, ``ranks`` ranks
    stacked on one device (``ranks=None`` means 1)."""

    def __init__(self, spec: SimulationSpec, ic: Dict[str, np.ndarray],
                 device: DeviceLike):
        from .cellgrid import bin_particles, build_pair_list, choose_grid
        from .distributed import DistSimulation
        self.spec = spec
        self.box = float(ic["box"])
        n = len(ic["pos"])
        dev = resolve_device(device)
        gspec = choose_grid(self.box, float(np.max(ic["h"])), n,
                            capacity_margin=spec.capacity_margin)
        cells, self.perm = bin_particles(gspec, ic["pos"], ic["vel"],
                                         ic["mass"], ic["u"], ic["h"],
                                         device=dev)
        # the plan is built on the host: the pair list stays there
        pairs = build_pair_list(gspec)
        with _engine_layer():
            self.engine = DistSimulation(cells, pairs, gspec,
                                         ranks=spec.ranks or 1,
                                         cfg=spec.physics, halo=spec.halo,
                                         seed=spec.seed, device=dev)
        self._time = 0.0

    @property
    def state(self):
        return self.engine.dcells

    @property
    def time(self) -> float:
        return self._time

    def _dt(self) -> float:
        if self.spec.dt is not None:
            return float(self.spec.dt)
        from .physics import cfl_timestep_block
        c = self.engine.gather_cells()
        dts = cfl_timestep_block(c.h, c.u, c.vel, c.mask,
                                 gamma=self.spec.physics.gamma,
                                 cfl=self.spec.physics.cfl)
        return float(dts.min())

    def _step_impl(self) -> Dict[str, Any]:
        with self._tracer.timed("step") as sp:
            dt = self._dt()
            self.engine.step(dt)
            self._time += dt
        eng = self.engine
        if eng.device_metrics_enabled:
            from ..observability import device_metrics as dmetrics
            plan = eng.plan
            nd, K = plan.ndev, plan.K
            mask = host_array(eng.dcells.mask).reshape(nd, K, -1)
            vel = host_array(eng.dcells.vel).reshape(nd, K, -1, 3)
            u = host_array(eng.dcells.u).reshape(nd, K, -1)
            rho = host_array(eng.rho).reshape(nd, K, -1)
            mass = host_array(eng.dcells.mass).reshape(nd, K, -1)
            counts, values = dmetrics.zero_rows(nd)
            # slot -> global cell id per rank (storage assigns owned
            # slots in ascending cell order; padded slots land on cell 0
            # but only ever receive zero-valued adds).
            assignment = np.asarray(plan.assignment)
            storage = np.asarray(plan.storage)
            ncells = len(assignment)
            slot_cell = np.zeros((nd, K), np.int64)
            slot_cell[assignment, storage] = np.arange(ncells)
            cDI = dmetrics.CELL_INDEX
            cellw, cellw_rank = dmetrics.zero_cell_work(ncells, nd)
            for r in range(nd):
                npairs = int(plan.pair_w[r].sum())
                nslots = int(plan.export_valid[r].sum())
                _global_metrics_row(
                    counts, values, r,
                    nreal=int((mask[r] > 0).sum()),
                    npairs=npairs, nslots=nslots)
                dmetrics.state_health(mask[r], vel[r], u[r], rho[r],
                                      mass[r], counts, values, rank=r)
                # density/force: one unit per valid directed pair entry,
                # charged at the receiver's owned cell; exchange: one unit
                # per valid export slot; drift: alive per owned slot.
                pw = np.asarray(plan.pair_w[r]) > 0
                recv_cells = slot_cell[r, np.asarray(plan.pair_recv[r])[pw]]
                np.add.at(cellw[:, cDI["density"]], recv_cells, 1.0)
                np.add.at(cellw[:, cDI["force"]], recv_cells, 1.0)
                ev = np.asarray(plan.export_valid[r]) > 0
                exp_cells = slot_cell[r, np.asarray(plan.export_slots[r])[ev]]
                np.add.at(cellw[:, cDI["exchange"]], exp_cells, 1.0)
                alive_r = (mask[r] > 0).sum(axis=1).astype(np.float64)
                np.add.at(cellw[:, cDI["drift"]], slot_cell[r], alive_r)
                cellw_rank[r, cDI["density"]] += npairs
                cellw_rank[r, cDI["force"]] += npairs
                cellw_rank[r, cDI["exchange"]] += nslots
                cellw_rank[r, cDI["drift"]] += int((mask[r] > 0).sum())
            eng.device_cell_work_last = {
                "columns": list(dmetrics.CELL_COLUMNS),
                "cells": cellw, "per_rank": cellw_rank}
            eng.device_metrics_last = (counts, values)
            eng.device_metrics_pulls += 1
        else:
            eng.device_metrics_last = None
            eng.device_cell_work_last = None
        return {"t": self._time, "dt": dt, "wall": sp.elapsed}


class _DistTimeBin(_SimulationBase):
    """timebin × distributed: activity-aware halos over a rank partition,
    every rank's extended state on the one device (per-rank states, or
    stacked and resident for the cycle with ``residency="device"``).
    ``ranks=None`` means 1 (the reference counts its JAX devices
    instead)."""

    def __init__(self, spec: SimulationSpec, ic: Dict[str, np.ndarray],
                 device: DeviceLike):
        from .dist_timebins import DistTimeBinSimulation
        self.spec = spec
        self.engine = DistTimeBinSimulation(
            ic["pos"], ic["vel"], ic["mass"], ic["u"], ic["h"],
            box=float(ic["box"]), cfg=spec.physics, nranks=spec.ranks or 1,
            activity_aware=spec.activity_aware_halos,
            repartition_threshold=spec.repartition_threshold,
            seed=spec.seed, dt_max=spec.dt_max, max_depth=spec.max_depth,
            bin_delta=spec.bin_delta, depth_headroom=spec.depth_headroom,
            capacity_margin=spec.capacity_margin,
            transport=spec.transport, transport_mode=spec.transport_mode,
            residency=spec.residency, schedule=spec.schedule,
            segment_cycles=spec.segment_cycles, device=device)

    @property
    def time(self) -> float:
        return float(self.engine.state.time)

    def _step_impl(self) -> Dict[str, Any]:
        stats = self.engine.run_cycle()
        stats["dt"] = stats["dt_max"]
        return stats


_QUADRANTS = {
    ("global", "local"): _LocalGlobal,
    ("timebin", "local"): _LocalTimeBin,
    ("global", "distributed"): _DistGlobal,
    ("timebin", "distributed"): _DistTimeBin,
}


def build_simulation(spec: SimulationSpec,
                     ic: Optional[Dict[str, np.ndarray]] = None, *,
                     device: DeviceLike = None) -> _SimulationBase:
    """Compile a :class:`SimulationSpec` into a running simulation on
    ``device`` (``None``: the CUDA device; raises if there is none).

    ``ic`` overrides the scenario lookup (pre-built initial conditions in
    the standard dict form).
    """
    if ic is None:
        ic = make_ic(spec.scenario, **dict(spec.scenario_params))
    sim = _QUADRANTS[(spec.integrator, spec.backend)](spec, ic, device)
    sim._init_observer()
    return sim
