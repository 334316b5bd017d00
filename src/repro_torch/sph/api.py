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
                                   (activity-aware halos, per-rank states
                                   on the one device; host or collective
                                   wire)
==============  =================  ========================================

:class:`SimulationSpec` has exactly the reference's fields, so one spec
means the same run in both packages. The time-bin × distributed quadrant
runs the reference's host residency and host schedule; its device
residency, device schedule and segments (ROADMAP queue 1, item 11b), the
observability hooks (``observe``, item 9) and the fleet signatures (item
12) are later slices of the port and raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..observability.tracer import NULL_TRACER
from .engine import SPHConfig


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


def canonical(value: Any) -> Any:
    """Recursively convert ``value`` to a canonical hashable form: mappings
    become sorted ``(key, value)`` tuples, sequences tuples, numpy scalars
    Python scalars, arrays (shape, dtype, bytes)."""
    if isinstance(value, Mapping):
        return tuple(sorted((str(k), canonical(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(canonical(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return tuple(sorted(map(canonical, value), key=repr))
    if isinstance(value, np.ndarray):
        return ("ndarray", value.shape, str(value.dtype), value.tobytes())
    if isinstance(value, np.generic):
        return value.item()
    return value


class FrozenParams(Mapping):
    """Canonical immutable mapping for ``SimulationSpec.scenario_params``:
    items sorted by key with values in canonical hashable form, so equal
    content means an equal, equally hashed spec."""

    __slots__ = ("_items", "_dict")

    def __init__(self, mapping: Mapping[str, Any] = ()):
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
    ``schedule``, …) is validated as the reference validates it;
    ``residency="device"`` (and with it ``schedule="device"`` and
    ``segment_cycles > 1``) raises when the engine is built (ROADMAP queue
    1, item 11b). ``mesh_axis`` names nothing in the port: the ranks share
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
        if self.observe is not False:
            raise NotImplementedError(
                "repro_torch: observe is not ported yet (ROADMAP queue 1, "
                "item 9: observability); use observe=False")

    def with_(self, **changes) -> "SimulationSpec":
        """A copy with the given fields replaced (specs are frozen)."""
        return dataclasses.replace(self, **changes)


# ------------------------------------------------------------------- adapters
class _SimulationBase:
    """Shared ``run`` / log plumbing of the adapters."""

    spec: SimulationSpec
    _tracer = NULL_TRACER

    @property
    def time(self) -> float:
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        """Advance one step (global dt) or one cycle (time bins)."""
        raise NotImplementedError

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

    def step(self) -> Dict[str, Any]:
        with self._tracer.timed("step") as sp:
            if self.spec.dt is not None:
                dt = float(self.spec.dt)
            else:
                from .engine import cfl_timestep
                dt = float(cfl_timestep(self.engine.state,
                                        self.spec.physics))
            self.engine.run(1, dt=dt)
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

    def step(self) -> Dict[str, Any]:
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

    def step(self) -> Dict[str, Any]:
        with self._tracer.timed("step") as sp:
            dt = self._dt()
            self.engine.step(dt)
            self._time += dt
        return {"t": self._time, "dt": dt, "wall": sp.elapsed}


class _DistTimeBin(_SimulationBase):
    """timebin × distributed: activity-aware halos over a rank partition,
    every rank's extended state on the one device. ``ranks=None`` means 1
    (the reference counts its JAX devices instead)."""

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

    def step(self) -> Dict[str, Any]:
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
    return _QUADRANTS[(spec.integrator, spec.backend)](spec, ic, device)
