"""Fleet runner: many simulations as signature-grouped, lane-stacked batches.

Port of ``repro.fleet.runner``. SWIFT's scheduling idea applied one level
up: the unit of work is a whole *simulation request*, and the card stays
busy by dispatching the largest ready batch of shape-compatible requests
as one stacked program. The pieces:

* **Batched entry points.** Requests in the ``("global", "local")``
  quadrant are served as *lanes* (:mod:`repro_torch.fleet.lanes`): the
  members' cell arrays stacked into one ``(bucket·ncells, C, …)`` array
  and their pair lists into one list, so each step — and each stacked
  init — launches ``density_pair_cells`` and ``force_pair`` once for the
  whole batch. Per-request CFL steps ride along as a ``(bucket,)`` vector.
  The entry points live in a
  :class:`~repro_torch.distributed.transport.ProgramCache` per
  ``("fleet_step" | "fleet_cfl", signature, shape, bucket, 1)``; building
  one builds the stacked pair list and its incoming table on the device,
  once, and :class:`~repro_torch.distributed.transport.CompileProbe`
  counts each entry point's distinct input signatures (one, whatever the
  arrival sizes: the batcher's no-shrink buckets).
* **Lockstep semantics = sequential semantics.** Batched execution mirrors
  the single-run engine (``engine.Simulation.run``): the same init, the
  same host re-binning cadence (``rebin_every``), the same CFL policy — so
  each lane is **bit for bit** the same spec run alone, on the CPU and on
  the card. Inits and re-inits of a shape group go through one stacked
  init (the reference inits each member alone; the lanes give the same
  bits), so each pair kernel launches ``2·steps`` times per shape group
  at ``rebin_every=1``, whatever its lane count. A lane whose capacity
  changes at a re-bin falls off the batch and finishes sequentially.
* **Sequential route.** Other quadrants, and ``physics.use_pallas`` (the
  reference's rule, kept so ``FleetResult.batched`` matches it for every
  spec), are served one by one through ``build_simulation`` on the same
  device, which runs the same Hopper kernels.
* **Pooled result transfers.** Finished lanes are copied to the host
  through a :class:`TransferBufferPool` of reused buffers.
* **Per-request tracing.** With ``observe=True`` every dispatch is
  recorded on each member request's own timeline row with a
  ``request_id`` attr (``export_trace``).

The port serves from one card: the reference's ``shard_map`` of the fleet
axis over a device mesh (``fleet_devices > 1``) is multi-GPU and not
ported.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device, synchronize
from ..distributed.transport import CompileProbe, ProgramCache
from ..observability.tracer import NULL_TRACER, Tracer
from ..sph.api import SimulationSpec, build_simulation, make_ic
from ..sph.engine import host_array
from . import lanes
from .batcher import Batch, SignatureBatcher
from .queue import FleetRequest, FleetResult, RequestQueue, RequestState

HOST_PHASES = ("build", "rebin_stack", "steps", "results")


# ------------------------------------------------------------- result pool
class TransferBufferPool:
    """Reusable host buffers for device→host result pulls.

    ``take(src)`` copies a tensor (on any device) or array into a pooled
    numpy buffer of matching (shape, dtype), allocating only on pool
    miss; ``give(buf)`` returns a buffer to its bucket. Serving keeps
    result memory bounded by the number of *inflight* results, not the
    number of requests ever served.
    """

    def __init__(self):
        self._free: Dict[Tuple[tuple, str], List[np.ndarray]] = {}
        self.hits = 0
        self.misses = 0

    def take(self, src) -> np.ndarray:
        a = host_array(src)
        key = (a.shape, str(a.dtype))
        bucket = self._free.get(key)
        if bucket:
            buf = bucket.pop()
            self.hits += 1
        else:
            buf = np.empty(a.shape, a.dtype)
            self.misses += 1
        np.copyto(buf, a)
        return buf

    def give(self, buf: np.ndarray) -> None:
        self._free.setdefault((buf.shape, str(buf.dtype)), []).append(buf)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "resident": sum(len(v) for v in self._free.values())}


# ---------------------------------------------------------- batched members
@dataclass(eq=False)
class _Member:
    """One request's host-side engine bookkeeping inside a batch.

    ``cells`` are host tensors between steps of the batch; ``state`` is
    the member's own device state only once it falls off the batch."""
    req: FleetRequest
    box: float
    n: int
    gspec: Any
    cells: Any
    pairs: Any                      # the member's pair list, on the host
    perm: np.ndarray
    time: float = 0.0               # float32 value
    state: Any = None
    steps_done: int = 0
    steps_since_rebin: int = 0
    done: bool = False

    @property
    def shape_key(self) -> tuple:
        return (self.gspec.ncells_side, self.cells.mass.shape[1],
                float(self.box), int(self.pairs.ci.shape[0]))


def _build_member(req: FleetRequest) -> _Member:
    """Host-side admission of one request: IC → grid → cells, exactly the
    single-run engine's construction path (the init runs stacked)."""
    from ..sph.cellgrid import bin_particles, build_pair_list, choose_grid
    spec = req.spec
    ic = make_ic(spec.scenario, **dict(spec.scenario_params))
    box = float(ic["box"])
    n = len(ic["pos"])
    gspec = choose_grid(box, float(np.max(ic["h"])), n,
                        capacity_margin=spec.capacity_margin)
    cells, perm = bin_particles(gspec, np.asarray(ic["pos"]),
                                np.asarray(ic["vel"]), np.asarray(ic["mass"]),
                                np.asarray(ic["u"]), np.asarray(ic["h"]))
    if cells.mass.shape[1] != gspec.capacity:
        object.__setattr__(gspec, "capacity", cells.mass.shape[1])
    return _Member(req=req, box=box, n=n, gspec=gspec, cells=cells,
                   pairs=build_pair_list(gspec), perm=perm)


def _rebin_member(m: _Member, cells) -> None:
    """The engine's host re-bin of ``cells`` (the member's current cell
    arrays): unbin → re-bin. The pair list depends only on the grid's
    cells and box, which a re-bin never changes; the fresh init runs
    stacked, or alone for a lane that fell off."""
    from ..sph.cellgrid import bin_particles, unbin
    flat = unbin(cells, m.perm, m.n)
    m.cells, m.perm = bin_particles(m.gspec, flat["pos"], flat["vel"],
                                    flat["mass"], flat["u"], flat["h"])
    if m.cells.mass.shape[1] != m.gspec.capacity:
        object.__setattr__(m.gspec, "capacity", m.cells.mass.shape[1])
    m.steps_since_rebin = 0


def _flat_result(state_cells, perm: np.ndarray, n: int, time: float,
                 steps: int, wall: float, *, batched: bool,
                 batch_size: int = 1, bucket: int = 1,
                 pool: Optional[TransferBufferPool] = None) -> FleetResult:
    """Final state → user-facing flat particle arrays + host diagnostics."""
    from ..sph.cellgrid import unbin
    flat = unbin(state_cells, perm, n)
    if pool is not None:
        flat = {k: (pool.take(v) if isinstance(v, np.ndarray) else v)
                for k, v in flat.items()}
    m = flat["mass"]
    v = flat["vel"]
    ke = 0.5 * float(np.sum(m * np.sum(v * v, axis=-1)))
    ie = float(np.sum(m * flat["u"]))
    mom = np.sum(m[:, None] * v, axis=0)
    return FleetResult(particles=flat, energy=ke + ie, momentum=mom,
                       t=float(time), steps=steps, wall=wall,
                       batched=batched, batch_size=batch_size, bucket=bucket)


# ------------------------------------------------------------------ runner
class FleetRunner:
    """Request-driven serving loop over signature-grouped batches, on
    ``device`` (``None``: the CUDA device; raises if there is none)."""

    def __init__(self, *, max_batch: int = 64, max_inflight: int = 1024,
                 fleet_devices: Optional[int] = None, observe: bool = False,
                 flight_dir: Optional[str] = None, device: DeviceLike = None):
        if fleet_devices not in (None, 1):
            raise ValueError(
                f"fleet_devices={fleet_devices!r}: the port serves the fleet "
                f"from one card (the reference's shard_map of the fleet "
                f"axis over a device mesh is not ported); pass None or 1")
        self.device = resolve_device(device)
        self.fleet_devices = 1
        self.queue = RequestQueue(max_inflight=max_inflight)
        self.batcher = SignatureBatcher(max_batch=max_batch,
                                        min_bucket=self.fleet_devices)
        self.probe = CompileProbe()
        self.programs = ProgramCache(self.probe)
        self._lane_pairs: Dict[tuple, Any] = {}
        self.pool = TransferBufferPool()
        self.tracer: Tracer = Tracer() if observe else NULL_TRACER
        self.row_names: Dict[int, str] = {}
        self.batches_run = 0
        self.sequential_runs = 0
        self.particle_steps = 0         # Σ particles × steps actually served
        # per-request terminal-status counter: every request the runner
        # retires lands here exactly once (done/failed/expired)
        self.terminal_status: Dict[str, int] = {}
        # where expired-sweep post-mortem bundles go (None = no dumps)
        self.flight_dir = flight_dir
        self.flight_dumps: List[str] = []
        # one row per batched shape group: its lanes, bucket, batched steps
        # and density+force passes (each one launch of each pair kernel),
        # and the passes of lanes that fell off it
        self.groups: List[Dict[str, Any]] = []
        self.host_s: Dict[str, float] = {k: 0.0 for k in HOST_PHASES}

    # ----------------------------------------------------------- frontend
    def submit(self, spec: SimulationSpec, *, n_steps: int = 1,
               deadline: Optional[float] = None,
               request_id: Optional[str] = None,
               callback: Optional[Callable[[FleetRequest], None]] = None
               ) -> FleetRequest:
        # visible sweep before admission: expired requests get their
        # terminal count / timeline span / flight bundle here
        self._sweep_expired(self.queue.expire())
        req = self.queue.submit(spec, n_steps=n_steps, deadline=deadline,
                                request_id=request_id, callback=callback)
        self.row_names[req.row] = req.request_id
        return req

    def poll(self) -> Dict[str, Any]:
        """Deadline sweep + fleet stats without claiming any work."""
        self._sweep_expired(self.queue.expire())
        return self.stats()

    def drain(self) -> List[FleetRequest]:
        """Serve until the queue is empty; returns the finished requests.

        The deadline sweep runs *visibly*: expired requests get a terminal
        status count, a zero-length ``expired`` span on their own timeline
        row, and (when ``flight_dir`` is set) a post-mortem bundle."""
        served: List[FleetRequest] = []
        while True:
            self._sweep_expired(self.queue.expire())
            ready = self.queue.take_ready()
            if not ready:
                break
            for batch in self.batcher.form(ready):
                self._run_batch(batch)
                served.extend(batch.requests)
                for r in batch.requests:
                    self._count_terminal(r)
        return served

    def _count_terminal(self, req: FleetRequest) -> None:
        key = req.state.value
        self.terminal_status[key] = self.terminal_status.get(key, 0) + 1

    def _sweep_expired(self, expired: List[FleetRequest]) -> None:
        if not expired:
            return
        tr = self.tracer
        now = tr.now() if tr.enabled else 0.0
        for r in expired:
            self._count_terminal(r)
            if tr.enabled:
                tr.record("expired", r.row, now, now,
                          request_id=r.request_id, deadline=r.deadline,
                          error=str(r.error))
        if self.flight_dir is not None:
            from ..observability.flight import FlightRecorder
            path = FlightRecorder().dump(
                self.flight_dir,
                reason=f"expired-{expired[0].request_id}",
                cycle=self.batches_run,
                spans=self.tracer.spans[-256:],
                row_names=self.row_names,
                extra={"expired": [r.request_id for r in expired]})
            self.flight_dumps.append(path)

    # ---------------------------------------------------------- dispatch
    def _run_batch(self, batch: Batch) -> None:
        spec = batch.requests[0].spec
        quadrant = (spec.integrator, spec.backend)
        try:
            if quadrant == ("global", "local") and not spec.physics.use_pallas:
                self._run_batched_global(batch)
            else:
                self._run_sequential(batch)
        except Exception as e:
            for r in batch.requests:
                if r.state is RequestState.RUNNING:
                    self.queue.fail(r, e)
            raise
        finally:
            self.batches_run += 1

    # ----------------------------------------------- batched global×local
    def _entry_points(self, sig_key: str, shape_key: tuple, bucket: int,
                      spec: SimulationSpec, pairs):
        """(step, cfl, stacked pair list) for one (signature, shape,
        bucket) cell. Building the step entry point builds the stacked
        pair list and its incoming table on the device, once."""
        key = (sig_key, shape_key, bucket, self.fleet_devices)
        box = float(shape_key[2])
        cfg = spec.physics
        ncells = int(shape_key[0]) ** 3

        def build_step():
            self._lane_pairs[key] = lanes.stack_pair_list(
                pairs, bucket, ncells, self.device)
            return functools.partial(lanes.lane_step, box=box, cfg=cfg)

        def build_cfl():
            return functools.partial(lanes.lane_cfl, cfg=cfg, bucket=bucket)

        step_fn = self.programs.get(("fleet_step",) + key, build_step)
        cfl_fn = self.programs.get(("fleet_cfl",) + key, build_cfl)
        return step_fn, cfl_fn, self._lane_pairs[key]

    def _run_batched_global(self, batch: Batch) -> None:
        """Serve a ("global", "local") batch as stacked lanes.

        Splits by concrete shape key (members whose grid/capacity differ
        cannot stack); each shape group gets its own bucket from the
        no-shrink policy and its own cached entry points.
        """
        t0 = time.perf_counter()
        members = [_build_member(r) for r in batch.requests]
        self.host_s["build"] += time.perf_counter() - t0
        groups: Dict[tuple, List[_Member]] = {}
        for m in members:
            groups.setdefault(m.shape_key, []).append(m)
        for shape_key, group in groups.items():
            if len(groups) == 1:
                bucket = batch.bucket            # the batcher's sizing holds
            else:
                bucket = self.batcher.policy.fit(
                    (batch.signature_key, shape_key), len(group))
            self._run_shape_group(batch.signature_key, shape_key, bucket,
                                  group)

    def _stack_init(self, group: List[_Member], bucket: int, pairs, cfg):
        """Live lanes' cells (done lanes and the bucket's padding repeat the
        first live lane) stacked on the device and initialised in one
        density and one force launch, each lane keeping its time."""
        live = [m for m in group if not m.done]
        lanes_ = [m if not m.done else live[0] for m in group]
        lanes_ += [live[0]] * (bucket - len(lanes_))
        cells = lanes.stack_cells([m.cells for m in lanes_], self.device)
        times = lanes.lane_times([m.time for m in lanes_], self.device)
        return lanes.lane_init(cells, pairs, cfg, times)

    def _run_shape_group(self, sig_key: str, shape_key: tuple, bucket: int,
                         group: List[_Member]) -> None:
        tr = self.tracer
        spec = group[0].req.spec
        cfg = spec.physics
        ncells = int(shape_key[0]) ** 3
        step_fn, cfl_fn, pairs = self._entry_points(
            sig_key, shape_key, bucket, spec, group[0].pairs)
        row = {"signature": sig_key, "shape_key": shape_key,
               "bucket": bucket, "lanes": len(group), "steps": 0,
               "passes": 1, "fell_off": 0, "fell_off_passes": 0}
        self.groups.append(row)
        t0 = time.perf_counter()
        stacked = self._stack_init(group, bucket, pairs, cfg)
        self.host_s["rebin_stack"] += time.perf_counter() - t0
        max_steps = max(m.req.n_steps for m in group)
        t_start = time.perf_counter()
        for n in range(max_steps):
            t0 = tr.now() if tr.enabled else time.perf_counter()
            if spec.dt is not None:
                dts = lanes.lane_times([np.float32(spec.dt)] * bucket,
                                       self.device)
            else:
                dts = cfl_fn(stacked)
            stacked = step_fn(stacked, pairs, dts)
            synchronize(self.device)
            self.host_s["steps"] += time.perf_counter() - t0
            row["steps"] += 1
            row["passes"] += 1
            if tr.enabled:
                tr.fence(stacked.cells.pos)
                for m in group:
                    if not m.done:
                        tr.record("fleet_step", m.req.row, t0,
                                  request_id=m.req.request_id,
                                  signature=sig_key, step=n, batch=len(group),
                                  bucket=bucket)
            self.particle_steps += sum(m.n for m in group if not m.done)
            # lockstep host bookkeeping, mirroring engine.Simulation.run;
            # rebin_every is in the signature and the lanes step together,
            # so every live lane is due for a re-bin when one is
            finish, rebin = [], False
            for i, m in enumerate(group):
                if m.done:
                    continue
                m.steps_done += 1
                m.steps_since_rebin += 1
                if m.steps_done >= m.req.n_steps:
                    finish.append(i)
                elif m.steps_since_rebin >= m.req.spec.rebin_every:
                    rebin = True
            if finish or (rebin and n < max_steps - 1):
                # pull the lanes to the host once; finish and/or re-bin
                t0 = time.perf_counter()
                host = type(stacked.cells)(*(t.cpu() for t in stacked.cells))
                times = host_array(stacked.time)
                self.host_s["rebin_stack"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                for i in finish:
                    m = group[i]
                    m.done = True
                    wall = time.perf_counter() - t_start
                    res = _flat_result(
                        lanes.take_lane(host, i, ncells), m.perm, m.n,
                        times[i], m.steps_done, wall, batched=True,
                        batch_size=len(group), bucket=bucket, pool=self.pool)
                    self.queue.complete(m.req, res)
                self.host_s["results"] += time.perf_counter() - t0
                if rebin and n < max_steps - 1:
                    t0 = time.perf_counter()
                    for i, m in enumerate(group):
                        if m.done:
                            continue
                        m.time = times[i]
                        _rebin_member(m, lanes.take_lane(host, i, ncells))
                        if m.shape_key != shape_key:
                            # capacity grew: this lane can no longer
                            # stack — finish it off-batch, correctness
                            # over batching
                            row["fell_off"] += 1
                            row["fell_off_passes"] += \
                                self._finish_member_sequentially(m)
                    if any(not m.done for m in group):
                        stacked = self._stack_init(group, bucket, pairs, cfg)
                        row["passes"] += 1
                    self.host_s["rebin_stack"] += time.perf_counter() - t0
            if all(m.done for m in group):
                break

    def _finish_member_sequentially(self, m: _Member) -> int:
        """A lane that fell off its batch (shape divergence) finishes on the
        single-run engine path from its current exact state; returns its
        density+force passes."""
        from ..sph.cellgrid import build_pair_list
        from ..sph.engine import cfl_timestep, f32, init_state, step
        tr = self.tracer
        spec = m.req.spec
        dev = self.device
        pairs = build_pair_list(m.gspec, device=dev)

        def init():
            cells = lanes.stack_cells([m.cells], dev)
            m.state = init_state(cells, pairs, spec.physics)._replace(
                time=f32(m.time, dev))

        init()
        passes = 1
        t_start = time.perf_counter()
        while m.steps_done < m.req.n_steps:
            if spec.dt is not None:
                dt = float(spec.dt)
            else:
                dt = float(cfl_timestep(m.state, spec.physics))
            t0 = tr.now() if tr.enabled else 0.0
            m.state = step(m.state, pairs, f32(dt, dev), m.box, spec.physics)
            passes += 1
            if tr.enabled:
                tr.fence(m.state.cells.pos)
                tr.record("fleet_step", m.req.row, t0,
                          request_id=m.req.request_id, sequential=1)
            m.steps_done += 1
            m.steps_since_rebin += 1
            self.particle_steps += m.n
            if m.steps_since_rebin >= spec.rebin_every \
                    and m.steps_done < m.req.n_steps:
                m.time = np.float32(host_array(m.state.time))
                _rebin_member(m, m.state.cells)
                init()
                passes += 1
        m.done = True
        self.sequential_runs += 1
        res = _flat_result(m.state.cells, m.perm, m.n, m.state.time,
                           m.steps_done, time.perf_counter() - t_start,
                           batched=False, pool=self.pool)
        self.queue.complete(m.req, res)
        return passes

    # -------------------------------------------------- sequential route
    def _run_sequential(self, batch: Batch) -> None:
        """Quadrants without a batched route (time-bin ladders,
        distributed backends) and ``use_pallas`` specs: served per request
        through ``build_simulation`` on the runner's device."""
        tr = self.tracer
        for req in batch.requests:
            t_start = time.perf_counter()
            t0 = tr.now() if tr.enabled else 0.0
            try:
                sim = build_simulation(req.spec, device=self.device)
                for _ in range(req.n_steps):
                    sim.step()
                res = self._sequential_result(
                    sim, req, time.perf_counter() - t_start)
            except Exception as e:
                self.queue.fail(req, e)
                continue
            if tr.enabled:
                tr.record("fleet_run", req.row, t0,
                          request_id=req.request_id,
                          signature=batch.signature_key,
                          quadrant=f"{req.spec.integrator}/"
                                   f"{req.spec.backend}")
            self.sequential_runs += 1
            self.queue.complete(req, res)

    def _sequential_result(self, sim, req: FleetRequest,
                           wall: float) -> FleetResult:
        eng = getattr(sim, "engine", sim)
        state = getattr(eng, "state", None)
        cells = getattr(state, "cells", None)
        perm = getattr(eng, "perm", None)
        n = getattr(eng, "n", None)
        self.particle_steps += (n or 0) * req.n_steps
        if cells is not None and perm is not None and n is not None:
            return _flat_result(cells, perm, n, sim.time, req.n_steps, wall,
                                batched=False, pool=self.pool)
        e, p = sim.diagnostics()
        return FleetResult(particles={}, energy=e, momentum=p, t=sim.time,
                           steps=req.n_steps, wall=wall, batched=False)

    # ------------------------------------------------------------- reading
    def compile_counts(self) -> Dict[str, int]:
        return self.probe.counts()

    def assert_compile_discipline(self) -> None:
        """≤1 input signature per (signature, shape, bucket) entry point."""
        bad = {k: c for k, c in self.probe.counts().items() if c > 1}
        if bad:
            raise AssertionError(
                f"fleet entry points recompiled: {bad} — batch bucketing "
                f"or shape keying is leaking shapes")

    def stats(self) -> Dict[str, Any]:
        return {"queue": self.queue.stats(),
                "terminal_status": dict(self.terminal_status),
                "flight_dumps": list(self.flight_dumps),
                "batches": self.batches_run,
                "sequential_runs": self.sequential_runs,
                "particle_steps": self.particle_steps,
                "programs": len(self.programs.keys),
                "compiles": self.probe.total_compiles(),
                "buckets": dict(self.batcher.policy._bucket),
                "pool": self.pool.stats(),
                "fleet_devices": self.fleet_devices,
                "device": str(self.device),
                "groups": len(self.groups),
                "padding_lanes": sum(g["bucket"] - g["lanes"]
                                     for g in self.groups),
                "host_s": dict(self.host_s)}

    def export_trace(self, path: str) -> Dict[str, Any]:
        """Chrome-trace of the fleet timeline: one row per request, every
        span attributed to its ``request_id``."""
        from ..observability.sinks import write_chrome_trace
        return write_chrome_trace(path, self.tracer.spans,
                                  self.tracer.t_origin,
                                  process_name="repro_torch.fleet",
                                  row_names=self.row_names)


def sequential_reference(spec: SimulationSpec, n_steps: int, *,
                         device: DeviceLike = None) -> FleetResult:
    """The single-simulation serving path for parity checks and baselines:
    ``build_simulation`` + ``step()`` × n on ``device``, result in the same
    flat layout as the fleet's (bit for bit comparable per request)."""
    t0 = time.perf_counter()
    sim = build_simulation(spec, device=device)
    for _ in range(n_steps):
        sim.step()
    eng = sim.engine
    return _flat_result(eng.state.cells, eng.perm, eng.n, sim.time, n_steps,
                        time.perf_counter() - t0, batched=False)
