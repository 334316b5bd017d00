"""Run-level observer (port of ``repro.observability.observer``): merges
span streams + engine ledgers per cycle.

One :class:`RunObserver` is attached per run (``SimulationSpec(observe=
True)`` → ``build_simulation`` wires its tracer into the engine and its
transport). After every cycle the API layer calls :meth:`RunObserver.
end_cycle`, which

* folds the cycle's spans into per-phase wall/count/units aggregates and
  per-rank busy time (SWIFT's task plot, reduced: imbalance = max/mean of
  per-rank *distinguishable* work, dead time = cycle wall not covered by
  any task);
* copies the engine's ledgers **verbatim** — ``TransferProbe.stats()``,
  ``CompileProbe.counts()``, transport stats, halo export counters — so
  the JSONL record's byte/compile numbers agree exactly with the probes
  (asserted by ``python -m repro_torch.observability`` and the tests);
* feeds measured (units, seconds) pairs into the
  :class:`~repro_torch.core.cost_model.CostModel` (``observe``); the
  report prints measured-vs-modelled rate ratios per task kind.

The record layout (one JSONL line per cycle) is the reference's schema
:data:`~repro_torch.observability.metrics.METRICS_SCHEMA_VERSION`. The
engine's state lives on the card: the observer reads ``bins`` and ``mask``
(for the bin-occupancy imbalance and the advisor's occupancies) once a
cycle, after the cycle has ended, never inside a phase.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.cost_model import CostModel
from . import device_metrics as dm
from .flight import DEFAULT_RING, FlightRecorder
from .metrics import METRICS_SCHEMA_VERSION, MetricsRegistry
from .sinks import jsonify, write_chrome_trace, write_metrics_jsonl
from .tracer import NULL_TRACER, Tracer

# umbrella spans cover a whole cycle/step — they time the container, not a
# task, and must not count toward any rank's busy time
UMBRELLA_SPANS = frozenset({"cycle", "step", "engine_step"})

# stats keys copied into the per-cycle record when the engine provides them
_STAT_KEYS = ("t", "dt_max", "dt", "depth", "substeps", "force_substeps",
              "updates", "global_equiv_updates", "pair_tasks",
              "halo_exported_slots", "halo_full_slots", "nranks",
              "residency")


@dataclass(frozen=True)
class ObserveSpec:
    """What to observe. ``SimulationSpec(observe=True)`` coerces to the
    all-on default; ``observe=ObserveSpec(enabled=True, trace=False)``
    keeps the metrics log without span recording/fencing.

    ``device_metrics`` pulls the engines' in-program telemetry row once
    per cycle (the row is *computed* unconditionally inside the compiled
    programs either way — see ``device_metrics.py`` — so toggling this
    only gates the one host↔device pull and the record fields, never the
    compiled program). ``flight_cycles``/``flight_dir`` size and place
    the flight recorder's post-mortem bundles (dumped on any health
    sentinel trip)."""
    enabled: bool = False
    trace: bool = True
    metrics: bool = True
    device_metrics: bool = True
    flight_cycles: int = DEFAULT_RING
    flight_dir: Optional[str] = None

    # relative per-cycle change of the total-energy fingerprint above
    # which the energy-drift sentinel trips (blowup detector, not a
    # conservation test — SPH with viscosity drifts legitimately)
    energy_drift_tol: float = 0.5


class RunObserver:
    """Collects one run's trace + per-cycle metrics records."""

    def __init__(self, spec: ObserveSpec = ObserveSpec(enabled=True),
                 cost_model: Optional[CostModel] = None):
        self.spec = spec
        self.tracer: Tracer = Tracer() if spec.trace else NULL_TRACER
        self.registry = MetricsRegistry()
        self.records: List[Dict[str, Any]] = []
        self.cycle = 0
        self._span_mark = 0
        # fallback cost model when the engine doesn't carry one (local
        # quadrants) — the measured-vs-modelled report works everywhere
        self._own_cost_model = cost_model or CostModel(rates={})
        # flight recorder: ring of the last K cycles' device-metric rows,
        # plus the span mark at each ring cycle's start so a dump can
        # slice exactly the ring window out of the trace
        self.flight = FlightRecorder(spec.flight_cycles)
        self._cycle_marks = deque(maxlen=max(int(spec.flight_cycles), 1))
        self._last_energy: Optional[float] = None
        # cost-attribution pipeline (schema v3): ledger of measured
        # (units-by-kind, seconds) samples driving CostModel.calibrate,
        # plus the repartition advisor replaying decompose_cells against
        # measured cell weights — both built lazily on first use
        self._ledger = None
        self._advisor = None
        self._advisor_failed = False

    # ---------------------------------------------------------- per cycle
    def end_cycle(self, sim, stats: Dict[str, Any]) -> Dict[str, Any]:
        eng = getattr(sim, "engine", sim)
        self._cycle_marks.append((self.cycle, self._span_mark))
        spans = self.tracer.spans[self._span_mark:]
        self._span_mark = len(self.tracer.spans)

        phase_wall: Dict[str, float] = {}
        phase_count: Dict[str, int] = {}
        phase_units: Dict[str, float] = {}
        busy: Dict[int, float] = {}
        work: Dict[int, float] = {}
        cm = getattr(eng, "_cost_model", None) or self._own_cost_model
        seen_collective = set()
        for s in spans:
            if s.name in UMBRELLA_SPANS:
                continue
            a = s.attrs or {}
            dur = s.dur
            phase_wall[s.name] = phase_wall.get(s.name, 0.0) + dur
            phase_count[s.name] = phase_count.get(s.name, 0) + 1
            busy[s.rank] = busy.get(s.rank, 0.0) + dur
            collective = bool(a.get("collective"))
            if not collective:
                work[s.rank] = work.get(s.rank, 0.0) + dur
            units = a.get("units", a.get("pairs"))
            if units:
                # a collective span is one task duplicated onto every
                # participating rank's row — fold its cost/units once
                key = (s.name, s.t0, s.t1)
                if collective:
                    if key in seen_collective:
                        continue
                    seen_collective.add(key)
                phase_units[s.name] = phase_units.get(s.name, 0.0) \
                    + float(units)
                if hasattr(cm, "observe"):
                    cm.observe(s.name, float(units), dur)

        rec: Dict[str, Any] = {
            "schema": METRICS_SCHEMA_VERSION,
            "cycle": self.cycle,
            "wall": float(stats.get("wall", 0.0)),
        }
        for k in _STAT_KEYS:
            if k in stats:
                rec[k] = stats[k]
        if "bin_hist" in stats:
            rec["bin_hist"] = [int(x) for x in np.asarray(stats["bin_hist"])]
        if spans:
            rec["phase_wall"] = phase_wall
            rec["phase_count"] = phase_count
            rec["phase_units"] = phase_units
            rec["rank_busy"] = {int(r): v for r, v in sorted(busy.items())}
            base = work if work else busy
            vals = list(base.values())
            mean = sum(vals) / len(vals) if vals else 0.0
            rec["imbalance"] = (max(vals) / mean) if mean > 0 else 1.0
            wall = rec["wall"]
            if wall > 0 and busy:
                mean_busy = sum(busy.values()) / len(busy)
                rec["dead_frac"] = max(0.0, 1.0 - mean_busy / wall)

        # ---- engine ledgers, copied verbatim (exact-agreement contract)
        transfers = getattr(eng, "transfers", None)
        if transfers is not None:
            rec["transfers"] = transfers.stats()
        probe = getattr(eng, "probe", None)
        if probe is not None:
            rec["compiles"] = probe.counts()
            rec["total_compiles"] = probe.total_compiles()
        transport = getattr(eng, "_transport", None)
        if transport is not None:
            rec["transport"] = transport.stats()
            # the wire's bucket events (the reference adds its fused
            # programs' policy, device residency only: item 11b)
            buckets = getattr(transport, "buckets", None)
            rec["bucket_events"] = (len(buckets.events)
                                    if buckets is not None else 0)
        for k in ("bins_refreshes", "repartitions"):
            if hasattr(eng, k):
                rec[k] = getattr(eng, k)

        # per-rank time-averaged work imbalance of the decomposition (the
        # repartition trigger's own metric, logged every cycle)
        if hasattr(eng, "_assignment") and "depth" in stats:
            try:
                from ..core.decompose import bin_occupancy_imbalance
                from ..sph.engine import host_array
                from ..sph.timebins import cell_bin_histogram
                bins_h = host_array(eng.state.bins)
                mask_h = host_array(eng.state.cells.mask)
                obb = cell_bin_histogram(bins_h, mask_h,
                                         int(stats["depth"]) + 1)
                rec["bin_occupancy_imbalance"] = float(
                    bin_occupancy_imbalance(eng._assignment, obb,
                                            eng.nranks))
            except Exception:       # diagnostics must never kill the run
                pass

        # ---- device metrics: the telemetry row the engine accumulated
        # and adopted once this cycle (schema v2), plus the per-cell work
        # vectors of the same cycle (schema v3)
        dmx = getattr(eng, "device_metrics_last", None)
        cell_work = getattr(eng, "device_cell_work_last", None) \
            if self.spec.device_metrics else None
        rec["cell_work"] = dm.cell_work_record(cell_work)
        # the joint rate fit is fed by the reference's fused programs
        # (device residency, item 11b); host paths time each phase and
        # leave it None, as the reference's host paths do
        rec["cost_calibration"] = None
        rec["advisor"] = None
        if self.spec.device_metrics and dmx is not None:
            counts, values = dmx
            summary = dm.summarize(counts, values)
            rec["device_metrics"] = summary
            rec["device_imbalance"] = summary["imbalance"]
            du = dm.phase_units(summary)
            rec["device_phase_units"] = du
            # health: the row's sentinel flags + the host-side
            # energy-drift check on the fingerprint
            energy = [fp["energy_total"]
                      for fp in dm.fingerprint(np.asarray(values))]
            e_tot = (sum(e for e in energy if e is not None)
                     if any(e is not None for e in energy) else None)
            drift = False
            if e_tot is not None and self._last_energy is not None:
                ref = max(abs(self._last_energy), 1e-12)
                drift = abs(e_tot - self._last_energy) / ref \
                    > self.spec.energy_drift_tol
            self._last_energy = e_tot
            tripped = bool(summary["tripped"]) or drift
            rec["health"] = {"flags": summary["flags"],
                             "energy_drift": drift, "tripped": tripped}
            self.flight.record(self.cycle, counts, values)
            if tripped:
                reason = drift and "energy-drift" or next(
                    (k.replace("flag_", "") for k, v in
                     summary["flags"].items() if v), "sentinel")
                rec["flight_dump"] = self.dump_flight(reason=reason)

        # ---- repartition advisor: replay the graph partitioner against
        # the measured per-cell weights (advisory only — nothing moves)
        if cell_work is not None and hasattr(eng, "_assignment") \
                and int(getattr(eng, "nranks", 1)) > 1:
            advisor = self._get_advisor(eng)
            if advisor is not None:
                try:
                    ledger = self._get_ledger(cm)
                    weights = ledger.cell_weights(cell_work)
                    adv = advisor.advise(eng._assignment, weights)
                    rec["advisor"] = {
                        "current_imbalance":
                            float(adv["current_imbalance"]),
                        "candidate_imbalance":
                            float(adv["candidate_imbalance"]),
                        "advised_imbalance":
                            float(adv["advised_imbalance"]),
                        "accepted": bool(adv["accepted"]),
                        "per_cell_ratio": ledger.per_cell_ratio(
                            cell_work, advisor.modelled_weights),
                    }
                except Exception:   # diagnostics must never kill the run
                    pass

        # ---- cost-model feedback summary (always present: the schema-v3
        # record carries these keys even before any observation lands)
        rec["cost_ratios"] = cm.measured_vs_modelled() \
            if hasattr(cm, "measured_vs_modelled") else {}
        rec["observed_units"] = (
            {k: cm.observed_units(k) for k in cm.observed}
            if hasattr(cm, "observed_units") else {})

        self._update_registry(rec)
        if self.spec.metrics:
            rec["metrics"] = self.registry.snapshot()
            self.records.append(jsonify(rec))
        self.cycle += 1
        return rec

    # ------------------------------------------------- cost attribution
    def _get_ledger(self, cm):
        """The run's TaskCostLedger, bound to the resolved cost model on
        first use (the model is stable per run)."""
        if self._ledger is None:
            from .costs import TaskCostLedger
            self._ledger = TaskCostLedger(cm)
        return self._ledger

    def _get_advisor(self, eng):
        """Build the repartition advisor once from the engine's grid and
        pair structure (structure changes rarely; weights every cycle).
        Engines without the required surface (spec/pairs/_assignment)
        simply get no advisor block."""
        if self._advisor is not None or self._advisor_failed:
            return self._advisor
        try:
            spec = getattr(eng, "spec", None)
            pairs = getattr(eng, "pairs", None)
            nranks = int(getattr(eng, "nranks", 1))
            if spec is None or pairs is None or nranks <= 1:
                self._advisor_failed = True
                return None
            from ..sph.engine import build_taskgraph, host_array
            from .costs import RepartitionAdvisor
            occ = host_array(eng.state.cells.mask).sum(axis=1) \
                .astype(np.int64)
            g = build_taskgraph(spec, pairs, occ,
                                getattr(eng, "_cost_model", None))
            self._advisor = RepartitionAdvisor(
                g, spec.ncells, nranks,
                seed=int(getattr(eng, "_seed", 0)))
        except Exception:       # diagnostics must never kill the run
            self._advisor_failed = True
        return self._advisor

    # ------------------------------------------------------ flight recorder
    def dump_flight(self, *, reason: str,
                    out_dir: Optional[str] = None) -> str:
        """Write a post-mortem bundle of the flight ring + trace slice.

        Called automatically on a sentinel trip; callers (the ``dump``
        CLI) may invoke it directly. Returns the bundle directory."""
        base = out_dir or self.spec.flight_dir \
            or os.environ.get("REPRO_FLIGHT_DIR", "flight-dumps")
        mark = self._cycle_marks[0][1] if self._cycle_marks else 0
        return self.flight.dump(base, reason=reason, cycle=self.cycle,
                                spans=self.tracer.spans[mark:])

    def _update_registry(self, rec: Dict[str, Any]) -> None:
        reg = self.registry
        tr = rec.get("transfers")
        if tr:
            reg.count("transfer_boundary_bytes",
                      sum(tr["boundary_bytes"].values()))
            reg.count("transfer_intra_bytes", sum(tr["intra_bytes"].values()))
            reg.count("transfer_total_bytes", tr["total_bytes"])
        if "total_compiles" in rec:
            reg.count("compiles_total", rec["total_compiles"])
        tp = rec.get("transport")
        if tp:
            reg.count("transport_host_bytes", tp.get("host_bytes", 0))
            reg.count("transport_exchanges", tp.get("exchanges", 0))
        if "halo_exported_slots" in rec:
            reg.inc("halo_exported_slots", rec["halo_exported_slots"])
            reg.inc("halo_full_slots", rec.get("halo_full_slots", 0))
        if "bucket_events" in rec:
            reg.count("bucket_events", rec["bucket_events"])
        for k in ("bins_refreshes", "repartitions"):
            if k in rec:
                reg.count(k, rec[k])
        du = rec.get("device_phase_units")
        if du:
            for kind, units in du.items():
                reg.inc(f"device_units_{kind}", units)
        adv = rec.get("advisor")
        if adv:
            reg.gauge("advisor_current_imbalance", adv["current_imbalance"])
            reg.gauge("advisor_advised_imbalance", adv["advised_imbalance"])
        cal = rec.get("cost_calibration")
        if cal and cal.get("residual") is not None:
            reg.gauge("calibration_residual", cal["residual"])
        health = rec.get("health")
        if health:
            reg.inc("sentinel_trips", 1 if health["tripped"] else 0)
            for name, n in health["flags"].items():
                reg.inc(f"sentinel_{name}", n)
        if "flight_dump" in rec:
            reg.inc("flight_dumps", 1)
        reg.inc("cycles", 1)
        reg.inc("updates", rec.get("updates", 0))
        reg.inc("pair_tasks", rec.get("pair_tasks", 0))
        for k in ("imbalance", "dead_frac", "bin_occupancy_imbalance",
                  "device_imbalance"):
            if rec.get(k) is not None:
                reg.gauge(k, rec[k])
        if "depth" in rec:
            reg.gauge("depth", rec["depth"])

    # -------------------------------------------------------------- export
    def export_chrome_trace(self, path: str,
                            process_name: str = "repro") -> Dict[str, Any]:
        return write_chrome_trace(path, self.tracer.spans,
                                  self.tracer.t_origin, process_name)

    def write_metrics_jsonl(self, path: str) -> None:
        write_metrics_jsonl(path, self.records)
