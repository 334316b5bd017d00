"""One traced Sedov run → validated ``trace.json`` + ``metrics.jsonl``
(port of ``python -m repro.observability``).

The acceptance harness of the port's observability:

    PYTHONPATH=src python -m repro_torch.observability --ranks 4 --cycles 1 \\
        --out-dir observability-artifacts [--device cpu]

runs the time-bin × distributed engine (collective wire, host residency;
``--residency device`` runs the fused device-resident sub-steps instead)
with tracing on, on the CUDA
device unless ``--device`` names another, exports the Chrome trace and the
per-cycle metrics log, validates the trace against the minimal schema, and
asserts the record's byte/compile counters agree exactly with the engine's
``TransferProbe``/``CompileProbe``. With device metrics enabled (the
default) it also checks the telemetry rows: per-rank per-phase work
present, the per-cell attribution summing to the phase totals, exactly one
ledgered ``metrics`` pull per cycle. Exit status 0 means every check
passed.

The ``dump`` subcommand exercises the flight recorder end to end:

    python -m repro_torch.observability dump --inject-nan --out-dir flight-dumps

runs the same scenario, optionally corrupts one velocity component with a
NaN before the last cycle (tripping the NaN sentinel), and validates the
post-mortem bundle that results. ``dump --validate PATH`` just validates an
existing bundle.

The ``advise`` subcommand is the offline what-if repartition analysis:

    python -m repro_torch.observability advise --metrics metrics.jsonl
    python -m repro_torch.observability advise --ranks 4 --cycles 2

renders the per-rank cost-attribution table and the repartition advisor's
current-vs-advised imbalance trend, either from an existing metrics log or
from a fresh short clustered run (host wire).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def run_spec(n_side: int = 6, ranks: int = 4, transport: str = "collective",
             residency: str = "host", out_dir: str = "."):
    """The traced run's spec: Sedov ``n_side``³ (the reference's
    conformance physics, depth-4 ladder) over ``ranks`` ranks, flight
    bundles under ``out_dir``."""
    from repro_torch.sph import SimulationSpec, SPHConfig
    return SimulationSpec(
        scenario="sedov",
        scenario_params={"n_side": n_side, "e0": 1.0, "seed": 0},
        physics=SPHConfig(alpha_visc=1.0, cfl=0.15),
        integrator="timebin", backend="distributed", ranks=ranks,
        dt_max=0.02, max_depth=4,
        transport=transport, residency=residency,
        observe={"flight_dir": out_dir})


def _spec(args):
    return run_spec(args.n_side, args.ranks, args.transport, args.residency,
                    args.out_dir)


def _add_run_args(ap, cycles: int, out_dir: str) -> None:
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=cycles)
    ap.add_argument("--out-dir", default=out_dir)
    ap.add_argument("--residency", default="host",
                    choices=("host", "device"),
                    help="'device' keeps the ranks' states on the card "
                         "and runs one fused program per sub-step")
    ap.add_argument("--transport", default="collective",
                    choices=("host", "collective"))
    ap.add_argument("--n-side", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch path)")


def check_run(sim, doc, ranks: int, cycles: int,
              device_metrics: bool = True):
    """The acceptance checks on a traced, stepped simulation and its
    exported Chrome-trace document ``doc``: returns the list of failures
    (empty = every check passed). At device residency a sub-step is one
    fused slice per rank, and the exchange column's per-cell sum is exact
    too."""
    import numpy as np
    from repro_torch.observability import jsonify, validate_chrome_trace
    obs, eng = sim.observer, sim.engine
    failures = []
    errors = validate_chrome_trace(doc)
    if errors:
        failures.append(f"trace schema: {errors[:5]}")

    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    rows = {e["tid"] for e in xs}
    if rows != set(range(ranks)):
        failures.append(f"expected one row per rank 0..{ranks - 1}, "
                        f"got {sorted(rows)}")
    # one phase slice per force sub-step on every rank: a density and a
    # force slice, or one fused slice at device residency
    resident = getattr(eng, "residency", "host") == "device"
    per_sub = ("fused_substep", "fused_final") if resident \
        else ("density", "force")
    nsub = sum(r["force_substeps"] for r in obs.records)
    for r in sorted(rows):
        got = sum(1 for e in xs if e["tid"] == r and e["name"] in per_sub)
        if got < nsub:
            failures.append(f"rank {r}: {got} phase slices < "
                            f"{nsub} force sub-steps")

    # JSONL counters agree exactly with the live probes
    rec = obs.records[-1]
    if rec["compiles"] != jsonify(eng.probe.counts()):
        failures.append(f"compile counters diverged: {rec['compiles']} != "
                        f"{eng.probe.counts()}")
    if rec["total_compiles"] != eng.probe.total_compiles():
        failures.append("total_compiles diverged")
    if rec["transfers"] != jsonify(eng.transfers.stats()):
        failures.append(f"transfer ledger diverged: {rec['transfers']} != "
                        f"{eng.transfers.stats()}")

    if device_metrics:
        dmx = rec.get("device_metrics")
        if not dmx:
            failures.append("no device_metrics in the cycle record")
        else:
            # per-cell attribution sums exactly to the phase-unit totals
            # (halo replicas fold onto their owner cell); the exchange
            # column is receiver-side truth, exact only at device
            # residency (the host ladder splits shipped slots evenly)
            cw = eng.device_cell_work_last
            if cw is None:
                failures.append("no device_cell_work_last on the engine")
            else:
                cells = np.asarray(cw["cells"])
                per_rank = np.asarray(cw["per_rank"])
                cols = list(cw["columns"])
                du = rec.get("device_phase_units") or {}
                exact = ("density", "force") + (
                    ("exchange",) if resident else ())
                for kind in exact:
                    tot = float(cells[:, cols.index(kind)].sum())
                    want = float(du.get(kind, 0.0))
                    if abs(tot - want) > 1e-6 * max(want, 1.0):
                        failures.append(
                            f"per-cell {kind} units {tot} != device "
                            f"phase total {want}")
                if not np.allclose(cells.sum(axis=0), per_rank.sum(axis=0)):
                    failures.append(
                        "per-cell column sums disagree with per-rank "
                        f"attribution: {cells.sum(axis=0)} vs "
                        f"{per_rank.sum(axis=0)}")
            if len(dmx["per_rank_work"]) != ranks:
                failures.append(
                    f"device per_rank_work has "
                    f"{len(dmx['per_rank_work'])} rows != {ranks}")
            if not all(w > 0 for w in dmx["per_rank_work"]):
                failures.append(f"device per-rank work not all positive: "
                                f"{dmx['per_rank_work']}")
            if rec.get("device_imbalance") is None \
                    and sum(dmx["per_rank_work"]) > 0:
                failures.append("device_imbalance missing")
            if "health" not in rec:
                failures.append("health block missing")
        pulls = eng.transfers.stats()["boundary_events"].get("metrics", 0)
        if pulls != cycles:
            failures.append(f"{pulls} ledgered metrics pulls != "
                            f"{cycles} cycles (pull-once contract)")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.observability",
        description="traced Sedov run + trace/metrics export & validation")
    _add_run_args(ap, cycles=1, out_dir=".")
    ap.add_argument("--no-device-metrics", action="store_true",
                    help="do not adopt the per-cycle telemetry rows")
    args = ap.parse_args(argv)

    from repro_torch.analysis.report import advisor_trend, attribution_table
    from repro_torch.observability import jsonify
    from repro_torch.sph import build_simulation

    spec = _spec(args)
    if args.no_device_metrics:
        spec = spec.with_(observe={"device_metrics": False,
                                   "flight_dir": args.out_dir})
    sim = build_simulation(spec, device=args.device)
    for _ in range(args.cycles):
        sim.step()
    obs = sim.observer

    os.makedirs(args.out_dir, exist_ok=True)
    trace_path = os.path.join(args.out_dir, "trace.json")
    metrics_path = os.path.join(args.out_dir, "metrics.jsonl")
    doc = obs.export_chrome_trace(trace_path,
                                  process_name="sedov traced run")
    obs.write_metrics_jsonl(metrics_path)
    trend_path = os.path.join(args.out_dir, "advisor_trend.txt")
    with open(trend_path, "w") as f:
        f.write(attribution_table(obs.records) + "\n\n"
                + advisor_trend(obs.records) + "\n")

    failures = check_run(sim, doc, args.ranks, args.cycles,
                         not args.no_device_metrics)
    rec = obs.records[-1]
    summary = {
        "ranks": args.ranks, "cycles": args.cycles,
        "residency": args.residency, "device": str(sim.engine.device),
        "spans": sum(1 for e in doc["traceEvents"] if e.get("ph") == "X"),
        "force_substeps": sum(r["force_substeps"] for r in obs.records),
        "imbalance": rec.get("imbalance"),
        "device_imbalance": rec.get("device_imbalance"),
        "device_phase_units": rec.get("device_phase_units"),
        "health": rec.get("health"),
        "dead_frac": rec.get("dead_frac"),
        "bin_occupancy_imbalance": rec.get("bin_occupancy_imbalance"),
        "total_compiles": rec.get("total_compiles"),
        "cell_work": rec.get("cell_work"),
        "cost_calibration": rec.get("cost_calibration"),
        "advisor": rec.get("advisor"),
        "trace": trace_path, "metrics": metrics_path,
        "advisor_trend": trend_path,
        "ok": not failures,
    }
    print(json.dumps(jsonify(summary), indent=1))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    return 0


def inject_nan(eng) -> None:
    """Poison one alive particle's velocity on the engine's global mirror:
    the next cycle scatters it onto the ranks and the sentinel must catch
    it."""
    import torch
    cells = eng.state.cells
    alive = torch.nonzero(cells.mask > 0)
    c, p = (int(x) for x in alive[0])
    vel = cells.vel.clone()
    vel[c, p, 0] = float("nan")
    eng.state = eng.state._replace(cells=cells._replace(vel=vel))


def dump_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.observability dump",
        description="produce (and validate) a flight-recorder post-mortem "
                    "bundle; --inject-nan trips the NaN sentinel on purpose")
    _add_run_args(ap, cycles=2, out_dir="flight-dumps")
    ap.add_argument("--inject-nan", action="store_true",
                    help="corrupt one velocity component before the last "
                         "cycle so the NaN sentinel trips")
    ap.add_argument("--validate", metavar="PATH",
                    help="only validate an existing bundle directory")
    args = ap.parse_args(argv)

    from repro_torch.observability.flight import validate_bundle

    if args.validate:
        manifest = validate_bundle(args.validate)
        print(json.dumps({"bundle": args.validate,
                          "manifest": manifest, "ok": True}, indent=1))
        return 0

    import numpy as np
    from repro_torch.observability import jsonify
    from repro_torch.sph import build_simulation

    sim = build_simulation(_spec(args), device=args.device)
    for n in range(args.cycles):
        if args.inject_nan and n == args.cycles - 1:
            inject_nan(sim.engine)
        with np.errstate(invalid="ignore"):
            sim.step()
    obs = sim.observer

    dumps = list(obs.flight.dumps)
    if not dumps:
        # no sentinel tripped (healthy run without --inject-nan): dump the
        # ring explicitly so the bundle path is exercised either way
        dumps = [obs.dump_flight(reason="manual")]

    out = []
    for path in dumps:
        manifest = validate_bundle(path)
        out.append({"bundle": path, "reason": manifest["reason"],
                    "cycle": manifest["cycle"],
                    "records": manifest["records"]})
    tripped = bool(obs.records and obs.records[-1]
                   .get("health", {}).get("tripped"))
    print(json.dumps(jsonify({"dumps": out, "tripped": tripped,
                              "ok": True}), indent=1))
    if args.inject_nan and not tripped:
        print("FAIL: NaN injected but no sentinel tripped", file=sys.stderr)
        return 1
    return 0


def advise_main(argv=None) -> int:
    """Offline what-if repartition analysis (schema v3).

    With ``--metrics`` renders the cost-attribution table and advisor
    trend from an existing per-cycle JSONL (any supported schema — pre-v3
    logs render '-' markers). Without it, runs a short clustered scenario
    on a rank partition (host wire) and advises on its measured cell
    weights.
    """
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.observability advise",
        description="offline what-if repartition analysis: attribution "
                    "table + advisor trend from a metrics.jsonl, or from "
                    "a fresh short clustered run")
    ap.add_argument("--metrics", metavar="PATH",
                    help="existing metrics.jsonl to analyse")
    ap.add_argument("--scenario", default="clustered")
    ap.add_argument("--n", type=int, default=96,
                    help="particle count for the fresh-run mode")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--out", metavar="PATH",
                    help="also write the rendered report here")
    ap.add_argument("--device", default=None,
                    help="torch device of the fresh run (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.report import advisor_trend, attribution_table

    if args.metrics:
        from repro_torch.observability import read_metrics_jsonl
        records = read_metrics_jsonl(args.metrics)
    else:
        from repro_torch.sph import SimulationSpec, build_simulation
        spec = SimulationSpec(
            scenario=args.scenario,
            scenario_params={"n": args.n, "seed": 0},
            integrator="timebin", backend="distributed", ranks=args.ranks,
            transport="host", observe=True)
        sim = build_simulation(spec, device=args.device)
        for _ in range(args.cycles):
            sim.step()
        records = sim.observer.records
    report = attribution_table(records) + "\n\n" + advisor_trend(records)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


def run(argv) -> int:
    """Dispatch ``[dump|advise] args...`` to its mode."""
    if argv and argv[0] == "dump":
        return dump_main(argv[1:])
    if argv and argv[0] == "advise":
        return advise_main(argv[1:])
    return main(argv)


if __name__ == "__main__":
    raise SystemExit(run(sys.argv[1:]))
