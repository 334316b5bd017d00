"""``python -m repro_torch.fleet`` — the serving entry point.

Port of ``repro.fleet.__main__``: drives a fleet of simulation requests
through the batched runner on the card (``--device cpu`` for the plain
PyTorch path):

    python -m repro_torch.fleet --scenario sedov --requests 64
    python -m repro_torch.fleet --scenario mixed --requests 8 \
        --check-parity --assert-compiles --trace-out fleet_trace.json

Requests are heterogeneous in *values* (seed, blast energy, shear speed —
the spec fields a program signature ignores) and homogeneous in *shape*
per scenario, so a mixed fleet exercises exactly the grouping the
subsystem exists for: one entry point per (signature, batch bucket), every
request bit for bit the same spec run alone.

``--waves`` splits the submissions into bursts with wobbling sizes so the
no-shrink bucket policy is exercised; ``--check-parity`` re-runs every
request on the single-simulation path on the same device and compares bit
for bit (the port serves from one card, so the batched path is always the
exact one); ``--assert-compiles`` fails the process if any entry point saw
more than one input signature. Exit status is nonzero on any failed
request or failed check.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _specs(args):
    from ..sph.api import SimulationSpec
    scenarios = {
        "sedov": lambda i: SimulationSpec(
            scenario="sedov",
            scenario_params={"n_side": args.n_side, "seed": i,
                             "e0": 1.0 + 0.1 * (i % 4)}),
        "kelvin_helmholtz": lambda i: SimulationSpec(
            scenario="kelvin_helmholtz",
            scenario_params={"n_side": args.n_side, "seed": i,
                             "v_shear": 0.4 + 0.05 * (i % 3)}),
    }
    if args.scenario == "mixed":
        names = sorted(scenarios)
        return [scenarios[names[i % len(names)]](i)
                for i in range(args.requests)]
    return [scenarios[args.scenario](i) for i in range(args.requests)]


def _waves(n, nwaves):
    """Split n submissions into nwaves bursts with wobbling sizes."""
    if nwaves <= 1:
        return [n]
    wobble = [3, 7, 5, 8]
    sizes, left, i = [], n, 0
    while left > 0 and len(sizes) < nwaves - 1:
        take = min(wobble[i % len(wobble)], left)
        sizes.append(take)
        left -= take
        i += 1
    if left:
        sizes.append(left)
    return sizes


def check_parity(served, device) -> dict:
    """Re-run every served request that returned particles on the single-
    simulation path on ``device``; compare the five particle fields and
    ``t`` bit for bit. Also the single runs' wall and particle-steps."""
    import numpy as np
    from .runner import sequential_reference
    parity = {"mode": "bitwise", "checked": 0, "mismatches": [],
              "wall_s": 0.0, "particle_steps": 0}
    t0 = time.perf_counter()
    for r in served:
        if r.result is None or not r.result.particles:
            continue
        ref = sequential_reference(r.spec, r.n_steps, device=device)
        parity["checked"] += 1
        parity["particle_steps"] += len(ref.particles["mass"]) * r.n_steps
        for k, a in r.result.particles.items():
            a, b = np.asarray(a), np.asarray(ref.particles[k])
            if a.tobytes() != b.tobytes():
                parity["mismatches"].append(
                    {"request": r.request_id, "field": k,
                     "max_abs": float(np.max(np.abs(a - b)))})
        if r.result.t != ref.t:
            parity["mismatches"].append(
                {"request": r.request_id, "field": "t",
                 "max_abs": abs(r.result.t - ref.t)})
    parity["wall_s"] = time.perf_counter() - t0
    return parity


def serve(argv=None):
    """Parse ``argv``, serve the fleet and run the checks asked for:
    (exit status, the JSON summary, the runner, the served requests)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="Serve a fleet of SPH simulation requests as "
                    "signature-grouped batches of stacked lanes.")
    ap.add_argument("--scenario", default="sedov",
                    choices=["sedov", "kelvin_helmholtz", "mixed"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4,
                    help="steps each request runs")
    ap.add_argument("--n-side", type=int, default=5,
                    help="IC lattice side (shape param: sets the signature)")
    ap.add_argument("--batch-max", type=int, default=64)
    ap.add_argument("--waves", type=int, default=1,
                    help="submit in this many wobbling-size bursts")
    ap.add_argument("--fleet-devices", type=int, default=None,
                    help="the port serves from one card: None or 1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch path)")
    ap.add_argument("--check-parity", action="store_true",
                    help="compare every request bit for bit against the "
                         "single-simulation path on the same device")
    ap.add_argument("--assert-compiles", action="store_true",
                    help="fail if any entry point saw more than one input "
                         "signature")
    ap.add_argument("--trace-out", default=None,
                    help="write the multi-request Chrome trace here")
    args = ap.parse_args(argv)

    from .queue import RequestState
    from .runner import FleetRunner

    runner = FleetRunner(max_batch=args.batch_max,
                         fleet_devices=args.fleet_devices,
                         observe=args.trace_out is not None,
                         device=args.device)
    specs = _specs(args)
    served = []
    it = iter(specs)
    t0 = time.perf_counter()
    for size in _waves(len(specs), args.waves):
        for _ in range(size):
            runner.submit(next(it), n_steps=args.steps)
        served.extend(runner.drain())
    wall = time.perf_counter() - t0

    failed = [r for r in served if r.state is not RequestState.DONE]
    for r in failed:
        print(f"FAILED {r.request_id}: {r.error!r}", file=sys.stderr)

    parity = check_parity(served, runner.device) if args.check_parity \
        else None

    stats = runner.stats()
    out = {
        "requests": len(specs),
        "scenario": args.scenario,
        "steps": args.steps,
        "device": str(runner.device),
        "wall_s": wall,
        "particle_steps_per_s": stats["particle_steps"] / wall,
        "stats": stats,
        "compile_counts": runner.compile_counts(),
        "latencies": {r.request_id: r.latency for r in served},
        "parity": parity,
    }
    if args.trace_out:
        import os
        parent = os.path.dirname(args.trace_out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        doc = runner.export_trace(args.trace_out)
        out["trace"] = {"path": args.trace_out,
                        "events": len(doc["traceEvents"])}
    rc = 0
    if failed:
        rc = 1
    if parity is not None and (parity["mismatches"] or not parity["checked"]):
        print(f"PARITY FAILED: {parity}", file=sys.stderr)
        rc = 1
    if args.assert_compiles:
        try:
            runner.assert_compile_discipline()
        except AssertionError as e:
            print(str(e), file=sys.stderr)
            rc = 1
    return rc, out, runner, served


def main(argv=None) -> int:
    rc, out, _, _ = serve(argv)
    json.dump(out, sys.stdout, indent=2, default=str)
    print()
    return rc


if __name__ == "__main__":
    sys.exit(main())
