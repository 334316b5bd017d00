"""Serve a fleet of SPH simulation requests as batched programs, on the
PyTorch/CUDA port.

A request-driven tour of :mod:`repro_torch.fleet`: heterogeneous Sedov and
Kelvin–Helmholtz requests (different blast energies, shear speeds, seeds —
but the same *shapes*) arrive in wobbling bursts, are grouped by program
signature, and each group runs as stacked lanes (one launch of each pair
kernel a step for the whole batch). Completion callbacks fire per request;
the exported Chrome trace shows every request on its own timeline row
(open at https://ui.perfetto.dev).

The fleet serves on the CUDA device unless ``--device cpu`` is given.

Run:  python examples_torch/fleet_serve.py [--trace PATH] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="fleet_trace_example.json",
                    help="where the Chrome trace is written")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from repro_torch.fleet import FleetRunner
    from repro_torch.sph import SimulationSpec

    runner = FleetRunner(observe=True, device=args.device)

    def on_done(req):
        r = req.result
        print(f"  done {req.request_id}  [{req.spec.scenario:>16}] "
              f"E={r.energy:.6f}  batch={r.batch_size}/{r.bucket} "
              f"latency={req.latency * 1e3:.1f} ms")

    # wobbling bursts of value-heterogeneous requests: two signatures
    # (sedov, kelvin_helmholtz shapes), many parameter values
    bursts = [3, 5, 4]
    i = 0
    for burst in bursts:
        for _ in range(burst):
            if i % 2 == 0:
                spec = SimulationSpec(
                    scenario="sedov",
                    scenario_params={"n_side": 4, "seed": i,
                                     "e0": 1.0 + 0.05 * i})
            else:
                spec = SimulationSpec(
                    scenario="kelvin_helmholtz",
                    scenario_params={"n_side": 4, "seed": i,
                                     "v_shear": 0.3 + 0.02 * i})
            runner.submit(spec, n_steps=4, callback=on_done)
            i += 1
        print(f"burst of {burst} submitted; draining…")
        runner.drain()

    stats = runner.stats()
    print(f"\nfleet: {stats['queue']['done']} requests in "
          f"{stats['batches']} batches, {stats['compiles']} compiles "
          f"({stats['programs']} entry points), "
          f"{stats['particle_steps']} particle-steps on {stats['device']}")
    runner.assert_compile_discipline()
    doc = runner.export_trace(args.trace)
    print(f"trace: {args.trace} "
          f"({len(doc['traceEvents'])} events; rows are request_ids)")


if __name__ == "__main__":
    main()
