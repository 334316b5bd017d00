"""Quickstart: the paper's pipeline end-to-end at laptop scale, on the
PyTorch/CUDA port.

1. Build a clustered SPH initial condition (EAGLE-like density contrast).
2. Decompose into cells; build the SWIFT task graph (sort → density →
   ghost → force → kick) with dependencies and conflicts.
3. Compile the graph into a wave schedule, partition the cell graph over 4
   simulated ranks, insert send/recv tasks (§3.3), and compare the async
   executor against the bulk-synchronous baseline.
4. Run the real SPH engine for a few steps on the device and verify
   conservation.

Steps 1–3 are host-side planning (numpy); step 4 runs on the CUDA device
unless ``--device cpu`` is given.

Run:  python examples_torch/quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from repro_torch.core import (AsyncExecutorSim, CostModel,
                                  decompose_with_comm, wave_schedule)
    from repro_torch.device import resolve_device
    from repro_torch.sph import (SPHConfig, SimulationSpec, build_simulation,
                                 clustered_ic, uniform_ic)
    from repro_torch.sph.cellgrid import (bin_particles, build_pair_list,
                                          choose_grid)
    from repro_torch.sph.engine import build_taskgraph

    dev = resolve_device(args.device)
    print("=== 1. clustered initial conditions")
    ic = clustered_ic(3000, seed=0)
    print(f"    {len(ic['pos'])} particles, h ∈ "
          f"[{ic['h'].min():.4f}, {ic['h'].max():.4f}] "
          f"({ic['h'].max()/ic['h'].min():.0f}× dynamic range)")

    print("=== 2. cell decomposition + task graph")
    spec = choose_grid(ic["box"], float(np.percentile(ic["h"], 95)), 3000)
    cells, _ = bin_particles(spec, ic["pos"], ic["vel"], ic["mass"],
                             ic["u"], ic["h"], device=dev)
    pairs = build_pair_list(spec, device=dev)
    occupancy = cells.mask.sum(dim=1).cpu().numpy()
    cm = CostModel(rates={})
    g = build_taskgraph(spec, pairs, occupancy, cm)
    # calibrate task costs to seconds (≈2 ns per pair interaction, the
    # measured-cost refinement of §3.2)
    for t in g.tasks.values():
        object.__setattr__(t, "cost", max(t.cost * 2e-9, 1e-8))
    print(f"    {spec.ncells} cells, {len(pairs.ci)} pair tasks, "
          f"{len(g)} tasks total")

    waves = wave_schedule(g)
    cp, _ = g.critical_path()
    print(f"    wave schedule: {len(waves)} waves, critical path "
          f"{cp*1e3:.3g} ms")

    print("=== 3. graph partition + async communication (4 ranks)")
    cell_bytes = [float(max(o, 1)) * 64.0 for o in occupancy]
    dist, dec = decompose_with_comm(
        g, spec.ncells, 4, cell_bytes=cell_bytes,
        phases={"sort": "p0", "density_self": "p1", "density_pair": "p1",
                "ghost": "p2", "force_self": "p3", "force_pair": "p3",
                "kick": "p4"})
    print(f"    partition: {dec.partition.summary()}")
    print(f"    messages: {dec.comm.messages} "
          f"(mean {dec.comm.mean_message_bytes/1024:.2f} kB)")
    kw = dict(ranks=4, threads=2, latency=1.5e-5, bandwidth=5e9)
    a = AsyncExecutorSim(dist, **kw).run()
    s = AsyncExecutorSim(dist, synchronous=True, **kw).run()
    print(f"    async makespan {a.makespan*1e3:.3f} ms "
          f"(eff {a.efficiency:.2f})  vs  sync {s.makespan*1e3:.3f} ms "
          f"(eff {s.efficiency:.2f})  → {s.makespan/a.makespan:.2f}× faster")

    print(f"=== 4. real SPH integration (conservation check) on {dev}")
    rng = np.random.default_rng(1)
    ic2 = uniform_ic(8, seed=2)                  # 512 particles: fast on CPU
    ic2["vel"] = (ic2["vel"]
                  + 0.2 * rng.standard_normal(ic2["vel"].shape)
                  ).astype(np.float32)
    spec = SimulationSpec(scenario="uniform",
                          physics=SPHConfig(alpha_visc=0.8),
                          integrator="global", backend="local",
                          dt=0.004, rebin_every=5)
    sim = build_simulation(spec, ic=ic2, device=dev)
    e0, p0 = sim.diagnostics()
    sim.run(10 * 0.004)
    e1, p1 = sim.diagnostics()
    print(f"    10 steps: |ΔE|/E = {abs(e1-e0)/abs(e0):.2e}, "
          f"|Δp| = {np.abs(p1-p0).max():.2e}")
    print("done.")


if __name__ == "__main__":
    main()
