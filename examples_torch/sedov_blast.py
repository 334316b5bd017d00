"""Sedov–Taylor point explosion with hierarchical time bins, on the
PyTorch/CUDA port.

The scenario the time-bin subsystem exists for: a blast wave in a cold
uniform gas produces a CFL time-step contrast of >3 decades between the
hot centre and the quiescent background. The multi-dt engine integrates
each particle at its own power-of-two step — only the blast region burns
compute — while the global-dt engine would grind everything at the
minimum.

Prints per cycle: the time-bin histogram, the fraction of particle
updates actually performed vs the global-dt equivalent, energy drift,
and the shock radius against the analytic Sedov solution
r_s(t) = ξ (E t² / ρ)^{1/5}, ξ ≈ 1.15 for γ = 5/3.

The engine runs on the CUDA device unless ``--device cpu`` is given.
``--max-depth`` caps the bin ladder (default 10, the reference's; the
ladder goes non-finite at 10 after a few cycles, and each level doubles a
cycle's deepest sub-steps, so a quick run takes 4).

Run:  python examples_torch/sedov_blast.py [n_side] [ncycles]
      [--max-depth D] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_side", nargs="?", type=int, default=12)
    ap.add_argument("ncycles", nargs="?", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    n_side, ncycles = args.n_side, args.ncycles

    from repro_torch.sph import (SPHConfig, SimulationSpec, assign_bins,
                                 build_simulation, sedov_ic)
    from repro_torch.sph.physics import cfl_timestep_block

    ic = sedov_ic(n_side, e0=1.0, seed=0)
    n = len(ic["pos"])
    cfg = SPHConfig(alpha_visc=1.0, cfl=0.15)
    spec = SimulationSpec(
        scenario="sedov", scenario_params={"n_side": n_side, "e0": 1.0,
                                           "seed": 0},
        physics=cfg, integrator="timebin", backend="local",
        dt_max=0.02, max_depth=args.max_depth)
    sim = build_simulation(spec, ic=ic, device=args.device).engine

    # raw CFL spread of the IC — the dynamic range the bins quantise
    cells = sim.state.cells
    dts = cfl_timestep_block(cells.h, cells.u, cells.vel, cells.mask,
                             gamma=cfg.gamma, cfl=cfg.cfl).cpu().numpy()
    live = dts[cells.mask.cpu().numpy() > 0]
    spread = float(live.max() / live.min())
    raw_bins = assign_bins(live, float(live.max()), 32)
    print(f"N = {n}, CFL dt spread = {spread:.1e} "
          f"({np.log10(spread):.1f} decades, "
          f"{int(raw_bins.max()) + 1} power-of-two bins) on "
          f"{cells.pos.device}")

    e_start, _ = sim.diagnostics()
    print("\ncycle       t  depth  upd_frac  dE_rel   r_shock  r_sedov")
    for c in range(ncycles):
        stats = sim.run_cycle()
        e_now, _ = sim.diagnostics()
        frac = stats["updates"] / stats["global_equiv_updates"]
        # shock radius: mass-weighted radius of the fastest decile
        st = sim.state.cells
        m = st.mask.cpu().numpy() > 0
        pos = st.pos.cpu().numpy()[m]
        v = np.linalg.norm(st.vel.cpu().numpy()[m], axis=-1)
        d = pos - ic["box"] / 2.0
        d -= ic["box"] * np.round(d / ic["box"])
        r = np.linalg.norm(d, axis=-1)
        fast = v > max(np.percentile(v, 90), 1e-6)
        r_shock = float(np.median(r[fast])) if fast.any() else 0.0
        t = stats["t"]
        r_sedov = 1.15 * (1.0 * t * t) ** 0.2
        print(f"{c:5d}  {t:6.3f}  {stats['depth']:5d}  {frac:8.3f}  "
              f"{(e_now - e_start) / abs(e_start):+.2e}  {r_shock:7.3f}  "
              f"{r_sedov:7.3f}")
        print(f"       bins: {[int(x) for x in stats['bin_hist']]}")

    print(f"\ntotal particle updates: {sim.particle_updates} "
          f"(global-dt equivalent: {sim.global_equiv_updates}, "
          f"saved {1 - sim.particle_updates / sim.global_equiv_updates:.1%})")


if __name__ == "__main__":
    main()
