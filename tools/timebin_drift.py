"""Energy drift of the time-bin Sedov ladder in the JAX reference beside a
second run, on the CPU: the PyTorch port, or the reference itself from
initial conditions one ulp away.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/timebin_drift.py \\
        [n_side=16] [max_depth=4] [cycles=2] [b=port|ulp] [substeps]

Both runs take ``SimulationSpec(scenario="sedov", physics=SPHConfig(
alpha_visc=1.0, cfl=0.15), integrator="timebin", backend="local")`` from
the same initial conditions: with ``b=port`` the second run is the port on
the CPU (through its kernels' plain versions); with ``b=ulp`` it is the
reference again with every particle's u moved up by one float32 ulp, which
shows how far the ladder itself amplifies a rounding difference. One JSON
line per cycle: the ladder's counts from each run, each run's relative
energy drift since the start, whether each run's positions and u are all
finite, whether the time bins agree exactly, and the largest difference in
u relative to its scale (null once the two runs' cell capacities differ,
as after a rebin of non-finite positions). With ``substeps`` it also
prints, before each cycle's line, one line per force sub-step with the
same u difference and whether the bins agree there, to show where the
two runs part.
"""

import json
import sys
import time
import warnings

import numpy as np


def record_substeps(engine, name: str, out: list) -> None:
    """Wrap ``engine``'s force sub-step program so that each call appends
    (u, bins) of the state it returns to ``out``, as numpy."""
    inner = getattr(engine, name)

    def sub(*args):
        state, nact = inner(*args)
        out.append((np.asarray(state.cells.u, np.float64),
                    np.asarray(state.bins)))
        return state, nact

    setattr(engine, name, sub)


def u_rel_diff(u_ref, u_b):
    if u_ref.shape != u_b.shape:
        return None
    return float(np.abs(u_ref - u_b).max() / np.abs(u_ref).max())


def main(n_side: int = 16, max_depth: int = 4, cycles: int = 2,
         b: str = "port", substeps: str = "") -> None:
    import jax
    jax.config.update("jax_default_matmul_precision", "float32")
    import repro.sph as R
    import repro_torch.sph as P
    warnings.simplefilter("ignore", DeprecationWarning)
    kw = dict(scenario="sedov", scenario_params={"n_side": n_side},
              integrator="timebin", backend="local", max_depth=max_depth)
    ref = R.build_simulation(R.SimulationSpec(
        physics=R.SPHConfig(alpha_visc=1.0, cfl=0.15), **kw))
    if b == "port":
        other = P.build_simulation(P.SimulationSpec(
            physics=P.SPHConfig(alpha_visc=1.0, cfl=0.15), **kw),
            device="cpu")
    elif b == "ulp":
        ic = R.make_ic("sedov", n_side=n_side)
        ic["u"] = np.nextafter(ic["u"], np.float32(np.inf))
        other = R.build_simulation(R.SimulationSpec(
            physics=R.SPHConfig(alpha_visc=1.0, cfl=0.15), **kw), ic)
    else:
        raise SystemExit(f"timebin_drift: b must be port or ulp, not {b!r}")
    e_ref0, _ = ref.diagnostics()
    e_b0, _ = other.diagnostics()
    keys = ("depth", "substeps", "force_substeps", "updates", "pair_tasks")

    trace_ref, trace_b = [], []
    if substeps:
        record_substeps(ref.engine, "_jit_sub", trace_ref)
        record_substeps(other.engine, "_sub" if b == "port" else "_jit_sub",
                        trace_b)

    def finite(sim):
        c = sim.state.cells
        return bool(np.isfinite(np.asarray(c.u)).all()
                    and np.isfinite(np.asarray(c.pos)).all())

    for c in range(cycles):
        t0 = time.perf_counter()
        sa = ref.step()
        t1 = time.perf_counter()
        sb = other.step()
        t2 = time.perf_counter()
        for k, ((ua, ba), (ub, bb)) in enumerate(zip(trace_ref, trace_b)):
            print(json.dumps({"cycle": c, "force_substep": k,
                              "u_max_rel_diff": u_rel_diff(ua, ub),
                              "bins_equal": bool(np.array_equal(ba, bb))}),
                  flush=True)
        trace_ref.clear()
        trace_b.clear()
        e_ref, _ = ref.diagnostics()
        e_b, _ = other.diagnostics()
        u_ref = np.asarray(ref.state.cells.u, np.float64)
        u_b = np.asarray(other.state.cells.u, np.float64)
        print(json.dumps({
            "cycle": c, "n_side": n_side, "max_depth": max_depth, "b": b,
            "counts_ref": [sa[k] for k in keys],
            "counts_b": [sb[k] for k in keys],
            "drift_ref": abs(e_ref - e_ref0) / abs(e_ref0),
            "drift_b": abs(e_b - e_b0) / abs(e_b0),
            "finite_ref": finite(ref), "finite_b": finite(other),
            "bins_equal": bool(np.array_equal(np.asarray(ref.state.bins),
                                              np.asarray(other.state.bins))),
            "u_max_rel_diff": u_rel_diff(u_ref, u_b),
            "cpu_seconds_ref": t1 - t0, "cpu_seconds_b": t2 - t1}),
            flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(*(int(a) for a in args[:3]), *args[3:5])
