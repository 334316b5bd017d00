"""Port parity: the device schedule of the time-bin × distributed quadrant
against the reference's own device schedule.

The reference's ``schedule="device"`` programs run under this jax (they
are built with ``check_rep=False``; its host-scheduled fused path is the
one that fails with ``pvary``, ROADMAP queue 3), so they are an oracle
here: one subprocess whose jax has four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
tests/test_torch_distributed.py runs it) runs 4 cycles of the
conformance scenarios (tests/test_conformance.py:47-60) at K = 1 and
K = 4 in both collective modes, and the port runs the same specs.

* Every cycle's stats (depth, sub-steps, force sub-steps, updates, pair
  tasks, halo slots, ``t``, ``dt_max``, ``bin_hist``) equal the
  reference's exactly, and so do ``segments`` and ``segment_aborts``.
* At each segment boundary ``mask``, ``bins``, ``t_start``, ``time``,
  ``h`` and ``mass`` are exact, ``pos`` within 1e-6 and the other floats
  within 1e-4 of each field's scale: the port's pair passes contract
  momentum in double-float where the reference's blocks sum in float32
  (ROADMAP queue 3, "Known parity limits").
* The Kelvin–Helmholtz K = 4 segment crosses a cell in both packages and
  aborts; the reference's replay then runs its host-scheduled fused path,
  which raises ``pvary`` under this jax, so there the comparison is the
  abort itself (the port's replay is held bit for bit to its host
  schedule in tests/test_torch_dist_schedule.py).

Both packages run at ``capacity_margin=1.0``, as that file's runs do.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro_torch.sph as P
from repro_torch.sph.convert import to_numpy
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCYC = 4
SCENARIOS = {
    "sedov": dict(scenario="sedov",
                  scenario_params={"n_side": 6, "e0": 1.0, "seed": 0},
                  alpha=1.0, cfl=0.15, dt_max=0.02, max_depth=4),
    "kelvin_helmholtz": dict(
        scenario="kelvin_helmholtz",
        scenario_params={"n_side": 5, "v_shear": 0.5, "seed": 0},
        alpha=1.0, cfl=0.2, dt_max=0.01, max_depth=3),
}
CASES = [("sedov", 1, "ppermute"), ("sedov", 4, "allgather"),
         ("kelvin_helmholtz", 1, "allgather"),
         ("kelvin_helmholtz", 4, "ppermute")]
COUNTS = ("depth", "substeps", "force_substeps", "updates", "pair_tasks",
          "global_equiv_updates", "global_equiv_pair_tasks",
          "halo_exported_slots", "halo_full_slots", "nranks", "t", "dt_max")
FIELDS = ("pos", "vel", "mass", "u", "h", "mask", "accel", "dudt", "rho",
          "omega", "bins", "t_start", "time")

# Runs the reference's device schedule on each case and saves every
# cycle's stats and the state at each segment boundary; a case whose
# replay raises records the abort count and the error.
_REF = """
import numpy as np
from repro.sph import SimulationSpec, SPHConfig, build_simulation

def reference_runs(scenarios, cases, ncyc, fields, counts):
    out = {}
    for name, K, mode in cases:
        kw = dict(scenarios[name])
        phys = SPHConfig(alpha_visc=kw.pop("alpha"), cfl=kw.pop("cfl"))
        sim = build_simulation(SimulationSpec(
            physics=phys, **kw, integrator="timebin",
            backend="distributed", ranks=4, transport="collective",
            transport_mode=mode, residency="device", schedule="device",
            segment_cycles=K, capacity_margin=1.0))
        tag = f"{name}.{K}.{mode}."
        try:
            for c in range(ncyc):
                s = sim.step()
                for k in counts:
                    out[tag + f"{c}.{k}"] = np.asarray(s[k])
                out[tag + f"{c}.bin_hist"] = np.asarray(s["bin_hist"])
                if (c + 1) % K == 0:
                    st = sim.engine.state
                    for k in fields:
                        src = st.cells if hasattr(st.cells, k) else st
                        out[tag + f"{c}.state.{k}"] = np.asarray(
                            getattr(src, k))
        except ValueError as exc:
            out[tag + "error"] = np.asarray(str(exc)[:200])
        out[tag + "segments"] = np.asarray(sim.engine.segments)
        out[tag + "segment_aborts"] = np.asarray(sim.engine.segment_aborts)
    return out
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "device_schedule.npz")
    script = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = \\
            "--xla_force_host_platform_device_count=4"
        sys.path.insert(0, os.path.join({ROOT!r}, "src"))
        import numpy as np
        import jax
        jax.config.update("jax_default_matmul_precision", "float32")
        assert len(jax.devices()) == 4
    """) + _REF + textwrap.dedent(f"""
        np.savez({path!r}, **reference_runs({SCENARIOS!r}, {CASES!r},
                                            {NCYC}, {FIELDS!r}, {COUNTS!r}))
    """)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _close(got, want, rel, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=name)


def _port_run(name, K, mode):
    kw = dict(SCENARIOS[name])
    phys = P.SPHConfig(alpha_visc=kw.pop("alpha"), cfl=kw.pop("cfl"))
    sim = P.build_simulation(P.SimulationSpec(
        physics=phys, **kw, integrator="timebin", backend="distributed",
        ranks=4, transport="collective", transport_mode=mode,
        residency="device", schedule="device", segment_cycles=K,
        capacity_margin=1.0), device="cpu")
    stats, states = [], {}
    for c in range(NCYC):
        stats.append(sim.step())
        if (c + 1) % K == 0:
            st = to_numpy(sim.engine.state)
            st.update(st.pop("cells"))
            states[c] = st
    return sim.engine, stats, states


@pytest.mark.parametrize("name,K,mode", CASES)
def test_device_schedule_tracks_reference(reference, name, K, mode):
    tag = f"{name}.{K}.{mode}."
    eng, stats, states = _port_run(name, K, mode)
    assert eng.segments == int(reference[tag + "segments"])
    assert eng.segment_aborts == int(reference[tag + "segment_aborts"])
    if tag + "error" in reference:
        # the reference aborted this segment and its replay raised
        assert name == "kelvin_helmholtz" and K == 4
        assert "pvary" in str(reference[tag + "error"])
        assert eng.segment_aborts == 1 and eng.segment_flags_last["crossed"]
        return
    assert eng.segment_aborts == 0
    for c, s in enumerate(stats):
        for k in COUNTS:
            assert s[k] == reference[tag + f"{c}.{k}"], (c, k)
        np.testing.assert_array_equal(s["bin_hist"],
                                      reference[tag + f"{c}.bin_hist"])
    for c, got in states.items():
        want = {k: reference[tag + f"{c}.state.{k}"] for k in FIELDS}
        m = want["mask"] > 0
        for k in ("mask", "bins", "t_start", "time", "h", "mass"):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"cycle {c}: {k}")
        np.testing.assert_allclose(got["pos"][m], want["pos"][m], atol=1e-6)
        for k in ("vel", "u", "accel", "dudt", "rho", "omega"):
            _close(got[k][m], want[k][m], 1e-4, f"cycle {c}: {k}")
