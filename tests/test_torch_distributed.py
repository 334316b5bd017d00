"""Port parity: the global × distributed quadrant (``repro_torch.sph.
distributed``) against the reference's ``repro.sph.distributed``.

* The plan (``build_dist_plan``) from the port's own task graph and
  partition equals the reference's array for array.
* The two halo schemes over the stacked rank axis give the same bits, and
  the halos hold the owners' rows.
* One step on the reference's state, injected: 1 rank in this process,
  4 ranks against a reference run in a subprocess with four host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``). Within rtol
  1e-4 and atol 1e-4 of each field's scale, the tolerances of
  tests/test_torch_engine.py: the port's pair loops run the kernels' plain
  versions (double-float momentum, sums in plan order), the reference's its
  vmapped blocks.
* The reference's conformance contract for this quadrant
  (tests/test_conformance.py), through ``build_simulation(...,
  device="cpu")``: run-twice bitwise, and tracking the local global-dt
  engine within float32 accumulation-order tolerances.
"""

import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import decompose_cells
from repro_torch.sph import SimulationSpec, SPHConfig, build_simulation
from repro_torch.sph.cellgrid import bin_particles, build_pair_list, \
    choose_grid
from repro_torch.sph.convert import cells_to_torch
from repro_torch.sph.distributed import _exchange, build_dist_plan, \
    dist_tables, gather_from_devices, make_dist_step, scatter_to_devices
from repro_torch.sph.engine import build_taskgraph, f32
from repro_torch.sph.ic import sedov_ic, uniform_ic
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 0.004
# the reference's conformance scenario (tests/test_conformance.py:49-53)
SEDOV = dict(scenario="sedov", scenario_params={"n_side": 6, "e0": 1.0,
                                                "seed": 0},
             physics=SPHConfig(alpha_visc=1.0, cfl=0.15))
PLAN_FIELDS = ("ndev", "K", "B", "Bi", "Pmax", "assignment", "storage",
               "export_slots", "export_valid", "import_flat", "import_valid",
               "pair_recv", "pair_src", "pair_shift", "pair_w", "ring_rounds",
               "ring_pick")
STATE_FIELDS = ("pos", "vel", "u", "accel", "dudt", "rho")

# Builds the reference's global × distributed engine on the conformance
# scenario and dumps its plan, its initial state and its state after one
# step. Run in this process (1 rank) or in a subprocess whose jax has four
# host devices.
_REF_DUMP = """
import numpy as np
from repro.sph import SimulationSpec, SPHConfig, build_simulation

def reference_dump(ranks, halo, dt):
    spec = SimulationSpec(
        scenario="sedov", scenario_params={"n_side": 6, "e0": 1.0, "seed": 0},
        physics=SPHConfig(alpha_visc=1.0, cfl=0.15), integrator="global",
        backend="distributed", ranks=ranks, halo=halo, dt=dt)
    eng = build_simulation(spec).engine
    out = {"plan." + k: np.asarray(getattr(eng.plan, k))
           for k in %r}
    def snap(tag):
        for k in ("pos", "vel", "mass", "u", "h", "mask"):
            out[tag + k] = np.asarray(getattr(eng.dcells, k))
        for k in ("accel", "dudt", "rho"):
            out[tag + k] = np.asarray(getattr(eng, k))
    snap("s0.")
    eng.step(dt)
    snap("s1.")
    return out
""" % (PLAN_FIELDS,)


def _reference_in_process(ranks, halo):
    scope = {}
    exec(_REF_DUMP, scope)
    return scope["reference_dump"](ranks, halo, DT)


def _reference_in_subprocess(ranks, halo, path):
    script = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = \\
            "--xla_force_host_platform_device_count={ranks}"
        sys.path.insert(0, os.path.join({ROOT!r}, "src"))
        import numpy as np
        import jax
        jax.config.update("jax_default_matmul_precision", "float32")
        assert len(jax.devices()) == {ranks}
    """) + _REF_DUMP + textwrap.dedent(f"""
        np.savez({path!r}, **reference_dump({ranks}, {halo!r}, {DT!r}))
    """)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _port_plan(ic, ranks, seed=0, capacity_margin=3.0):
    """The port's decomposition of ``ic``: grid, cells, pairs, plan."""
    spec = choose_grid(ic["box"], float(ic["h"].max()), len(ic["pos"]),
                       capacity_margin=capacity_margin)
    cells, _ = bin_particles(spec, ic["pos"], ic["vel"], ic["mass"],
                             ic["u"], ic["h"], device="cpu")
    pairs = build_pair_list(spec)
    tg = build_taskgraph(spec, pairs, cells.mask.sum(1))
    dec = decompose_cells(tg, spec.ncells, ranks, seed=seed)
    return spec, cells, pairs, build_dist_plan(spec.ncells, pairs,
                                               dec.assignment, ranks)


def _assert_plan_equal(plan, ref):
    for k in PLAN_FIELDS:
        got, want = np.asarray(getattr(plan, k)), ref["plan." + k]
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _assert_step_matches(ref, ranks, halo):
    """Inject the reference's initial state, take one port step with the
    port's own plan, and hold it to the reference's step."""
    _, _, _, plan = _port_plan(sedov_ic(6, e0=1.0, seed=0), ranks)
    _assert_plan_equal(plan, ref)
    cells = cells_to_torch({k: ref["s0." + k] for k in
                            ("pos", "vel", "mass", "u", "h", "mask")}, "cpu")
    step, init = make_dist_step(plan, SEDOV["physics"], 1.0, halo=halo,
                                device="cpu")
    accel, dudt, rho = init(cells)
    for name, got in (("accel", accel), ("dudt", dudt), ("rho", rho)):
        want = ref["s0." + name]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg="init " + name)
    out, accel, dudt, rho = step(cells, torch.from_numpy(ref["s0.accel"]),
                                 torch.from_numpy(ref["s0.dudt"]),
                                 f32(DT, "cpu"))
    got = dict(pos=out.pos, vel=out.vel, u=out.u, accel=accel, dudt=dudt,
               rho=rho)
    for name in STATE_FIELDS:
        want = ref["s1." + name]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    np.testing.assert_array_equal(out.mask.numpy(), ref["s1.mask"])


@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
@pytest.mark.parametrize("scenario", ["sedov6", "uniform8"])
def test_build_dist_plan_matches_reference(scenario, ranks):
    from repro.core import decompose_cells as ref_decompose
    from repro.sph.cellgrid import bin_particles as ref_bin
    from repro.sph.cellgrid import build_pair_list as ref_pairs
    from repro.sph.cellgrid import choose_grid as ref_grid
    from repro.sph.distributed import build_dist_plan as ref_plan
    from repro.sph.engine import build_taskgraph as ref_taskgraph
    ic = sedov_ic(6, seed=0) if scenario == "sedov6" else uniform_ic(8)
    _, _, _, plan = _port_plan(ic, ranks)
    spec = ref_grid(ic["box"], float(ic["h"].max()), len(ic["pos"]),
                    capacity_margin=3.0)
    cells, _ = ref_bin(spec, ic["pos"], ic["vel"], ic["mass"], ic["u"],
                       ic["h"])
    pairs = ref_pairs(spec)
    tg = ref_taskgraph(spec, pairs, np.asarray(cells.mask.sum(axis=1)))
    dec = ref_decompose(tg, spec.ncells, ranks, seed=0)
    want = ref_plan(spec.ncells, pairs, dec.assignment, ranks)
    _assert_plan_equal(plan, {"plan." + k: np.asarray(getattr(want, k))
                              for k in PLAN_FIELDS})


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_exchange_allgather_equals_ring(ranks):
    """Both schemes deliver each import's owner row, bit for bit, and zero
    in padding slots (whose sign may differ, as in the reference: the
    allgather's padding is row 0 × 0.0, the ring's +0 × 0.0; no pair entry
    reads them); fields of every shape the step ships."""
    _, cells, _, plan = _port_plan(uniform_ic(8), ranks)
    t = dist_tables(plan, "cpu")
    rng = np.random.default_rng(ranks)
    rows, C = plan.ndev * plan.K, cells.mass.shape[1]
    fields = (torch.from_numpy(rng.standard_normal((rows, C, 3)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal((rows, C)).astype(
            np.float32)))
    a = _exchange(fields, t, "allgather")
    b = _exchange(fields, t, "ring")
    assert plan.ring_rounds >= 1
    valid = torch.from_numpy(plan.import_valid.reshape(-1) > 0)
    for x, y, f in zip(a, b, fields):
        assert x.shape == (plan.ndev * plan.Bi,) + f.shape[1:]
        assert torch.equal(x[valid].view(torch.int32),
                           y[valid].view(torch.int32))
        assert not x[~valid].any() and not y[~valid].any()
        want = torch.zeros_like(x)
        for d in range(plan.ndev):
            for i in range(plan.Bi):
                if plan.import_valid[d, i] > 0:
                    src, slot = divmod(int(plan.import_flat[d, i]), plan.B)
                    row = src * plan.K + int(plan.export_slots[src, slot])
                    want[d * plan.Bi + i] = f[row]
        assert torch.equal(x, want)


def test_scatter_gather_round_trip():
    spec, cells, _, plan = _port_plan(sedov_ic(6, seed=0), 4)
    stacked = scatter_to_devices(cells, plan)
    assert stacked.pos.shape == (plan.ndev * plan.K,) + cells.pos.shape[1:]
    back = gather_from_devices(stacked, plan, spec.ncells)
    assert all(torch.equal(x, y) for x, y in zip(back, cells))


@pytest.mark.parametrize("halo", ["allgather", "ring"])
def test_one_rank_step_on_injected_reference_state(halo):
    _assert_step_matches(_reference_in_process(1, halo), 1, halo)


def test_four_ranks_step_matches_reference_subprocess(tmp_path):
    ref = _reference_in_subprocess(4, "ring", str(tmp_path / "ref4.npz"))
    for halo in ("allgather", "ring"):
        _assert_step_matches(ref, 4, halo)


def _dist_spec(ranks, halo, **kw):
    return SimulationSpec(**SEDOV, integrator="global", dt=DT,
                          backend="distributed", ranks=ranks, halo=halo, **kw)


def _final_state(sim):
    e = sim.engine
    return [t.clone() for t in tuple(e.dcells) + (e.accel, e.dudt, e.rho)]


RERUN = [(1, "ring"), (2, "allgather"), (4, "ring")]


@pytest.fixture(scope="module")
def dist_runs():
    """Each (ranks, halo) built and stepped once, the RERUN ones twice:
    their engines and final states."""
    runs = {}
    for ranks in (1, 2, 4):
        for halo in ("allgather", "ring"):
            for k in range(2 if (ranks, halo) in RERUN else 1):
                sim = build_simulation(_dist_spec(ranks, halo), device="cpu")
                sim.step()
                runs[(ranks, halo, k)] = (sim, _final_state(sim))
    return runs


def _bits(ts):
    return [t.view(torch.int32) for t in ts]


@pytest.mark.parametrize("ranks,halo", RERUN)
def test_run_twice_bitwise(dist_runs, ranks, halo):
    (sim, a), (_, b) = (dist_runs[(ranks, halo, k)] for k in range(2))
    assert all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b)))
    assert sim.time == DT
    e = sim.engine
    assert e.plan.ndev == ranks and e.decomp.nranks == ranks
    assert e.dcells.pos.shape[0] == ranks * e.plan.K
    assert e.device_metrics_enabled is False
    assert set(e.setup_s) == {"taskgraph", "decompose", "plan"}


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_allgather_equals_ring_bitwise(dist_runs, ranks):
    a = dist_runs[(ranks, "allgather", 0)][1]
    b = dist_runs[(ranks, "ring", 0)][1]
    assert all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b)))


@pytest.mark.parametrize("ranks", [1, 4])
def test_tracks_local_engine(ranks):
    """tests/test_conformance.py::test_global_distributed_tracks_local_
    reference, on the port: 3 steps against the local engine (which must
    not re-bin: the distributed engine never does)."""
    local = build_simulation(SimulationSpec(**SEDOV, integrator="global",
                                            dt=DT, rebin_every=100),
                             device="cpu")
    dist = build_simulation(_dist_spec(ranks, "ring", rebin_every=100),
                            device="cpu")
    for _ in range(3):
        local.step()
        dist.step()
    e_l, p_l = local.diagnostics()
    e_d, p_d = dist.diagnostics()
    assert e_d == pytest.approx(e_l, rel=1e-5)
    np.testing.assert_allclose(p_d, p_l, atol=1e-5)
    g = dist.engine.gather_cells()
    for name in ("pos", "u"):
        np.testing.assert_allclose(
            getattr(g, name).numpy(),
            getattr(local.engine.state.cells, name).numpy(),
            rtol=2e-5, atol=2e-6, err_msg=name)


def test_cfl_dt():
    """Without a fixed dt the step takes the CFL minimum over the gathered
    cells, as the reference's adapter does."""
    from repro_torch.sph.physics import cfl_timestep_block
    spec = SimulationSpec(scenario="uniform", scenario_params={"n_side": 8},
                          integrator="global", backend="distributed",
                          ranks=2)
    sim = build_simulation(spec, device="cpu")
    c = sim.engine.gather_cells()
    want = float(torch.min(cfl_timestep_block(c.h, c.u, c.vel, c.mask,
                                              cfl=spec.physics.cfl)))
    st = sim.step()
    assert st["dt"] == want > 0 and sim.time == want
    e, p = sim.diagnostics()
    assert np.isfinite(e) and np.all(np.isfinite(p))


def test_ranks_default_to_one_and_timebin_still_raises():
    spec = SimulationSpec(scenario="uniform", scenario_params={"n_side": 4},
                          integrator="global", backend="distributed", dt=1e-3)
    assert build_simulation(spec, device="cpu").engine.plan.ndev == 1
    # the time-bin quadrant is ported too: ranks=None builds one rank, at
    # either residency; the device residency's cycle is bit for bit the
    # host residency's
    tb = spec.with_(integrator="timebin", dt_max=2e-3, max_depth=2,
                    transport="collective")
    host = build_simulation(tb, device="cpu")
    eng = host.engine
    assert eng.nranks == 1 and eng._get_plan().nranks == 1
    resident = build_simulation(tb.with_(residency="device"), device="cpu")
    assert resident.engine.nranks == 1
    a, b = host.step(), resident.step()
    assert b["residency"] == "device"
    assert all(a[k] == b[k] for k in ("t", "depth", "force_substeps",
                                      "updates", "pair_tasks"))
    for x, y in zip(list(host.engine.state.cells) + list(
            host.engine.state[1:]), list(resident.engine.state.cells)
            + list(resident.engine.state[1:])):
        assert torch.equal(x, y)
    from repro_torch.sph.distributed import DistSimulation
    _, cells, pairs, _ = _port_plan(uniform_ic(4), 1)
    gs = choose_grid(1.0, float(uniform_ic(4)["h"].max()), 64,
                     capacity_margin=3.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="ranks"):
            DistSimulation(cells, pairs, gs, ranks=0, device="cpu")
