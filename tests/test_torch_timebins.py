"""Port parity: the hierarchical time-bin ladder (``repro_torch.sph.timebins``).

Per phase first: reference state is injected into the port's phase
functions through ``repro_torch.sph.convert`` and the outputs compared —
``bins``, ``t_start`` and the active count exactly, float fields within
float32 rounding (1e-6 of each field's scale where both sides do the same
elementwise arithmetic on the same inputs; 5e-5 where a pair pass sums in
another order). Then two-cycle trajectories on the conformance scenarios
(tests/test_conformance.py): the ladder's counts (depth, sub-steps, force
sub-steps, particle updates, pair tasks) and the bins exactly, float fields
within 1e-4 of each field's scale — the port's pair passes contract
momentum in double-float where the reference's default vmapped blocks sum
in f32, and two cycles compound that rounding.
"""

import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.sph as R
from repro.sph import timebins as rtb
from repro.sph.engine import _force_pass as ref_force_pass
import repro_torch.sph as P
from repro_torch.sph import timebins as ptb
from repro_torch.sph.cellgrid import pair_arrays
from repro_torch.sph.convert import (pairs_to_torch, timebin_state_to_torch,
                                     to_numpy)
from repro_torch.sph.engine import f32
from torch_threads import one_torch_thread  # noqa: F401

SCENARIOS = {
    "sedov": dict(scenario="sedov",
                  scenario_params={"n_side": 6, "e0": 1.0, "seed": 0},
                  alpha=1.0, cfl=0.15, dt_max=0.02, max_depth=4),
    "kelvin_helmholtz": dict(
        scenario="kelvin_helmholtz",
        scenario_params={"n_side": 5, "v_shear": 0.5, "seed": 0},
        alpha=1.0, cfl=0.2, dt_max=0.01, max_depth=3),
}
COUNTS = ("depth", "substeps", "force_substeps", "updates", "pair_tasks")
T = lambda a: torch.from_numpy(np.array(a))


def _specs(name):
    kw = dict(SCENARIOS[name])
    alpha, cfl = kw.pop("alpha"), kw.pop("cfl")
    kw.update(integrator="timebin", backend="local")
    return (R.SimulationSpec(physics=R.SPHConfig(alpha_visc=alpha, cfl=cfl),
                             **kw),
            P.SimulationSpec(physics=P.SPHConfig(alpha_visc=alpha, cfl=cfl),
                             **kw))


def _close(got, want, rel, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=name)


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def trajectories(request):
    spec_r, spec_p = _specs(request.param)
    ref = R.build_simulation(spec_r)
    port = P.build_simulation(spec_p, device="cpu")
    stats = [(ref.step(), port.step()) for _ in range(2)]
    return request.param, ref, port, stats


def test_two_cycle_trajectory_matches_reference(trajectories):
    name, ref, port, stats = trajectories
    for a, b in stats:
        for k in COUNTS:
            assert a[k] == b[k], (name, k)
        assert a["t"] == b["t"] and a["dt_max"] == b["dt_max"]
        np.testing.assert_array_equal(a["bin_hist"], b["bin_hist"])
    want = {k: np.asarray(v) for k, v in ref.state._asdict().items()
            if k != "cells"}
    want.update({k: np.asarray(v)
                 for k, v in ref.state.cells._asdict().items()})
    got = to_numpy(port.state)
    got.update(got.pop("cells"))
    m = want["mask"] > 0
    for k in ("mask", "bins", "t_start", "time", "h", "mass"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["pos"][m], want["pos"][m], atol=1e-6)
    for k in ("vel", "u", "accel", "dudt", "rho", "omega"):
        _close(got[k][m], want[k][m], 1e-4, f"{name}: {k}")
    e_r, p_r = ref.diagnostics()
    e_p, p_p = port.diagnostics()
    assert e_p == pytest.approx(e_r, rel=1e-5)


@pytest.fixture(scope="module")
def injected():
    """A reference ladder stopped at its first interior force sub-step of
    the second Sedov cycle, with every input of the phase functions."""
    spec_r, _ = _specs("sedov")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        sim = R.build_simulation(spec_r).engine
    sim.run_cycle()
    cfg = sim.cfg
    dt_max_c, depth = sim._plan_cycle()
    state = sim._jit_start(sim.state, jnp.float32(dt_max_c))
    mask_h = np.asarray(state.cells.mask)
    bins_h = np.asarray(state.bins)
    wake = sim._wake_floor(bins_h, mask_h)
    # the first interior sub-step at which some particle is due
    for n in range(1, 1 << depth):
        level = rtb.active_level(n, depth)
        active_p = (((bins_h >= level) | (bins_h < wake[:, None]))
                    & (mask_h > 0))
        if active_p.any():
            break
    assert active_p.any()
    state = sim._jit_drift(state, jnp.float32(n * dt_max_c / (1 << depth)))
    sub, pmask, nlive = sim._pair_subset(active_p.any(axis=1))
    active = rtb.substep_active_mask(state, jnp.int32(level),
                                     jnp.asarray(wake))
    u_floor = float(rtb.mass_weighted_mean_u(
        np.asarray(state.cells.mass * state.cells.mask),
        np.asarray(state.cells.u)))
    return dict(sim=sim, cfg=cfg, state=state, sub=sub, pmask=pmask,
                active=active, wake=wake, level=level, depth=depth,
                dt_max=dt_max_c, u_floor=u_floor, ncells=sim.spec.ncells)


def _port_cfg(cfg):
    return P.SPHConfig(**{k: getattr(cfg, k) for k in
                          ("kernel", "alpha_visc", "gamma", "n_target",
                           "adapt_h", "cfl", "use_pallas")})


def test_convert_round_trip_is_bitwise(injected):
    st = timebin_state_to_torch(injected["state"])
    back = to_numpy(st)
    want = to_numpy(injected["state"])
    assert back["bins"].dtype == np.int32 and st.time.dim() == 0
    for k, v in want.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                assert back[k][kk].tobytes() == vv.tobytes(), kk
        else:
            assert back[k].tobytes() == v.tobytes(), k


def test_active_mask_and_density_phase_match(injected):
    d = injected
    st = timebin_state_to_torch(d["state"])
    sub = pairs_to_torch(d["sub"], d["ncells"])
    active = ptb.substep_active_mask(st, d["level"], T(d["wake"]))
    np.testing.assert_array_equal(active.numpy(), np.asarray(d["active"]))
    want = rtb._substep_density_phase(d["state"], d["sub"], d["pmask"],
                                      d["active"], cfg=d["cfg"])
    got = ptb._substep_density_phase(st, sub, T(d["pmask"]), active,
                                     cfg=_port_cfg(d["cfg"]))
    m = np.asarray(d["state"].cells.mask) > 0
    for name, g, w in zip(("rho", "omega", "press", "cs"), got, want):
        _close(g.numpy()[m], np.asarray(w)[m], 5e-5, name)


def test_force_kick_phase_matches(injected):
    """Same inputs (the reference's pair sums) → same kick: bins, t_start
    and the active count exactly, velocities and energies to rounding."""
    d = injected
    rho, omega, press, cs = rtb._substep_density_phase(
        d["state"], d["sub"], d["pmask"], d["active"], cfg=d["cfg"])
    dv, du = ref_force_pass(d["state"].cells, d["sub"], rho, press, omega,
                            cs, d["cfg"], pair_mask=d["pmask"])
    want, nact_r = rtb._apply_force_kick(
        d["state"], d["active"], dv, du, rho, omega, jnp.asarray(d["wake"]),
        jnp.float32(d["dt_max"]), jnp.int32(d["depth"]),
        jnp.float32(d["u_floor"]), cfg=d["cfg"])
    st = timebin_state_to_torch(d["state"])
    got, nact_p = ptb._apply_force_kick(
        st, T(d["active"]), T(dv), T(du), T(rho), T(omega), T(d["wake"]),
        f32(d["dt_max"], "cpu"), d["depth"], f32(d["u_floor"], "cpu"),
        cfg=_port_cfg(d["cfg"]))
    assert int(nact_p) == int(nact_r) > 0
    np.testing.assert_array_equal(got.bins.numpy(), np.asarray(want.bins))
    np.testing.assert_array_equal(got.t_start.numpy(),
                                  np.asarray(want.t_start))
    for name in ("vel", "u", "pos"):
        _close(getattr(got.cells, name).numpy(),
               np.asarray(getattr(want.cells, name)), 1e-6, name)
    for name in ("accel", "dudt"):
        _close(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
               1e-6, name)


def test_final_kick_phase_matches(injected):
    d = injected
    cfg = d["cfg"]
    full = d["sim"].pairs
    ones = jnp.ones(len(np.asarray(full.ci)), jnp.float32)
    active = d["state"].cells.mask
    rho, omega, press, cs = rtb._substep_density_phase(
        d["state"], full, ones, active, cfg=cfg)
    dv, du = ref_force_pass(d["state"].cells, full, rho, press, omega, cs,
                            cfg, pair_mask=ones)
    want = rtb._apply_final_kick(d["state"], dv, du, rho, omega,
                                 jnp.float32(d["dt_max"]), cfg=cfg)
    got = ptb._apply_final_kick(timebin_state_to_torch(d["state"]), T(dv),
                                T(du), T(rho), T(omega),
                                f32(d["dt_max"], "cpu"), cfg=_port_cfg(cfg))
    np.testing.assert_array_equal(got.t_start.numpy(),
                                  np.asarray(want.t_start))
    np.testing.assert_array_equal(got.bins.numpy(), np.asarray(want.bins))
    for name in ("vel", "u"):
        _close(getattr(got.cells, name).numpy(),
               np.asarray(getattr(want.cells, name)), 1e-6, name)


def test_composed_substep_matches(injected):
    """The whole interior sub-step (density → force → kick) on injected
    state: bins exact, floats to the pair passes' rounding."""
    d = injected
    want, nact_r = rtb._force_substep(
        d["state"], d["sub"], d["pmask"], jnp.int32(d["level"]),
        jnp.asarray(d["wake"]), jnp.float32(d["dt_max"]),
        jnp.int32(d["depth"]), jnp.float32(d["u_floor"]), cfg=d["cfg"])
    got, nact_p = ptb._force_substep(
        timebin_state_to_torch(d["state"]),
        pairs_to_torch(d["sub"], d["ncells"]), T(d["pmask"]), d["level"],
        T(d["wake"]), f32(d["dt_max"], "cpu"), d["depth"],
        f32(d["u_floor"], "cpu"), cfg=_port_cfg(d["cfg"]))
    assert int(nact_p) == int(nact_r)
    np.testing.assert_array_equal(got.bins.numpy(), np.asarray(want.bins))
    np.testing.assert_array_equal(got.t_start.numpy(),
                                  np.asarray(want.t_start))
    m = np.asarray(d["state"].cells.mask) > 0
    for name in ("accel", "dudt", "rho", "omega"):
        _close(getattr(got, name).numpy()[m],
               np.asarray(getattr(want, name))[m], 5e-5, name)


def test_host_planning_matches_reference():
    """Cycle plans from the same initial conditions: dt_max, depth and the
    limited bins exactly."""
    spec_r, spec_p = _specs("sedov")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = R.build_simulation(spec_r).engine
    port = P.build_simulation(spec_p, device="cpu").engine
    assert ref._plan_cycle() == port._plan_cycle()
    np.testing.assert_array_equal(port.state.bins.numpy(),
                                  np.asarray(ref.state.bins))


def test_bin_math_matches_reference():
    rng = np.random.default_rng(4)
    dt = (10.0 ** rng.uniform(-6, 0, (30, 16))).astype(np.float32)
    dt[0, :3] = np.inf
    for max_bin in (0, 4, 10):
        want = rtb.assign_bins(dt, 0.5, max_bin)
        np.testing.assert_array_equal(ptb.assign_bins(dt, 0.5, max_bin),
                                      want)
        got_t = ptb.assign_bins(T(dt), torch.tensor(np.float32(0.5)),
                                max_bin)
        np.testing.assert_array_equal(got_t.numpy(), want)
    bins = np.arange(11, dtype=np.int32)
    np.testing.assert_array_equal(
        ptb.bin_timestep(torch.tensor(np.float32(0.02)), T(bins)).numpy(),
        np.asarray(rtb.bin_timestep(jnp.float32(0.02), jnp.asarray(bins))))
    x = rng.random(1000).astype(np.float32)
    m = rng.random(1000).astype(np.float32)
    assert ptb.tree_sum(x) == rtb.tree_sum(x)
    assert ptb.mass_weighted_mean_u(m, x) == rtb.mass_weighted_mean_u(m, x)
    vel = rng.standard_normal((50, 3)).astype(np.float32)
    np.testing.assert_array_equal(ptb.speed_norm(vel), rtb.speed_norm(vel))


@pytest.mark.parametrize("ns", [2, 3, 5])
def test_neighbour_limiter_matches_reference(ns):
    spec = P.choose_grid(1.0, 1.0 / ns, 100)
    ci, cj, _ = pair_arrays(spec)
    rng = np.random.default_rng(ns)
    bins = rng.integers(0, 3, (spec.ncells, 8)).astype(np.int32)
    bins[0, 0] = 9
    mask = rng.random((spec.ncells, 8)) > 0.3
    want = rtb.limit_neighbour_bins(bins, mask, ci, cj, delta=2, max_bin=10)
    got = ptb.limit_neighbour_bins(bins, mask, ci, cj, delta=2, max_bin=10)
    np.testing.assert_array_equal(got, want)


def _ic_two_temperature(n_side=6, seed=0, ratio=64.0):
    ic = P.uniform_ic(n_side, seed=seed, temperature=0.5)
    hot = ic["pos"][:, 0] > ic["box"] / 2
    u = ic["u"].copy()
    u[hot] *= ratio
    ic["u"] = u
    rng = np.random.default_rng(seed + 1)
    ic["vel"] = (0.02 * rng.standard_normal(ic["vel"].shape)
                 ).astype(np.float32)
    return ic


def test_depth_zero_cycle_matches_global_engine():
    """With every particle in bin 0 the ladder is exactly one KDK step
    (the reference's test, on the port)."""
    ic = _ic_two_temperature()
    cfg = P.SPHConfig(alpha_visc=0.8)
    dt = 1e-3
    args = (ic["pos"], ic["vel"], ic["mass"], ic["u"], ic["h"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        tb = P.TimeBinSimulation(*args, box=ic["box"], cfg=cfg, dt_max=dt,
                                 depth_headroom=0, rebin_each_cycle=False,
                                 device="cpu")
        gl = P.Simulation(*args, box=ic["box"], cfg=cfg,
                          rebin_every=10 ** 9, device="cpu")
    stats = tb.run_cycle()
    assert stats["depth"] == 0 and stats["substeps"] == 1
    gl.run(1, dt=dt)
    m = tb.state.cells.mask.numpy() > 0
    np.testing.assert_allclose(tb.state.cells.pos.numpy()[m],
                               gl.state.cells.pos.numpy()[m], atol=1e-6)
    np.testing.assert_allclose(tb.state.cells.vel.numpy()[m],
                               gl.state.cells.vel.numpy()[m], atol=1e-6)
    np.testing.assert_allclose(tb.state.cells.u.numpy()[m],
                               gl.state.cells.u.numpy()[m], rtol=1e-5)


def test_run_twice_bitwise_deterministic():
    _, spec = _specs("kelvin_helmholtz")
    snaps = []
    for _ in range(2):
        sim = P.build_simulation(spec, device="cpu")
        sim.step()
        snaps.append(to_numpy(sim.state))
    a, b = snaps
    for k in a["cells"]:
        assert a["cells"][k].tobytes() == b["cells"][k].tobytes(), k
    for k in a:
        if k != "cells":
            assert a[k].tobytes() == b[k].tobytes(), k


def test_device_metric_rows_match_reference():
    """The ladder's host-built telemetry rows (counts, work units, per-cell
    attribution) equal the reference's; the state fingerprint agrees to the
    trajectory tolerance, except |Σ m v|, which is conserved and so is pure
    f32 round-off on both sides (held within 1e-7 of the unit total mass
    times unit speed)."""
    spec_r, spec_p = _specs("sedov")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = R.build_simulation(spec_r).engine
    port = P.build_simulation(spec_p, device="cpu").engine
    for eng in (ref, port):
        eng.device_metrics_enabled = True
        eng.run_cycle()
    (cr, vr), (cp, vp) = ref.device_metrics_last, port.device_metrics_last
    np.testing.assert_array_equal(cp, cr)
    mom = P.timebins.dmetrics.VALUE_INDEX["momentum_abs"]
    keep = np.arange(vr.shape[1]) != mom
    np.testing.assert_allclose(vp[:, keep], vr[:, keep], rtol=1e-4)
    np.testing.assert_allclose(vp[:, mom], vr[:, mom], atol=1e-7)
    for k in ("cells", "per_rank"):
        np.testing.assert_array_equal(port.device_cell_work_last[k],
                                      ref.device_cell_work_last[k])
    assert port.device_metrics_pulls == ref.device_metrics_pulls == 1


def test_tracing_is_invisible_and_records_the_ladder():
    from repro_torch.observability import Tracer
    _, spec = _specs("kelvin_helmholtz")
    plain = P.build_simulation(spec, device="cpu")
    traced = P.build_simulation(spec, device="cpu")
    traced.engine.tracer = Tracer()
    plain.step()
    traced.step()
    a, b = to_numpy(plain.state), to_numpy(traced.state)
    for k in a["cells"]:
        assert a["cells"][k].tobytes() == b["cells"][k].tobytes(), k
    names = {s.name for s in traced.engine.tracer.spans}
    assert {"cycle", "plan", "start", "drift", "final", "rebin"} <= names
