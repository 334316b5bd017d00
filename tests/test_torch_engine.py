"""Port parity: the global-dt engine (``repro_torch.sph.engine``).

Sedov 6³ with a fixed dt runs 3 KDK steps in both packages from the same
initial conditions. The port's pair passes run the kernels' plain versions
(double-float momentum, ascending sums) where the reference's default runs
its vmapped blocks (f32 sums), so the fields agree to float32 rounding of
the pair sums: positions within 1e-6 of the box, the other fields within
1e-4 of each field's scale. The conservation checks are the reference's
(tests/test_sph_physics.py), run on the port.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.sph import SPHConfig as RefConfig
from repro.sph import Simulation as RefSimulation
from repro.sph.ref_nsquared import nsq_density, nsq_forces
from repro_torch.sph import SPHConfig, Simulation, sedov_ic, uniform_ic
from repro_torch.sph.cellgrid import bin_particles, build_pair_list, \
    choose_grid
from repro_torch.sph.engine import compute_accelerations
from torch_threads import one_torch_thread  # noqa: F401

NSTEPS = 3
DT = 2e-3


def _sim(cls, ic, cfg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return cls(ic["pos"], ic["vel"], ic["mass"], ic["u"], ic["h"],
                   box=ic["box"], cfg=cfg, **kw)


@pytest.fixture(scope="module")
def sedov_runs():
    ic = sedov_ic(6, seed=0)
    ref = _sim(RefSimulation, ic, RefConfig(alpha_visc=1.0, cfl=0.15))
    port = _sim(Simulation, ic, SPHConfig(alpha_visc=1.0, cfl=0.15),
                device="cpu")
    logs = (ref.run(NSTEPS, dt=DT), port.run(NSTEPS, dt=DT))
    return ref, port, logs


def test_sedov_fixed_dt_steps_match_reference(sedov_runs):
    ref, port, _ = sedov_runs
    np.testing.assert_array_equal(port.perm, ref.perm)
    rc, pc = ref.state.cells, port.state.cells
    m = np.asarray(rc.mask) > 0
    np.testing.assert_array_equal(pc.mask.numpy(), np.asarray(rc.mask))
    np.testing.assert_allclose(pc.pos.numpy()[m], np.asarray(rc.pos)[m],
                               atol=1e-6)
    for name in ("vel", "u", "h"):
        want = np.asarray(getattr(rc, name))[m]
        got = getattr(pc, name).numpy()[m]
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    for name in ("accel", "dudt", "rho"):
        want = np.asarray(getattr(ref.state, name))[m]
        got = getattr(port.state, name).numpy()[m]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    assert float(port.state.time) == float(ref.state.time)


def test_step_on_injected_reference_state(sedov_runs):
    """The reference's state carried across (``convert``) and stepped once
    by the port's ``step`` lands where the reference's step lands."""
    import jax.numpy as jnp
    from repro.sph.engine import step as ref_step
    from repro_torch.sph.convert import pairs_to_torch, sph_state_to_torch
    from repro_torch.sph.engine import f32, step
    ref, _, _ = sedov_runs
    cfg_r = ref.cfg
    want = ref_step(ref.state, ref.pairs, jnp.float32(DT), ref.box, cfg_r)
    got = step(sph_state_to_torch(ref.state),
               pairs_to_torch(ref.pairs, ref.spec.ncells), f32(DT, "cpu"),
               ref.box, SPHConfig(alpha_visc=1.0, cfl=0.15))
    m = np.asarray(want.cells.mask) > 0
    np.testing.assert_allclose(got.cells.pos.numpy()[m],
                               np.asarray(want.cells.pos)[m], atol=1e-6)
    for name in ("accel", "dudt", "rho"):
        w = np.asarray(getattr(want, name))[m]
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(getattr(got, name).numpy()[m], w,
                                   rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    assert float(got.time) == float(want.time)


def test_sedov_log_matches_reference(sedov_runs):
    _, _, (log_r, log_p) = sedov_runs
    np.testing.assert_array_equal(log_p["t"], log_r["t"])
    np.testing.assert_allclose(log_p["E"], log_r["E"], rtol=1e-5)


def _setup(n_side=8, seed=0, vel_scale=0.1):
    ic = uniform_ic(n_side, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ic["vel"] = (ic["vel"]
                 + vel_scale * rng.standard_normal(ic["vel"].shape)
                 ).astype(np.float32)
    return ic


def test_port_matches_nsquared_oracle():
    """The port's density → ghost → force chain against the reference's
    O(N²) oracle, at the reference test's tolerances."""
    ic = _setup()
    pos, vel, mass, u, h, box = (ic[k] for k in
                                 ("pos", "vel", "mass", "u", "h", "box"))
    rho_ref, drho_ref, nngb_ref = nsq_density(pos, mass, h, box)
    omega_ref = 1.0 + (h / (3 * rho_ref)) * drho_ref
    dv_ref, du_ref = nsq_forces(pos, vel, mass, u, h, rho_ref, omega_ref,
                                box, alpha_visc=0.8)
    spec = choose_grid(box, float(h.max()), len(pos))
    cells, perm = bin_particles(spec, pos, vel, mass, u, h, device="cpu")
    pairs = build_pair_list(spec)
    dv, du, rho, nngb = compute_accelerations(cells, pairs,
                                              SPHConfig(alpha_visc=0.8))
    valid = perm >= 0
    idx = perm[valid]

    def flat(a):
        a = a.numpy()
        out = np.zeros((len(pos),) + a.shape[2:], np.float32)
        out[idx] = a[valid]
        return out

    np.testing.assert_allclose(flat(rho), np.asarray(rho_ref), rtol=2e-4)
    np.testing.assert_allclose(flat(nngb), np.asarray(nngb_ref), atol=0)
    dv_ref, du_ref = np.asarray(dv_ref), np.asarray(du_ref)
    np.testing.assert_allclose(flat(dv), dv_ref, rtol=2e-3,
                               atol=2e-3 * np.abs(dv_ref).max())
    np.testing.assert_allclose(flat(du), du_ref, rtol=2e-3,
                               atol=2e-3 * np.abs(du_ref).max())


def test_momentum_conserved():
    ic = _setup(vel_scale=0.2)
    sim = _sim(Simulation, ic, SPHConfig(alpha_visc=0.8), rebin_every=3,
               device="cpu")
    _, p0 = sim.diagnostics()
    sim.run(8, dt=0.004)
    _, p1 = sim.diagnostics()
    assert np.abs(p1 - p0).max() < 1e-6


def test_energy_drift_small_and_converging():
    drifts = []
    for dt, nsteps in ((0.02, 5), (0.01, 10)):
        ic = _setup(vel_scale=0.2)
        sim = _sim(Simulation, ic, SPHConfig(alpha_visc=0.0),
                   rebin_every=100, device="cpu")
        e0, _ = sim.diagnostics()
        sim.run(nsteps, dt=dt)
        e1, _ = sim.diagnostics()
        drifts.append(abs(e1 - e0) / abs(e0))
    assert drifts[0] < 0.01
    assert drifts[1] < drifts[0]


def test_viscosity_dissipates_kinetic_into_internal():
    ic = _setup(vel_scale=0.5)
    sim = _sim(Simulation, ic, SPHConfig(alpha_visc=1.0), rebin_every=100,
               device="cpu")

    def energies():
        c = sim.state.cells
        m = (c.mass * c.mask).numpy()
        ke = 0.5 * np.sum(m * np.sum(c.vel.numpy() ** 2, -1))
        return ke, np.sum(m * c.u.numpy())

    ke0, ie0 = energies()
    sim.run(10, dt=0.005)
    ke1, ie1 = energies()
    assert ie1 > ie0 and ke1 < ke0


def test_state_lives_on_the_requested_device():
    ic = _setup(n_side=4)
    sim = _sim(Simulation, ic, SPHConfig(), device="cpu")
    sim.run(1, dt=1e-3)
    st = sim.state
    for t in (*st.cells, st.accel, st.dudt, st.rho, st.time):
        assert t.device.type == "cpu" and t.dtype == torch.float32
    assert st.time.dim() == 0
