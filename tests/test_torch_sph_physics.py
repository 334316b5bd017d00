"""Port parity: smoothing kernels, physics blocks, ICs and the cell grid.

The same numpy inputs go through the JAX reference (``repro``) and the
PyTorch port (``repro_torch``) on the CPU. Tolerances:

* physics blocks: rtol 2e-5 (density) and 5e-5 (force), atol the same
  times the output's scale — the reference's own kernel tolerances
  (tests/test_kernel_sph_pair.py). The two differ only in summation order
  (the port sums in ascending slot order, XLA in its own) and in XLA's
  fusion of the dot-form products.
* neighbour counts: within 1 — the count is a discrete cutoff (w > 0), and
  one ulp of r at q = 1 can move a neighbour across it.
* ICs, ``perm``, ``ci``, ``cj`` and ``shift``: bitwise.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.sph import ic as ref_ic
from repro.sph import physics as ref_phys
from repro.sph import smoothing as ref_sm
from repro.sph.cellgrid import bin_particles as ref_bin
from repro.sph.cellgrid import build_pair_list as ref_pairs
from repro.sph.cellgrid import choose_grid as ref_choose
from repro.sph.cellgrid import unbin as ref_unbin
from repro_torch.sph import cellgrid, ic, physics, smoothing
from repro_torch.sph.engine import periodic_wrap
from torch_threads import one_torch_thread  # noqa: F401

T = lambda a: torch.from_numpy(np.array(a))


def _close(got, want, rtol, err_msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("name", ["cubic", "wendland_c2"])
def test_smoothing_kernels_match_reference(name):
    rng = np.random.default_rng(0)
    r = (rng.random(4000) * 1.2).astype(np.float32)
    h = (0.3 + rng.random(4000)).astype(np.float32)
    w_ref, dw_ref = ref_sm.get_kernel(name)
    w_pt, dw_pt = smoothing.get_kernel(name)
    _close(w_pt(T(r), T(h)), w_ref(jnp.asarray(r), jnp.asarray(h)), 2e-6)
    _close(dw_pt(T(r), T(h)), dw_ref(jnp.asarray(r), jnp.asarray(h)), 2e-6)
    _close(smoothing.dw_dh(T(r), T(h), name),
           ref_sm.dw_dh(jnp.asarray(r), jnp.asarray(h), name), 2e-6)
    # compact support: exactly zero at and beyond q = 1
    assert float(w_pt(T(h), T(h)).abs().max()) == 0.0


def _blocks(Ci, Cj, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s).astype(np.float32)
    return dict(
        pos_i=f(Ci, 3), pos_j=f(Cj, 3) + 0.05,
        vel_i=f(Ci, 3) - 0.5, vel_j=f(Cj, 3) - 0.5,
        h_i=0.3 + 0.2 * f(Ci), h_j=0.3 + 0.2 * f(Cj),
        P_i=0.5 + f(Ci), P_j=0.5 + f(Cj),
        rho_i=1.0 + f(Ci), rho_j=1.0 + f(Cj),
        omega_i=0.9 + 0.2 * f(Ci), omega_j=0.9 + 0.2 * f(Cj),
        cs_i=1.0 + f(Ci), cs_j=1.0 + f(Cj),
        m_j=0.5 + f(Cj), mask_j=(f(Cj) > 0.2).astype(np.float32))


@pytest.mark.parametrize("Ci,Cj,seed", [(8, 8, 0), (16, 24, 1), (40, 40, 2)])
@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_density_block_matches_reference(Ci, Cj, seed, kernel):
    b = _blocks(Ci, Cj, seed)
    args = ("pos_i", "h_i", "pos_j", "m_j", "mask_j")
    want = ref_phys.density_block(*(jnp.asarray(b[k]) for k in args),
                                  kernel=kernel)
    got = physics.density_block(*(T(b[k]) for k in args), kernel=kernel)
    _close(got.rho, want.rho, 2e-5, "rho")
    _close(got.drho_dh, want.drho_dh, 2e-5, "drho_dh")
    np.testing.assert_allclose(got.nngb.numpy(), np.asarray(want.nngb),
                               atol=1)


@pytest.mark.parametrize("Ci,Cj,seed", [(8, 8, 3), (16, 24, 4), (40, 40, 5)])
@pytest.mark.parametrize("alpha", [0.0, 0.8])
def test_force_block_matches_reference(Ci, Cj, seed, alpha):
    b = _blocks(Ci, Cj, seed)
    args = ("pos_i", "vel_i", "h_i", "P_i", "rho_i", "omega_i", "cs_i",
            "pos_j", "vel_j", "h_j", "P_j", "rho_j", "omega_j", "cs_j",
            "m_j", "mask_j")
    want = ref_phys.force_block(*(jnp.asarray(b[k]) for k in args),
                                alpha_visc=alpha)
    got = physics.force_block(*(T(b[k]) for k in args), alpha_visc=alpha)
    _close(got.dv, want.dv, 5e-5, "dv")
    _close(got.du, want.du, 5e-5, "du")


def test_thermo_helpers_match_reference():
    rng = np.random.default_rng(6)
    rho = (0.5 + rng.random(500)).astype(np.float32)
    drho = (rng.standard_normal(500)).astype(np.float32)
    u = (rng.random(500) * 3).astype(np.float32)
    h = (0.1 + rng.random(500) * 0.2).astype(np.float32)
    vel = rng.standard_normal((500, 3)).astype(np.float32)
    mask = (rng.random(500) > 0.1).astype(np.float32)
    nngb = np.floor(rng.random(500) * 90).astype(np.float32)
    for g, w in zip(physics.ghost_update(T(rho), T(drho), T(u), T(h)),
                    ref_phys.ghost_update(*map(jnp.asarray,
                                               (rho, drho, u, h)))):
        _close(g, w, 1e-6)
    got = physics.cfl_timestep_block(T(h), T(u), T(vel), T(mask), cfl=0.2)
    want = np.asarray(ref_phys.cfl_timestep_block(
        *map(jnp.asarray, (h, u, vel, mask)), cfl=0.2))
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    _close(got.numpy()[fin], want[fin], 1e-6)
    _close(physics.smoothing_length_update(T(h), T(rho), T(rho), T(nngb)),
           ref_phys.smoothing_length_update(*map(jnp.asarray,
                                                 (h, rho, rho, nngb))), 1e-6)


@pytest.mark.parametrize("name,args", [
    ("uniform_ic", (5,)), ("sedov_ic", (8,)), ("kelvin_helmholtz_ic", (6,)),
    ("clustered_ic", (3000,))])
def test_ics_bitwise_equal(name, args):
    want = getattr(ref_ic, name)(*args, seed=3)
    got = getattr(ic, name)(*args, seed=3)
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("ic_name,n", [("uniform_ic", 6), ("sedov_ic", 10),
                                       ("clustered_ic", 2000)])
def test_grid_binning_and_pairs_bitwise(ic_name, n):
    d = getattr(ic, ic_name)(n, seed=1)
    spec_r = ref_choose(d["box"], float(d["h"].max()), len(d["pos"]),
                        capacity_margin=3.0)
    spec_p = cellgrid.choose_grid(d["box"], float(d["h"].max()),
                                  len(d["pos"]), capacity_margin=3.0)
    assert (spec_p.box, spec_p.ncells_side, spec_p.capacity) == (
        spec_r.box, spec_r.ncells_side, spec_r.capacity)
    args = (d["pos"], d["vel"], d["mass"], d["u"], d["h"])
    cells_r, perm_r = ref_bin(spec_r, *args)
    cells_p, perm_p = cellgrid.bin_particles(spec_p, *args, device="cpu")
    np.testing.assert_array_equal(perm_p, perm_r)
    for k in cells_r._fields:
        assert np.asarray(getattr(cells_r, k)).tobytes() == \
            getattr(cells_p, k).numpy().tobytes(), k
    pr = ref_pairs(spec_r)
    pp = cellgrid.build_pair_list(spec_p, device="cpu")
    for k in ("ci", "cj", "shift"):
        a, b = getattr(pp, k).numpy(), np.asarray(getattr(pr, k))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    flat_r = ref_unbin(cells_r, perm_r, len(d["pos"]))
    flat_p = cellgrid.unbin(cells_p, perm_p, len(d["pos"]))
    for k in flat_r:
        np.testing.assert_array_equal(flat_p[k], flat_r[k])


@pytest.mark.parametrize("ns", [1, 2, 3, 5])
def test_pair_list_tiny_grids_bitwise(ns):
    spec_r = ref_choose(1.0, 1.0 / ns, 100)
    spec_p = cellgrid.choose_grid(1.0, 1.0 / ns, 100)
    pr = ref_pairs(spec_r)
    pp = cellgrid.build_pair_list(spec_p)
    for k in ("ci", "cj", "shift"):
        assert getattr(pp, k).numpy().tobytes() == \
            np.asarray(getattr(pr, k)).tobytes(), k


def test_incoming_table_lists_every_contribution_in_scatter_order():
    spec = cellgrid.choose_grid(1.0, 0.2, 1000)
    ci, cj, _ = cellgrid.pair_arrays(spec)
    cells, table = cellgrid.incoming_table(ci, cj, spec.ncells)
    P = len(ci)
    for row, c in enumerate(cells):
        want = list(np.nonzero(ci == c)[0]) + list(P + np.nonzero(cj == c)[0])
        got = [int(x) for x in table[row] if x != 2 * P]
        assert got == want


def test_periodic_wrap_matches_jnp_mod_on_edge_values():
    """The drift's ``jnp.mod`` against the port's written-out remainder,
    bitwise, on values at and around the box edges — subnormals included
    (XLA flushes them, so a subnormal negative remainder stays negative
    instead of wrapping to ``box``)."""
    tiny = np.finfo(np.float32).tiny
    x = np.array([-1e-9, -0.0, 0.0, 1.0, np.nextafter(np.float32(1), 2),
                  np.nextafter(np.float32(1), 0), -1.0, 2.5, -2.5, 1e-45,
                  -1e-45, -tiny, tiny, -5e-8, 3.0, -3.0000002, 0.5,
                  np.nextafter(np.float32(0), 1) * 3, -1e-38, 7.25],
                 dtype=np.float32)
    for box in (1.0, 0.75, 2.0):
        want = np.asarray(jnp.mod(jnp.asarray(x), box))
        got = periodic_wrap(torch.from_numpy(x), box).numpy()
        assert got.tobytes() == want.tobytes(), (box, got, want)


def test_sqrt_is_correctly_rounded():
    """PyTorch's CPU float32 sqrt misrounds some inputs; the port's
    ``sqrt_rn`` gives numpy's (and XLA's) correctly rounded bits."""
    rng = np.random.default_rng(8)
    x = (rng.random(200_000) * 3).astype(np.float32)
    x[:3] = (0.0, 1e-12, np.finfo(np.float32).tiny)
    assert physics.sqrt_rn(T(x)).numpy().tobytes() == np.sqrt(x).tobytes()
    assert np.asarray(jnp.sqrt(x)).tobytes() == np.sqrt(x).tobytes()
