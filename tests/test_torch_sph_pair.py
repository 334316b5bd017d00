"""Port parity: the sph_pair kernels' plain versions, wrappers and ops.

The plain PyTorch versions (``repro_torch.kernels.sph_pair.ref``) are held
against the reference's Pallas kernels run in interpret mode, as
tests/test_kernel_sph_pair.py runs them, over the same (P, C), smoothing
kernel and viscosity sweeps and at the same tolerances: rtol 2e-5 for
density and 5e-5 for force, with atol the same times the output's scale
(summation order differs: ascending slot order here, XLA's own there).
∂ρ/∂h sums terms of both signs, so an element can lose ~2e-5 of the
output's scale to cancellation in either order: each side is held within
2e-5·scale of a float64 evaluation, and so the two within twice that of
each other. Neighbour counts agree within 1 (a discrete cutoff at q = 1).

The wrappers run the CUDA kernels only for CUDA tensors; the tests that
need a card carry the ``cuda`` marker and skip here.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.sph_pair.kernel import (density_pair_pallas,
                                           force_pair_pallas)
from repro.sph import SPHConfig as RefConfig
from repro.sph import uniform_ic
from repro.sph.cellgrid import PairList as RefPairList
from repro.sph.cellgrid import bin_particles as ref_bin
from repro.sph.cellgrid import build_pair_list as ref_pairs
from repro.sph.cellgrid import choose_grid
from repro.sph.engine import _density_pass as ref_density_pass
from repro.sph.engine import _force_pass as ref_force_pass
from repro.sph.physics import ghost_update as ref_ghost
from repro_torch.kernels.sph_pair import kernel as K
from repro_torch.kernels.sph_pair import ops, ref
from repro_torch.sph.cellgrid import make_pair_list
from repro_torch.sph.convert import cells_to_torch
from torch_threads import one_torch_thread  # noqa: F401

T = lambda a: torch.from_numpy(np.array(a))


def _density_inputs(P, C, seed):
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.random(s).astype(np.float32)
    pos_i = arr(P, C, 3)
    pos_j = arr(P, C, 3) + np.float32(0.1)
    h = 0.3 + 0.2 * rng.random((P, C)).astype(np.float32)
    h_j = np.roll(h, 1, 0)
    m = (rng.random((P, C)) + 0.5).astype(np.float32)
    mask_i = (rng.random((P, C)) > 0.2).astype(np.float32)
    mask_j = (rng.random((P, C)) > 0.2).astype(np.float32)
    return [pos_i, h, m, mask_i, pos_j, h_j, m, mask_j]


def _force_inputs(P, C, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s).astype(np.float32)
    pos_i, pos_j = f(P, C, 3), f(P, C, 3) + np.float32(0.05)
    vel_i, vel_j = f(P, C, 3) - 0.5, f(P, C, 3) - 0.5
    h_i = 0.3 + 0.2 * f(P, C)
    h_j = 0.3 + 0.2 * f(P, C)
    rho_i, rho_j = 1.0 + f(P, C), 1.0 + f(P, C)
    P_i, P_j = 0.5 + f(P, C), 0.5 + f(P, C)
    om_i, om_j = 0.9 + 0.2 * f(P, C), 0.9 + 0.2 * f(P, C)
    cs_i, cs_j = 1.0 + f(P, C), 1.0 + f(P, C)
    m_i, m_j = 0.5 + f(P, C), 0.5 + f(P, C)
    mask_i = (f(P, C) > 0.2).astype(np.float32)
    mask_j = (f(P, C) > 0.2).astype(np.float32)
    return [pos_i, vel_i, h_i, P_i, rho_i, om_i, cs_i, m_i, mask_i,
            pos_j, vel_j, h_j, P_j, rho_j, om_j, cs_j, m_j, mask_j]


def _assert_close(got, want, rtol, err_msg, mask=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if mask is not None:
        mask = np.broadcast_to(mask, want.shape)
        got, want = np.where(mask, got, 0), np.where(mask, want, 0)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("P,C", [(1, 8), (3, 16), (7, 24), (2, 64)])
@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_density_plain_matches_pallas(P, C, kernel):
    args = _density_inputs(P, C, seed=P * 131 + C)
    want = density_pair_pallas(*map(jnp.asarray, args), kernel=kernel,
                               interpret=True)
    got = ref.density_pair_ref(*map(T, args), kernel=kernel)
    exact = ref.density_pair_ref(
        *(torch.from_numpy(a.astype(np.float64)) for a in args),
        kernel=kernel)
    names = ["rho_i", "drho_i", "nngb_i", "rho_j", "drho_j", "nngb_j"]
    for n, g, w, e in zip(names, got, want, exact):
        if n.startswith("nngb"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1,
                                       err_msg=n)
            continue
        e = e.numpy()
        _assert_close(g.numpy(), e, 2e-5, n + " (port vs float64)")
        _assert_close(np.asarray(w), e, 2e-5, n + " (pallas vs float64)")
        scale = max(float(np.abs(e).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2 * 2e-5 * scale, err_msg=n)


@pytest.mark.parametrize("P,C", [(2, 8), (4, 16), (3, 32),
                                 (2, 96)])   # a capacity past the old 83
@pytest.mark.parametrize("alpha", [0.0, 0.8])
def test_force_plain_matches_pallas(P, C, alpha):
    args = _force_inputs(P, C, seed=P * 7 + C)
    want = force_pair_pallas(*map(jnp.asarray, args), kernel="cubic",
                             alpha_visc=alpha, interpret=True)
    got = ref.force_pair_ref(*map(T, args), kernel="cubic", alpha_visc=alpha)
    mask_i, mask_j = args[8] > 0, args[17] > 0
    masks = [mask_i[..., None], mask_i, mask_j[..., None], mask_j]
    for n, g, w, mk in zip(["dv_i", "du_i", "dv_j", "du_j"], got, want,
                           masks):
        _assert_close(g.numpy(), w, 5e-5, n, mask=mk)


@pytest.mark.parametrize("alpha", [0.0, 0.8])
def test_plain_pair_momentum_antisymmetric(alpha):
    """Σ m_i dv_i + Σ m_j dv_j = 0 per pair, to the f32 rounding floor of
    the dv entries (the double-float contraction), summed in float64 —
    the reference's atol 1e-4 and, per pair, 2⁻²³ of Σ|m dv|."""
    args = _force_inputs(2, 16, seed=9)
    dv_i, _, dv_j, _ = ref.force_pair_ref(*map(T, args), alpha_visc=alpha)
    w_i = (args[7] * args[8]).astype(np.float64)[..., None]
    w_j = (args[16] * args[17]).astype(np.float64)[..., None]
    p_i = w_i * dv_i.double().numpy()
    p_j = w_j * dv_j.double().numpy()
    np.testing.assert_allclose(p_i.sum((0, 1)) + p_j.sum((0, 1)), 0.0,
                               atol=1e-4)
    net = np.abs(p_i.sum(1) + p_j.sum(1))
    assert (net <= 2.0 ** -23 * (np.abs(p_i).sum(1)
                                 + np.abs(p_j).sum(1))).all()


def test_two_prod_is_exact():
    rng = np.random.default_rng(11)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    p, e = ref.two_prod(T(a), T(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    assert np.array_equal(p.double().numpy() + e.double().numpy(), exact)


def _padded_setup():
    ic = uniform_ic(6, seed=0)
    rng = np.random.default_rng(3)
    ic["vel"] = (0.1 * rng.standard_normal(ic["vel"].shape)).astype(
        np.float32)
    spec = choose_grid(ic["box"], float(ic["h"].max()), len(ic["pos"]))
    cells, _ = ref_bin(spec, ic["pos"], ic["vel"], ic["mass"], ic["u"],
                       ic["h"])
    pairs = ref_pairs(spec)
    ci, cj = np.asarray(pairs.ci), np.asarray(pairs.cj)
    active = np.zeros(spec.ncells, bool)
    active[: spec.ncells // 2] = True
    idx = np.nonzero(active[ci] | active[cj])[0]
    npad = 1
    while npad < len(idx):
        npad *= 2
    idxp = np.concatenate([idx, np.zeros(npad - len(idx), idx.dtype)])
    pmask = np.zeros(npad, np.float32)
    pmask[: len(idx)] = 1.0
    shift = np.asarray(pairs.shift)
    return spec, cells, pairs, (ci, cj, shift), idx, idxp, pmask


@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_ops_match_reference_on_padded_masked_pair_list(kernel):
    """The time-bin layout: a level-restricted pair subset padded to a
    power of two with masked repeats of pair 0, self pairs and periodic
    images included. The port's wave passes (the density's fused entry,
    then the per-cell sums) agree with the reference's over real slots,
    the density also with the reference's density_pairs (the Pallas kernel
    in interpret mode), and the padding adds exactly +0.0 (bitwise equal to
    the unpadded subset)."""
    from repro.kernels.sph_pair.ops import density_pairs as ref_density_pairs
    spec, cells, pairs, (ci, cj, shift), idx, idxp, pmask = _padded_setup()
    cfg_ref = RefConfig(kernel=kernel, alpha_visc=0.8)
    rho_f, drho_f, _ = ref_density_pass(cells, pairs, cfg_ref)
    rho_f = jnp.where(cells.mask > 0, rho_f, 1.0)
    drho_f = jnp.where(cells.mask > 0, drho_f, 0.0)
    press, omega, cs = ref_ghost(rho_f, drho_f, cells.u, cells.h)
    press = jnp.where(cells.mask > 0, press, 0.0)
    sub_r = RefPairList(ci=jnp.asarray(ci[idxp]), cj=jnp.asarray(cj[idxp]),
                        shift=jnp.asarray(shift[idxp]))
    want_d = ref_density_pass(cells, sub_r, cfg_ref,
                              pair_mask=jnp.asarray(pmask))
    want_f = ref_force_pass(cells, sub_r, rho_f, press, omega, cs, cfg_ref,
                            pair_mask=jnp.asarray(pmask))
    want_p = ref_density_pairs(cells, sub_r, kernel=kernel, interpret=True,
                               pair_mask=jnp.asarray(pmask))

    cells_t = cells_to_torch(cells)
    thermo = [T(a) for a in (rho_f, press, omega, cs)]
    sub_t = make_pair_list(ci[idxp], cj[idxp], shift[idxp], spec.ncells)
    got_d = ops.density_pairs(cells_t, sub_t, kernel=kernel,
                              pair_mask=T(pmask))
    got_f = ops.force_pairs(cells_t, sub_t, *thermo, kernel=kernel,
                            alpha_visc=0.8, pair_mask=T(pmask))
    m = np.asarray(cells.mask)
    # the reference engine's plain pass (want_d) sums ∂ρ/∂h in its own
    # order; at Wendland C2 its cancellation error alone passes 5e-5 of
    # scale, so there the density is held to the Pallas ops only
    for want in (want_p, want_d) if kernel == "cubic" else (want_p,):
        for n, g, w in zip(["rho", "drho", "nngb"], got_d, want):
            if n == "nngb":
                np.testing.assert_allclose(g.numpy() * m, np.asarray(w) * m,
                                           atol=1)
            else:
                _assert_close(g.numpy() * m, np.asarray(w) * m, 5e-5, n)
    _assert_close(got_f[0].numpy() * m[..., None],
                  np.asarray(want_f[0]) * m[..., None], 5e-5, "dv")
    _assert_close(got_f[1].numpy() * m, np.asarray(want_f[1]) * m, 5e-5,
                  "du")

    # the masked padding is really inert: bitwise the unpadded subset
    sub1 = make_pair_list(ci[idx], cj[idx], shift[idx], spec.ncells)
    base_d = ops.density_pairs(cells_t, sub1, kernel=kernel)
    base_f = ops.force_pairs(cells_t, sub1, *thermo, kernel=kernel,
                             alpha_visc=0.8)
    for g, w in zip(got_d + got_f, base_d + base_f):
        assert torch.equal(g, w)


def test_ops_scatter_is_order_fixed_and_matches_index_add():
    """The fixed-order per-cell sums agree with a plain index_add_ scatter
    to rounding, and repeat bitwise."""
    spec, cells, pairs, (ci, cj, shift), *_ = _padded_setup()
    cells_t = cells_to_torch(cells)
    pl = make_pair_list(ci, cj, shift, spec.ncells)
    a = ops.density_pairs(cells_t, pl)
    b = ops.density_pairs(cells_t, pl)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    outs = K.density_pair(*ref.gather_density_blocks(
        cells_t.pos, cells_t.h, cells_t.mass, cells_t.mask, pl.ci, pl.cj,
        pl.shift))
    notself = torch.from_numpy((ci != cj).astype(np.float32))[:, None]
    rho = torch.zeros_like(cells_t.mass)
    rho.index_add_(0, torch.from_numpy(ci).long(), outs[0])
    rho.index_add_(0, torch.from_numpy(cj).long(), outs[3] * notself)
    torch.testing.assert_close(a[0], rho, rtol=1e-6, atol=1e-6)


def test_wrappers_on_cpu_take_the_plain_path():
    K.reset_launches()
    d = [T(a) for a in _density_inputs(3, 16, 0)]
    f = [T(a) for a in _force_inputs(3, 16, 0)]
    for g, w in zip(K.density_pair(*d), ref.density_pair_ref(*d)):
        assert torch.equal(g, w)
    for g, w in zip(K.force_pair(*f, alpha_visc=0.8),
                    ref.force_pair_ref(*f, alpha_visc=0.8)):
        assert torch.equal(g, w)
    assert K.density_pair.launches == 0 and K.force_pair.launches == 0


def test_wrappers_check_their_inputs():
    d = [T(a) for a in _density_inputs(2, 8, 1)]
    with pytest.raises(TypeError):
        K.density_pair(*([d[0].double()] + d[1:]))
    with pytest.raises(ValueError):
        K.density_pair(*(d[:1] + [d[1][:, :4]] + d[2:]))
    with pytest.raises(ValueError):
        K.density_pair(*(d[:4] + [d[4].transpose(0, 1)] + d[5:]))
    with pytest.raises(ValueError):
        K.density_pair(*d, kernel="gaussian")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_cuda_density_kernel_matches_plain(cuda_device, kernel):
    """Bit for bit, every slot: the kernel skips only exact-zero terms."""
    d = [T(a) for a in _density_inputs(64, 40, 5)]
    n0 = K.density_pair.launches
    got = K.density_pair(*(t.to(cuda_device) for t in d), kernel=kernel)
    torch.cuda.synchronize()
    assert K.density_pair.launches == n0 + 1
    for g, w in zip(got, ref.density_pair_ref(*d, kernel=kernel)):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)), \
            kernel


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_cuda_force_kernel_matches_plain(cuda_device, alpha):
    f = [T(a).to(cuda_device) for a in _force_inputs(64, 40, 6)]
    got = K.force_pair(*f, alpha_visc=alpha)
    torch.cuda.synchronize()
    for g, w in zip(got, ref.force_pair_ref(*f, alpha_visc=alpha)):
        _assert_close(g.cpu().numpy(), w.cpu().numpy(), 5e-5, str(alpha))
