"""force_pair's live-slot design, held bit for bit against its plain version.

The CUDA kernel (``csrc/sph_pair.cu``) walks each side of a pair only up to
its live end L (one past the last slot with a nonzero mask) and gives a dead
slot (past L) its outputs by a shortcut: dv is −0 on the i-side and +0 on the
j-side, du is coef·(its energy sum over live partners within its own h) + 0.
The CPU tests here check that design in plain PyTorch against the plain
version (``force_pair_ref``), bit for bit on every output slot, compared as
int32 patterns: the skipped terms are exact zeros and leave every sum as it
was. The tests marked ``cuda`` hold the kernel itself to the same bits on
the card, at capacities up to 128 (the first kernel refused C > 83), with
empty and full cells, padding as the engine writes it and padding of any
finite values, both smoothing kernels, with and without viscosity, plus the
pair momentum antisymmetry. This file imports no JAX, so it runs on the card
as

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_sph_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.sph_pair import kernel as K
from repro_torch.kernels.sph_pair import ref
from repro_torch.sph.physics import EPS, sqrt_rn
from repro_torch.sph.smoothing import get_kernel
from torch_threads import one_torch_thread  # noqa: F401

SHIFTS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
          for dz in (-1, 0, 1)]


def pair_blocks(P, C, seed, pad="engine"):
    """The force kernel's 18 (P, C[, 3]) blocks for P pairs of unit cells.

    Occupancies run from empty to full (the first pairs are empty/half,
    full/full and a third/empty); live slots are a prefix, as the cell grid
    bins them. Every fourth pair is a self pair (both sides one cell). The
    pair's j-cell is offset by a neighbour shift, h is about the cell size,
    and the velocities converge often enough to switch the viscosity on.
    ``pad``: "engine" fills dead slots as the engine does (pos 0 before the
    shift, h 1e-6, m 0, ρ 1, P 0, Ω 1, cs 0); "random" gives them live-like
    finite values (so a dead slot's energy sum is not zero); "holes" is
    "engine" plus dead slots inside the live prefix.
    """
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, C + 1, size=(P, 2))
    occ[:3] = [(0, C // 2), (C, C), (C // 3, 0)][:P]

    def side(n, shift):
        live = dict(
            pos=rng.random((C, 3)) + shift,
            vel=0.3 * rng.standard_normal((C, 3)),
            h=0.9 + 0.3 * rng.random(C), press=0.5 + rng.random(C),
            rho=1.0 + rng.random(C), om=0.9 + 0.2 * rng.random(C),
            cs=1.0 + rng.random(C), m=0.5 + rng.random(C),
            mask=np.ones(C))
        if pad != "random":
            dead = np.arange(C) >= n
            for k, v in dict(pos=0.0, vel=0.0, h=1e-6, press=0.0, rho=1.0,
                             om=1.0, cs=0.0, m=0.0).items():
                live[k][dead] = v
            live["pos"][dead] += shift
        live["mask"][n:] = 0.0
        if pad == "holes" and n > 2:
            live["mask"][rng.integers(0, n - 1, size=2)] = 0.0
        return live

    names = ("pos", "vel", "h", "press", "rho", "om", "cs", "m", "mask")
    out = {f"{k}_{s}": [] for s in "ij" for k in names}
    for p in range(P):
        shift = np.array(SHIFTS[rng.integers(len(SHIFTS))], np.float64)
        a = side(occ[p, 0], np.zeros(3))
        b = a if p % 4 == 3 else side(occ[p, 1], shift)
        for k in names:
            out[f"{k}_i"].append(a[k])
            out[f"{k}_j"].append(b[k])
    return [torch.from_numpy(np.stack(out[f"{k}_{s}"]).astype(np.float32))
            for s in "ij" for k in names]


def live_end(mask):
    """One past the last nonzero slot of each row of a (P, C) mask."""
    C = mask.shape[1]
    idx = torch.arange(1, C + 1).expand_as(mask)
    return torch.where(mask != 0, idx, 0).amax(1)


def dead_energy_sum(own, part, row, kernel):
    """A dead slot's energy sum over the partner side's live slots, as the
    kernel forms it: only partners with r2 > EPS, r < h_own and a nonzero
    mask add ((m·k)·(v_ij·r̂_ij))·dW/dr(r, h_own), in ascending order."""
    _, dwdr = get_kernel(kernel)
    x, v, h = own
    xp, vp, mp, kp = part
    sq = (x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]
    sqp = (xp[:, 0] * xp[:, 0] + xp[:, 1] * xp[:, 1]) + xp[:, 2] * xp[:, 2]
    cross = (x[0] * xp[:, 0] + x[1] * xp[:, 1]) + x[2] * xp[:, 2]
    r2 = torch.clamp_min((sq + sqp) - 2.0 * cross, 0.0)
    r = sqrt_rn(r2 + EPS)
    dx = x - xp if row else xp - x
    dv = v - vp if row else vp - v
    rh = dx / r[:, None]
    vdotrhat = (dv[:, 0] * rh[:, 0] + dv[:, 1] * rh[:, 1]) + dv[:, 2] * rh[:, 2]
    term = ((mp * kp) * vdotrhat) * dwdr(r, h)
    take = (r2 > EPS) & (r < h) & (kp != 0)
    st = torch.zeros((), dtype=torch.float32)
    for t, ok in zip(term, take):
        if ok:
            st = st + t
    return st


def live_slot_design(args, kernel, alpha):
    """What the CUDA kernel computes, in plain PyTorch: each live row
    against the j-side's slots below its live end, each live column against
    the i-side's, and each dead slot by the shortcut."""
    P, C = args[0].shape[:2]
    Li, Lj = live_end(args[8]), live_end(args[17])
    dv_i, du_i = torch.empty(P, C, 3), torch.empty(P, C)
    dv_j, du_j = torch.empty(P, C, 3), torch.empty(P, C)
    for p in range(P):
        a = [t[p:p + 1] for t in args]
        li, lj = int(Li[p]), int(Lj[p])
        if li and lj:
            ri = ref._force_chunk(*(t[:, :li] for t in a[:9]),
                                  *(t[:, :lj] for t in a[9:]), kernel, alpha)
            dv_i[p, :li], du_i[p, :li] = ri[0][0], ri[1][0]
            dv_j[p, :lj], du_j[p, :lj] = ri[2][0], ri[3][0]
        else:       # no partner: every slot's sums stay +0, as a dead one's
            li = lj = 0
        for row, lo, own, part, n, dv, du in (
                (True, li, a[:9], a[9:], int(Lj[p]), dv_i, du_i),
                (False, lj, a[9:], a[:9], int(Li[p]), dv_j, du_j)):
            coef = own[3][0] / (own[5][0] * (own[4][0] * own[4][0]))
            for s in range(lo, C):
                st = dead_energy_sum(
                    (own[0][0, s], own[1][0, s], own[2][0, s]),
                    (part[0][0, :n], part[1][0, :n], part[7][0, :n],
                     part[8][0, :n]), row, kernel)
                dv[p, s] = -0.0 if row else 0.0
                du[p, s] = coef[s] * st + 0.0
    return dv_i, du_i, dv_j, du_j


def assert_bits_equal(got, want, names=("dv_i", "du_i", "dv_j", "du_j")):
    for n, g, w in zip(names, got, want):
        g, w = g.cpu().contiguous(), w.cpu().contiguous()
        diff = g.view(torch.int32) != w.view(torch.int32)
        assert not bool(diff.any()), (
            f"{n}: {int(diff.sum())} slots differ in their bits, first at "
            f"{diff.nonzero()[0].tolist()}: {g[diff][:4]} vs {w[diff][:4]}")


def antisymmetry(args, dv_i, dv_j):
    """Per pair, |Σ m_i dv_i + Σ m_j dv_j| / Σ|m dv| over live slots."""
    wi = (args[7] * args[8]).double()[..., None].to(dv_i.device)
    wj = (args[16] * args[17]).double()[..., None].to(dv_i.device)
    pi, pj = wi * dv_i.double(), wj * dv_j.double()
    net = (pi.sum(1) + pj.sum(1)).abs()
    scale = pi.abs().sum(1) + pj.abs().sum(1)
    return float((net / scale.clamp_min(1e-300)).max())


@pytest.mark.parametrize("C", [8, 40])
@pytest.mark.parametrize("pad", ["engine", "random", "holes"])
@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_live_slot_design_is_bitwise_the_plain_version(C, pad, kernel):
    args = pair_blocks(8, C, seed=C + len(pad), pad=pad)
    for alpha in (0.0, 1.0):
        want = ref.force_pair_ref(*args, kernel=kernel, alpha_visc=alpha)
        got = live_slot_design(args, kernel, alpha)
        assert_bits_equal(got, want)


def df_step(s_hi, s_lo, w, g, rh):
    """The kernel's df_accumulate, elementwise in f32 (TwoProd exact)."""
    p1, e1 = ref.two_prod(w, g)
    p2, e2 = ref.two_prod(p1, rh)
    lo = e2 + e1 * rh
    s, e = ref.two_sum(s_hi, p2)
    e = e + (s_lo + lo)
    s2 = s + e
    return s2, e - (s2 - s)


def df_renormalise(s_hi, s_lo):
    """The kernel's df_renormalise: df_step with a zero product."""
    e = s_lo + 0.0
    s2 = s_hi + e
    return s2, e - (s2 - s_hi)


@pytest.mark.parametrize("values", ["wide", "ties"])
def test_zero_terms_collapse_to_one_renormalisation(values):
    """The kernel computes only the elements that can interact: a run of
    zero terms in a double-float sum is one renormalisation, bit for bit in
    the result, wherever the run falls (inside, at the end, the whole sum).
    "ties" draws small dyadic values, so exact rounding ties are common."""
    rng = np.random.default_rng(len(values))
    N, L = 100_000, 24
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    w = f(0.5 + rng.random((L, N)))
    rh = f(rng.uniform(-1, 1, (L, N)))
    if values == "wide":
        g = f(rng.standard_normal((L, N)) * 10.0 ** rng.integers(-6, 6, (L, N)))
    else:
        w = f(rng.integers(1, 4, (L, N)) / 2.0)
        rh = f(rng.integers(-8, 9, (L, N)) / 8.0)
        g = f(rng.integers(-2 ** 20, 2 ** 20, (L, N)) * 2.0 ** -20
              * 2.0 ** rng.integers(-30, 30, (L, N)))
    g[rng.random((L, N)) < 0.8] = 0.0
    zero = g == 0
    a_hi, a_lo = torch.zeros(N), torch.zeros(N)
    b_hi, b_lo = torch.zeros(N), torch.zeros(N)
    pending = torch.zeros(N, dtype=torch.bool)
    for k in range(L):
        a_hi, a_lo = df_step(a_hi, a_lo, w[k], g[k], rh[k])
        live = ~zero[k]
        r_hi, r_lo = df_renormalise(b_hi, b_lo)
        b_hi = torch.where(live & pending, r_hi, b_hi)
        b_lo = torch.where(live & pending, r_lo, b_lo)
        s_hi, s_lo = df_step(b_hi, b_lo, w[k], g[k], rh[k])
        b_hi, b_lo = torch.where(live, s_hi, b_hi), torch.where(live, s_lo, b_lo)
        pending = zero[k]
    r_hi, r_lo = df_renormalise(b_hi, b_lo)
    b_hi, b_lo = torch.where(pending, r_hi, b_hi), torch.where(pending, r_lo, b_lo)
    assert_bits_equal([a_hi + a_lo], [b_hi + b_lo], names=("sum",))
    # and one renormalisation more changes nothing: a run is one step
    r_hi, r_lo = df_renormalise(*df_renormalise(a_hi, a_lo))
    assert_bits_equal([r_hi + r_lo], [a_hi + a_lo], names=("renormalised",))


def test_pair_blocks_cover_empty_full_and_interacting_cells():
    args = pair_blocks(16, 40, seed=0)
    n_i, n_j = args[8].sum(1), args[17].sum(1)
    assert float(n_i.min()) == 0 and float(n_i.max()) == 40
    assert float(n_j.min()) == 0
    dv_i, du_i, dv_j, du_j = ref.force_pair_ref(*args, alpha_visc=1.0)
    live = args[8] > 0
    assert bool((dv_i[live].abs().sum(-1) > 0).any())
    assert bool((du_i[live] != 0).any())
    # dead slots of "random" padding get nonzero energy sums
    r = pair_blocks(16, 40, seed=0, pad="random")
    du = ref.force_pair_ref(*r, alpha_visc=1.0)[1]
    assert bool((du[r[8] == 0] != 0).any())


def test_chip_smoke_force_bound_counts_live_slots():
    """chip_smoke.py's force_pair bound: 240 operations per live (i, j)
    element; bytes: a live slot's 12 inputs besides its mask, every slot's
    mask and every output slot, each once."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as C
    n_i = torch.tensor([0.0, 3.0, 40.0], dtype=torch.float64)
    n_j = torch.tensor([5.0, 3.0, 40.0], dtype=torch.float64)
    ops, moved = C.force_ops_bytes(n_i, n_j, 40)
    assert ops == (0 + 9 + 1600) * 240
    assert moved == 4 * (12 * (5 + 6 + 80) + 2 * 3 * 40 + 8 * 3 * 40)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 40, 88, 128])
@pytest.mark.parametrize("pad", ["engine", "random", "holes"])
@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_cuda_force_kernel_bitwise_on_every_slot(cuda_device, C, pad, kernel):
    args = pair_blocks(64, C, seed=C + len(pad), pad=pad)
    on_card = [t.to(cuda_device) for t in args]
    for alpha in (0.0, 1.0):
        n0 = K.force_pair.launches
        got = K.force_pair(*on_card, kernel=kernel, alpha_visc=alpha)
        torch.cuda.synchronize()
        assert K.force_pair.launches == n0 + 1
        want = ref.force_pair_ref(*args, kernel=kernel, alpha_visc=alpha)
        assert_bits_equal(got, want)
        assert antisymmetry(args, got[0], got[2]) <= 2.0 ** -23


@pytest.mark.cuda
def test_cuda_force_kernel_takes_any_capacity_and_no_pairs(cuda_device):
    for C in (1, 33, 300, 600):
        args = pair_blocks(5, C, seed=C)
        got = K.force_pair(*(t.to(cuda_device) for t in args),
                           alpha_visc=1.0)
        assert_bits_equal(got, ref.force_pair_ref(*args, alpha_visc=1.0))
    empty = [t[:0].to(cuda_device) for t in pair_blocks(1, 40, seed=0)]
    assert all(o.shape[0] == 0 for o in K.force_pair(*empty))
