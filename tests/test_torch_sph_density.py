"""density_pair's live-slot design and its fused gather, held bit for bit.

The CUDA kernel (``csrc/sph_pair.cu``) walks each side of a pair only up to
its live end L, computes only the elements a cheap superset test on the
dot-form r² marks as possibly within the slot's own h, and gives a dead slot
(past L) with 0 < h ≤ √eps outputs of +0 without a pass. The CPU tests here
check that design in plain PyTorch against the plain version
(``density_pair_ref``), bit for bit on every output slot, compared as int32
patterns: every term left out is an exact zero and leaves its sum as it
was. ``density_pair_cells`` (the entry that gathers through ci/cj as it
loads) is held to ``density_pair_ref`` on the gathered blocks, bit for bit.
The tests marked ``cuda`` hold the kernel itself to the same bits on the
card. This file imports no JAX, so it runs on the card as

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_sph_density.py
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.sph_pair import kernel as K
from repro_torch.kernels.sph_pair import ops, ref
from repro_torch.sph.physics import EPS, sqrt_rn
from repro_torch.sph.smoothing import get_kernel
from test_torch_sph_cuda import assert_bits_equal, live_end, pair_blocks
from torch_threads import one_torch_thread  # noqa: F401

# the density's eight blocks among pair_blocks' eighteen force blocks
DENSITY = (0, 2, 7, 8, 9, 11, 16, 17)
NAMES = ("rho_i", "drho_i", "nngb_i", "rho_j", "drho_j", "nngb_j")


def density_blocks(P, C, seed, pad="engine"):
    blocks = pair_blocks(P, C, seed, pad)
    return [blocks[k] for k in DENSITY]


def slot_sums(x, h, part, n, kernel):
    """One slot's three sums over partner slots [0, n), as the kernel forms
    them: r² with the slot's own terms first, only the elements with
    r² + eps < h·h·1.000001 (every element where h ≤ 0), added in ascending
    order from +0."""
    w_fn, dwdr_fn = get_kernel(kernel)
    xp, mw, k = part[0][:n], part[1][:n], part[2][:n]
    sq = (x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]
    sqp = (xp[:, 0] * xp[:, 0] + xp[:, 1] * xp[:, 1]) + xp[:, 2] * xp[:, 2]
    cross = (x[0] * xp[:, 0] + x[1] * xp[:, 1]) + x[2] * xp[:, 2]
    r2 = torch.clamp_min((sq + sqp) - 2.0 * cross, 0.0)
    reach = (h * h) * 1.000001 if h > 0 else math.inf
    marked = (r2 + EPS) < reach
    r = sqrt_rn(r2 + EPS)
    hh = h.expand_as(r)
    w = w_fn(r, hh)
    terms = (mw * w, mw * (-(3.0 * w + r * dwdr_fn(r, hh)) / hh),
             (w > 0.0) * k)
    sums = [torch.zeros((), dtype=torch.float32) for _ in range(3)]
    for b in range(n):
        if marked[b]:
            sums = [s + t[b] for s, t in zip(sums, terms)]
    return sums


def live_slot_density(args, kernel):
    """What the CUDA kernel computes, in plain PyTorch: each slot, live or
    dead, against the other side's slots below its live end; a slot with
    0 < h ≤ √eps has no partner within reach and gets +0."""
    pos_i, h_i, m_i, mask_i, pos_j, h_j, m_j, mask_j = args
    P, C = h_i.shape
    Li, Lj = live_end(mask_i), live_end(mask_j)
    outs = [torch.empty(P, C) for _ in range(6)]
    tiny = float(np.sqrt(np.float32(EPS)))
    for p in range(P):
        sides = ((pos_i[p], h_i[p], (pos_j[p], m_j[p] * mask_j[p], mask_j[p]),
                  int(Lj[p]), outs[:3]),
                 (pos_j[p], h_j[p], (pos_i[p], m_i[p] * mask_i[p], mask_i[p]),
                  int(Li[p]), outs[3:]))
        for x, h, part, n, dst in sides:
            for a in range(C):
                if 0 < float(h[a]) <= tiny:
                    sums = [torch.zeros(())] * 3
                else:
                    sums = slot_sums(x[a], h[a], part, n, kernel)
                for o, s in zip(dst, sums):
                    o[p, a] = s
    return outs


@pytest.mark.parametrize("C", [8, 40])
@pytest.mark.parametrize("pad", ["engine", "random", "holes"])
@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_live_slot_density_design_is_bitwise_the_plain_version(C, pad,
                                                                kernel):
    args = density_blocks(6, C, seed=C + len(pad), pad=pad)
    want = ref.density_pair_ref(*args, kernel=kernel)
    assert_bits_equal(live_slot_density(args, kernel), want, NAMES)


def test_density_blocks_exercise_the_skip_and_the_dead_slots():
    """The paddings give what the design must get right: elements out of
    reach among live ones, dead slots with +0 outputs (engine padding) and
    dead slots with nonzero sums (random padding)."""
    args = density_blocks(16, 40, seed=0)
    rho_i = ref.density_pair_ref(*args)[0]
    dead = args[3] == 0
    assert bool((rho_i[dead] == 0).all()) and bool(dead.any())
    assert bool((rho_i[~dead] > 0).any())
    rnd = density_blocks(16, 40, seed=0, pad="random")
    assert bool((ref.density_pair_ref(*rnd)[0][rnd[3] == 0] != 0).any())
    r = sqrt_rn(torch.clamp_min(
        ((args[0] ** 2).sum(-1)[:, :, None] + (args[4] ** 2).sum(-1)[:, None])
        - 2.0 * args[0] @ args[4].transpose(1, 2), 0.0) + EPS)
    live = (args[3][:, :, None] != 0) & (args[7][:, None, :] != 0)
    far = r >= args[1][:, :, None]
    assert bool((live & far).any()) and bool((live & ~far).any())


def chip_smoke():
    """The repository's chip_smoke module (its Sedov setup, spec and
    bounds)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as module
    return module


def sedov_cells(n_side=6, dev="cpu"):
    """Sedov n_side³ binned into cells on ``dev``, and its full pair list."""
    spec, cells, pairs, _ = chip_smoke().sedov_setup(dev, n_side)
    return spec, cells, pairs


@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_density_pair_cells_plain_is_the_gathered_blocks(kernel):
    """On the CPU the fused entry is its plain version: density_pair_ref on
    the blocks gathered through the pair list, bit for bit, with no
    launch."""
    _, cells, pairs = sedov_cells(6)
    K.reset_launches()
    got = K.density_pair_cells(cells.pos, cells.h, cells.mass, cells.mask,
                               pairs.ci, pairs.cj, pairs.shift, kernel=kernel)
    want = ref.density_pair_ref(*chip_smoke().density_blocks(cells, pairs),
                                kernel=kernel)
    assert_bits_equal(got, want, NAMES)
    assert K.density_pair_cells.launches == 0
    assert K.density_pair.launches == 0


def _cell_args(P=5, ncells=3, C=8):
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))
    ci = torch.from_numpy(rng.integers(0, ncells, P).astype(np.int32))
    cj = torch.from_numpy(rng.integers(0, ncells, P).astype(np.int32))
    return [f(ncells, C, 3), f(ncells, C) + 0.5, f(ncells, C),
            torch.ones(ncells, C), ci, cj, f(P, 3)]


BAD_INPUTS = {
    "pos_dtype": (TypeError, lambda a: [a[0].double()] + a[1:]),
    "h_shape": (ValueError, lambda a: a[:1] + [a[1][:, :4]] + a[2:]),
    "mask_not_contiguous": (ValueError, lambda a: a[:3] + [
        a[3].t().contiguous().t()] + a[4:]),
    "ci_int64": (TypeError, lambda a: a[:4] + [a[4].long()] + a[5:]),
    "cj_length": (ValueError, lambda a: a[:5] + [a[5][:-1]] + a[6:]),
    "ci_two_dims": (ValueError, lambda a: a[:4] + [a[4][:, None]] + a[5:]),
    "shift_dtype": (TypeError, lambda a: a[:6] + [a[6].double()]),
    "shift_shape": (ValueError, lambda a: a[:6] + [a[6][:, :2]]),
    "index_device": (ValueError, lambda a: a[:4] + [a[4].to("meta")]
                     + a[5:]),
}


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_density_pair_cells_checks_its_inputs(bad):
    err, make = BAD_INPUTS[bad]
    args = _cell_args()
    K.density_pair_cells(*args)      # the good arguments pass
    with pytest.raises(err):
        K.density_pair_cells(*make(args))


OUT_OF_RANGE = [(side, value) for side in ("ci", "cj") for value in (3, -1)]


@pytest.mark.parametrize("side,value", OUT_OF_RANGE)
def test_density_pair_cells_plain_rejects_an_index_out_of_range(side, value):
    """A cell index outside [0, ncells) (ncells = 3 here) raises on the
    CPU, as index_select does; the kernel asserts on the card
    (test_cuda_density_cells_asserts_on_an_index_out_of_range)."""
    args = _cell_args()
    k = 4 if side == "ci" else 5
    args[k] = args[k].clone()
    args[k][2] = value
    with pytest.raises(IndexError):
        K.density_pair_cells(*args)


def test_density_pair_cells_rejects_an_unknown_kernel():
    with pytest.raises(ValueError):
        K.density_pair_cells(*_cell_args(), kernel="gaussian")


def test_chip_smoke_density_bound_counts_the_fused_route():
    """chip_smoke.py's density_pair bound: 100 operations per live (i, j)
    element; bytes: the touched cells' slots once (pos, h, m, mask: 6 f32),
    ci, cj and shift (5 words a pair) and the six (P, C) outputs."""
    CS = chip_smoke()
    n_i = torch.tensor([0.0, 3.0, 40.0], dtype=torch.float64)
    n_j = torch.tensor([5.0, 3.0, 40.0], dtype=torch.float64)
    ops_n, moved = CS.density_ops_bytes(n_i, n_j, 40, cells=2)
    assert ops_n == (0 + 9 + 1600) * 100
    assert moved == 4 * (6 * 2 * 40 + 5 * 3 + 6 * 3 * 40)


def test_chip_smoke_lane_waiting_reads_the_task_order():
    """The waiting share of the element phase: tasks in the kernel's order
    (live rows, live columns, then dead slots) 32 to a round; each round
    lasts as long as its busiest lane."""
    CS = chip_smoke()
    C = 20
    hits_i = torch.zeros(2, C)
    hits_j = torch.zeros(2, C)
    hits_i[0, :3] = torch.tensor([4.0, 0.0, 2.0])
    hits_j[0, :2] = torch.tensor([1.0, 1.0])
    hits_i[1, :C] = 1.0
    hits_j[1, :C] = 1.0
    L_i = torch.tensor([3, C])
    L_j = torch.tensor([2, C])
    total, busiest, waiting = CS.lane_waiting(hits_i, hits_j, L_i, L_j)
    # pair 0: one round, busiest 4 of 8 elements over 32 lanes; pair 1: two
    # rounds (40 tasks), busiest 1 each, 32 + 8 elements
    assert total == 8 + 40 and busiest == 4 + 2
    assert waiting == pytest.approx(1 - 48 / (32 * 6))


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 40, 88, 128])
@pytest.mark.parametrize("pad", ["engine", "random", "holes"])
@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_cuda_density_kernel_bitwise_on_every_slot(cuda_device, C, pad,
                                                   kernel):
    args = density_blocks(64, C, seed=C + len(pad), pad=pad)
    n0 = K.density_pair.launches
    got = K.density_pair(*(t.to(cuda_device) for t in args), kernel=kernel)
    torch.cuda.synchronize()
    assert K.density_pair.launches == n0 + 1
    assert_bits_equal(got, ref.density_pair_ref(*args, kernel=kernel), NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("n_side", [6, 16])
@pytest.mark.parametrize("kernel", ["cubic", "wendland_c2"])
def test_cuda_density_cells_is_bitwise_the_block_entry(cuda_device, n_side,
                                                       kernel):
    """The fused entry on the cell arrays gives the block entry's bits on
    the blocks gathered through the same list (Sedov 6³: C = 88, self pairs
    and periodic images), and both the plain version's."""
    _, cells, pairs = sedov_cells(n_side)
    on = [t.to(cuda_device) for t in (cells.pos, cells.h, cells.mass,
                                      cells.mask, pairs.ci, pairs.cj,
                                      pairs.shift)]
    n0 = K.density_pair_cells.launches
    got = K.density_pair_cells(*on, kernel=kernel)
    torch.cuda.synchronize()
    assert K.density_pair_cells.launches == n0 + 1
    blocks = ref.gather_density_blocks(*on)
    assert_bits_equal(got, K.density_pair(*blocks, kernel=kernel), NAMES)
    assert_bits_equal(got, ref.density_pair_ref(
        *chip_smoke().density_blocks(cells, pairs), kernel=kernel), NAMES)


@pytest.mark.cuda
def test_cuda_density_pairs_is_bitwise_the_block_route(cuda_device):
    """On the card, ops.density_pairs (the fused entry, then the per-cell
    sums) gives the bits of the route it replaced: the gathered blocks
    through the block entry, then the same sums."""
    _, cells, pairs = sedov_cells(6, cuda_device)
    K.reset_launches()
    got = ops.density_pairs(cells, pairs)
    outs = K.density_pair(*chip_smoke().density_blocks(cells, pairs))
    torch.cuda.synchronize()
    assert K.density_pair_cells.launches == 1
    assert K.density_pair.launches == 1
    live_i, live_j = ops._live(pairs, None, cells.pos.dtype)
    side_i = torch.stack(outs[:3], -1) * live_i[:, None, None]
    side_j = torch.stack(outs[3:], -1) * live_j[:, None, None]
    sums = ops._cell_sums(side_i, side_j, pairs.incoming,
                          cells.mass.shape[0])
    assert_bits_equal(got, [sums[..., k] for k in range(3)],
                      ("rho", "drho", "nngb"))


@pytest.mark.cuda
def test_cuda_density_cells_asserts_on_an_index_out_of_range(cuda_device):
    """An index outside [0, ncells) stops the fused kernel with a
    device-side assertion, not a read out of bounds. The assertion leaves
    the CUDA context unusable, so it runs in a process of its own."""
    code = (
        "import torch\n"
        "from repro_torch.kernels.sph_pair import kernel as K\n"
        "from test_torch_sph_density import _cell_args\n"
        "args = [t.cuda() for t in _cell_args()]\n"
        "K.density_pair_cells(*args)\n"
        "torch.cuda.synchronize()\n"
        "print('in range: ok', flush=True)\n"
        "args[5][2] = 3\n"
        "K.density_pair_cells(*args)\n"
        "torch.cuda.synchronize()\n")
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src"), here, root]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert "in range: ok" in proc.stdout, proc.stderr
    assert proc.returncode != 0
    assert "assert" in (proc.stdout + proc.stderr).lower(), proc.stderr


@pytest.mark.cuda
def test_cuda_density_takes_any_capacity_and_no_pairs(cuda_device):
    for C in (1, 33, 300, 600):
        args = density_blocks(5, C, seed=C, pad="random")
        got = K.density_pair(*(t.to(cuda_device) for t in args))
        assert_bits_equal(got, ref.density_pair_ref(*args), NAMES)
    K.reset_launches()
    empty = [t[:0].to(cuda_device) for t in density_blocks(1, 40, seed=0)]
    assert all(o.shape == (0, 40) for o in K.density_pair(*empty))
    cell_args = [t.to(cuda_device) for t in _cell_args()]
    none = cell_args[:4] + [cell_args[4][:0], cell_args[5][:0],
                            cell_args[6][:0]]
    assert all(o.shape == (0, 8) for o in K.density_pair_cells(*none))
    assert K.density_pair.launches == 0
    assert K.density_pair_cells.launches == 0


@pytest.mark.cuda
def test_cuda_main_path_launches_the_fused_entry(cuda_device):
    """A time-bin cycle on the card reaches density_pair_cells, never the
    block entry, and its state is the CPU run's bit for bit."""
    from repro_torch.sph import build_simulation
    from repro_torch.sph.convert import to_numpy
    spec = chip_smoke().sedov_spec(6, max_depth=3)
    snaps = []
    for dev in (cuda_device, "cpu"):
        K.reset_launches()
        sim = build_simulation(spec, device=dev)
        sim.step()
        snaps.append(to_numpy(sim.state)["cells"])
        if dev != "cpu":
            assert K.density_pair_cells.launches > 0
            assert K.density_pair.launches == 0
    for k in snaps[0]:
        assert snaps[0][k].tobytes() == snaps[1][k].tobytes(), k
