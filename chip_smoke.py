"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Runs from the repository root (it imports ``repro_torch`` from ``src/``),
builds the Hopper kernels from the sources in the checkout, and fails with
a nonzero exit code if there is no CUDA device, a kernel does not build,
launch or agree with its plain PyTorch version, or the simulation goes
wrong. Phases, one line each:

1. the card (``nvidia-smi`` name and power limit), torch version, TF32 off;
2. the kernel build and its seconds;
3. each kernel against its plain version on real Sedov 64³ pair blocks
   (C = 40, a chunk of 8,192 pairs around the blast centre), ``force_pair``
   bit for bit on every output slot, live or dead; the same on the pair
   blocks of Sedov 6³ (C = 88, the reference's conformance size); the pair
   momentum antisymmetry; and a padded, masked pair list contributing +0.0;
4. kernel times (median of CUDA-event timed launches) at the full pair list
   (P = 307,328), beside the bound (for ``force_pair`` the live slots' work,
   with the all-slot figure beside it) and the plain version's time;
5. the main path: Sedov 64³ through the hierarchical time-bin ladder
   (``build_simulation(SimulationSpec(integrator="timebin"))``, max_depth
   cut to 4, see MAIN_MAX_DEPTH) for two cycles, with the kernels' launch
   counts read around it; then the same small runs (Sedov 10³ and 6³ at
   depth 4) on the card and on the CPU, compared;
6. the global-dt engine on the same initial conditions, 3 steps, with the
   kernels' launch counts read around it;
7. run-twice bitwise determinism of a one-cycle Sedov 16³ run;

and for the serving slices (``python -m repro_torch.launch.serve``),
zamba2-1.2b (Mamba-2 + shared attention) and falcon-mamba-7b (Mamba-1):

8. ``ssd_scan``, ``flash_attention`` and ``selective_scan`` against their
   plain versions at the serve paths' shapes (B = 4, S = 2048), plus a
   GQA + window case and ragged lengths (with an initial state for the
   scans); each scan run twice, bitwise equal;
9. their times beside the bound, the plain version's time and, for
   attention, ``scaled_dot_product_attention`` on the same tensors (a
   yardstick the port never calls); the bound of attention and of the SSD
   scan is their work at f32 accuracy on the tensor cores (three TF32
   products each) or their bytes, with the f32 FMA figure beside it;
10. the serve path of each model at full width (random weights from a
    seeded generator), 4 prompts of 2048 tokens, prefill then 31 greedy
    decode steps (each step timed, and the whole decode window), with
    every LM kernel's launch count set to 0 just before and read just
    after the prefill and the decode loop; the full-width prefill run twice
    gives bitwise equal logits; each model's parameters are freed before
    the next phase;
11. each model's reduced configuration on the card and on the CPU,
    teacher-forced prefill and 8 decode steps plus greedy generation,
    compared.

All libraries are built at the start, one ``nvcc`` each, in parallel
(each wrapper's ``library()`` from its own thread). Then the ``kernels``
JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Nothing is imported from JAX or from the
reference package ``repro``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.device import synchronize  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor-core f32
# FLOP/s, dense TF32 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# flash_attention and ssd_scan keep f32 accuracy on the tensor cores by
# splitting each product into three TF32 products
TF32_SPLIT = 3
TENSOR_CORE_KERNELS = ("flash_attention", "ssd_scan")
# f32 operations per live (i, j) element of a pair's tile, counted from
# csrc/sph_pair.cu (an FMA counts 2, sqrt and division 1 each): density
# evaluates W, dW/dr and the three sums for both directions; force adds
# the viscosity terms and the double-float contraction of both directions.
OPS_PER_ELEMENT = {"density_pair": 100, "force_pair": 240}
# parity tolerances of the CPU tests (tests/test_torch_sph_pair.py), which
# are the reference's own kernel tolerances
RTOL = {"density_pair": 2e-5, "force_pair": 5e-5}
CHUNK = 8192
NSIDE = 64
SIM_CYCLES = 2
# The main path runs the ladder at max_depth 4 (the reference's own Sedov
# conformance depth), not the default 10: at depth 10 the ladder goes
# non-finite within the first cycle on this initial condition — in the port
# (Sedov 64³, sub-step 434) and in the JAX reference (Sedov 16³, CPU).
MAIN_MAX_DEPTH = 4
# Energy drift over the two cycles: the reference's ladder itself drifts
# 7.1 % over two depth-4 cycles of Sedov 16³ (tools/timebin_drift.py, and
# the port matches it to 1e-6), so the bound is 10 %, not the 5 % of
# smaller runs.
DRIFT_BOUND = 0.10

# The serving slices: zamba2-1.2b (ssd_scan, flash_attention) and
# falcon-mamba-7b (selective_scan).
LM_ARCH = "zamba2-1.2b"
MAMBA1_ARCH = "falcon-mamba-7b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_SEED = 0
# kernel against plain version: the reference's kernel tolerance
# (tests/test_kernel_ssd_scan.py, test_kernel_flash_attention.py; the
# selective scan's own is tighter, 2e-5), relative to the output's scale;
# the two sum in different orders
LM_RTOL = 2e-4
# card against CPU on the reduced model: the CPU tests' pin against the JAX
# reference (tests/test_torch_lm_serve.py)
LM_CARD_CPU_RTOL = 1e-4


T0 = time.perf_counter()


def say(obj: dict) -> None:
    """One JSON line, stamped with the seconds since the script started."""
    print(json.dumps(dict(obj, t_s=round(time.perf_counter() - T0, 3))),
          flush=True)


def sedov_spec(n_side: int = NSIDE, **kw):
    """The main path's Sedov spec (``alpha_visc=1.0``, ``cfl=0.15``, local
    backend); ``kw`` sets the integrator, ``max_depth`` or ``dt``."""
    from repro_torch.sph import SimulationSpec, SPHConfig
    kw.setdefault("integrator", "timebin")
    return SimulationSpec(scenario="sedov", scenario_params={"n_side": n_side},
                          physics=SPHConfig(alpha_visc=1.0, cfl=0.15),
                          backend="local", **kw)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def sedov_setup(dev, n_side: int = NSIDE):
    """Sedov ``n_side``³ binned on the card, its full pair list, and the
    density / ghost fields the force kernel reads."""
    from repro_torch.sph import SPHConfig
    from repro_torch.sph.cellgrid import bin_particles, build_pair_list, \
        choose_grid
    from repro_torch.sph.engine import _density_pass
    from repro_torch.sph.ic import sedov_ic
    from repro_torch.sph.physics import ghost_update
    ic = sedov_ic(n_side)
    # the hot centre gets the viscosity inputs a blast has: radial motion
    d = ic["pos"] - 0.5
    ic["vel"] = (d * np.exp(-np.sum(d * d, 1) / 0.01)[:, None]).astype(
        np.float32)
    spec = choose_grid(ic["box"], float(ic["h"].max()), len(ic["pos"]),
                       capacity_margin=3.0)
    cells, _ = bin_particles(spec, ic["pos"], ic["vel"], ic["mass"],
                             ic["u"], ic["h"], device=dev)
    pairs = build_pair_list(spec, device=dev)
    cfg = SPHConfig()
    rho, drho, _ = _density_pass(cells, pairs, cfg)
    rho = torch.where(cells.mask > 0, rho, 1.0)
    drho = torch.where(cells.mask > 0, drho, 0.0)
    press, omega, cs = ghost_update(rho, drho, cells.u, cells.h)
    press = torch.where(cells.mask > 0, press, 0.0)
    return spec, cells, pairs, (rho, press, omega, cs)


def centre_chunk(spec, pairs):
    """Indices of CHUNK consecutive pairs around the blast centre's cell."""
    ns = spec.ncells_side
    c = ns // 2
    centre = (c * ns + c) * ns + c
    ci = pairs.ci.cpu().numpy()
    first = int(np.nonzero(ci == centre)[0][0])
    start = max(0, min(first - CHUNK // 2, len(ci) - CHUNK))
    return np.arange(start, start + CHUNK)


def subset(pairs, idx, ncells, dev, nlive=None):
    from repro_torch.sph.cellgrid import make_pair_list
    return make_pair_list(pairs.ci.cpu().numpy()[idx],
                          pairs.cj.cpu().numpy()[idx],
                          pairs.shift.cpu().numpy()[idx], ncells, dev,
                          nlive=nlive)


def max_err(got, want, rtol):
    """(max |got − want|, passes) under rtol with atol = rtol·max(|want|,1)."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        d = (g - w).abs()
        scale = max(float(w.abs().max()), 1.0)
        err = max(err, float(d.max()))
        ok &= bool((d <= rtol * scale + rtol * w.abs()).all())
    return err, ok


def bits_equal(got, want) -> bool:
    """Every element of every output equal as an int32 bit pattern (NaN
    for NaN, −0 for −0)."""
    return all(torch.equal(g.contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32))
               for g, w in zip(got, want))


def check_force(force_in, block: str, C: int) -> float:
    """``force_pair`` against its plain version on one set of pair blocks:
    within tolerance on live slots, bit for bit on every slot, and the pair
    momentum antisymmetry. Returns the largest live-slot difference."""
    from repro_torch.kernels.sph_pair import kernel as K, ref
    worst = 0.0
    for alpha in (0.0, 1.0):
        got = K.force_pair(*force_in, alpha_visc=alpha)
        want = ref.force_pair_ref(*force_in, alpha_visc=alpha)
        mask_i, mask_j = force_in[8], force_in[17]
        masks = (mask_i[..., None], mask_i, mask_j[..., None], mask_j)
        e, ok = max_err([g * m for g, m in zip(got, masks)],
                        [w * m for w, m in zip(want, masks)],
                        RTOL["force_pair"])
        same = bits_equal(got, want)
        # Newton's third law per pair, in float64: |Σ m dv_i + Σ m dv_j|
        # against 2⁻²³ of Σ|m dv| (each dv entry is rounded once)
        wi = (force_in[7] * mask_i).double()[..., None]
        wj = (force_in[16] * mask_j).double()[..., None]
        pi = wi * got[0].double()
        pj = wj * got[2].double()
        net = (pi.sum(1) + pj.sum(1)).abs()
        scale = pi.abs().sum(1) + pj.abs().sum(1)
        ratio = float((net / scale.clamp_min(1e-300)).max())
        anti_ok = bool((net <= 2.0 ** -23 * scale + 1e-30).all())
        say({"phase": "parity", "kernel": "force_pair", "block": block,
             "alpha_visc": alpha, "pairs": int(mask_i.shape[0]), "C": C,
             "max_abs_err": e, "ok": ok, "bitwise_all_slots": same,
             "antisymmetry_max_rel": ratio, "antisymmetry_ok": anti_ok})
        assert ok, f"force_pair (alpha={alpha}) disagrees with plain version"
        assert same, f"force_pair (alpha={alpha}, {block}) is not bitwise " \
                     f"its plain version on every slot"
        assert anti_ok, "force_pair breaks pair momentum antisymmetry"
        worst = max(worst, e)
    return worst


def check_kernels(dev, spec, cells, pairs, thermo):
    """Phase 3: each kernel against its plain version (``force_pair`` bit
    for bit on every slot, at C = 40 and C = 88), antisymmetry, and masked
    padding."""
    from repro_torch.kernels.sph_pair import kernel as K, ops, ref
    idx = centre_chunk(spec, pairs)
    sub = subset(pairs, idx, spec.ncells, dev)
    dens_in = ops.density_inputs(cells, sub)
    force_in = ops.force_inputs(cells, sub, *thermo)
    errs = {"density_pair": 0.0, "force_pair": 0.0}
    for kern in ("cubic", "wendland_c2"):
        got = K.density_pair(*dens_in, kernel=kern)
        want = ref.density_pair_ref(*dens_in, kernel=kern)
        e, ok = max_err(got, want, RTOL["density_pair"])
        say({"phase": "parity", "kernel": "density_pair", "smoothing": kern,
             "pairs": len(idx), "C": spec.capacity, "max_abs_err": e,
             "ok": ok})
        assert ok, f"density_pair ({kern}) disagrees with its plain version"
        errs["density_pair"] = max(errs["density_pair"], e)
    errs["force_pair"] = check_force(force_in, "sedov64_centre_chunk",
                                     spec.capacity)
    # the reference's conformance size, past the first kernel's C <= 83
    spec6, cells6, pairs6, thermo6 = sedov_setup(dev, 6)
    errs["force_pair"] = max(errs["force_pair"], check_force(
        ops.force_inputs(cells6, pairs6, *thermo6), "sedov6_all_pairs",
        spec6.capacity))
    # padded, masked subset (the time-bin layout) adds exactly +0.0
    live = idx[: CHUNK // 2 + 123]
    npad = 1 << int(np.ceil(np.log2(len(live))))
    padded = np.concatenate([live, np.full(npad - len(live), idx[0])])
    pm = torch.zeros(npad, dtype=torch.float32, device=dev)
    pm[: len(live)] = 1.0
    sub_live = subset(pairs, live, spec.ncells, dev)
    sub_pad = subset(pairs, padded, spec.ncells, dev, nlive=len(live))
    a = ops.density_pairs(cells, sub_live) + ops.force_pairs(
        cells, sub_live, *thermo, alpha_visc=1.0)
    b = ops.density_pairs(cells, sub_pad, pair_mask=pm) + ops.force_pairs(
        cells, sub_pad, *thermo, alpha_visc=1.0, pair_mask=pm)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    say({"phase": "parity", "check": "padded_masked_pairs_add_zero",
         "live": len(live), "padded_to": npad, "ok": same})
    assert same, "masked padding changed the per-cell sums"
    return errs


def cuda_time_ms(fn, reps: int) -> float:
    """Median over ``reps`` launches of CUDA-event time, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def force_ops_bytes(n_i, n_j, C: int):
    """Operations and bytes of ``force_pair`` as a function of the live
    slots (``n_i``, ``n_j``: each pair's live slots on either side):
    OPS_PER_ELEMENT per live (i, j) element; bytes: each live slot's inputs
    other than its mask (12 floats), every slot's mask (read to know it is
    dead) and every output slot (dv and du, both sides)."""
    P = len(n_i)
    ops = float((n_i * n_j).sum()) * OPS_PER_ELEMENT["force_pair"]
    moved = 4.0 * (12 * float((n_i + n_j).sum()) + 2 * P * C + 8 * P * C)
    return ops, moved


def within_reach(force_in, chunk: int = CHUNK) -> int:
    """Live (i, j) elements with r² > EPS and r < max(h_i, h_j): the only
    ones whose force terms are not all zero (the rest the kernel skips)."""
    from repro_torch.sph.physics import EPS, pairwise_r2, sqrt_rn
    n = 0
    for a in range(0, force_in[0].shape[0], chunk):
        pos_i, h_i, mask_i, pos_j, h_j, mask_j = (
            force_in[k][a:a + chunk] for k in (0, 2, 8, 9, 11, 17))
        r2 = pairwise_r2(pos_i, pos_j)
        near = sqrt_rn(r2 + EPS) < torch.maximum(h_i[:, :, None],
                                                 h_j[:, None, :])
        live = (mask_i[:, :, None] != 0) & (mask_j[:, None, :] != 0)
        n += int((live & near & (r2 > EPS)).sum())
    return n


def time_kernels(spec, cells, pairs, thermo):
    """Phase 4: kernel and plain-version times at the full pair list, with
    the bound reckoned from this run's inputs: ``force_pair``'s from its
    live slots (the work it needs), beside the all-slot figure (every
    padded input read) that bound the first kernel."""
    from repro_torch.kernels.sph_pair import kernel as K, ops, ref
    dens_in = ops.density_inputs(cells, pairs)
    force_in = ops.force_inputs(cells, pairs, *thermo)
    occ = cells.mask.sum(1).double()
    n_i, n_j = occ[pairs.ci.long()], occ[pairs.cj.long()]
    live = float((n_i * n_j).sum())
    rows = {}
    for name, fn, plain, args in (
            ("density_pair", K.density_pair, ref.density_pair_ref, dens_in),
            ("force_pair", lambda *a: K.force_pair(*a, alpha_visc=1.0),
             lambda *a: ref.force_pair_ref(*a, alpha_visc=1.0), force_in)):
        ms = cuda_time_ms(lambda: fn(*args), reps=10)
        plain_ms = cuda_time_ms(lambda: plain(*args), reps=1)
        out = fn(*args)
        all_slots = nbytes(args) + nbytes(out)
        ops_n = live * OPS_PER_ELEMENT[name]
        moved = all_slots
        extra = {}
        if name == "force_pair":
            ops_n, moved = force_ops_bytes(n_i, n_j, spec.capacity)
            extra["elements_within_reach"] = within_reach(args)
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops_n / PEAK_F32_FLOPS * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations",
                          bytes=moved, operations=ops_n,
                          live_slot_pairs=live,
                          all_slot_bound_ms=max(
                              all_slots / PEAK_BYTES_PER_S * 1e3, t_ops),
                          **extra)
        say({"phase": "timing", "kernel": name, "P": int(pairs.ci.shape[0]),
             "C": spec.capacity, **rows[name],
             "share_of_bound": rows[name]["bound_ms"] / ms})
    return rows


def main_path(dev, max_depth: int = MAIN_MAX_DEPTH):
    """Phase 5: the time-bin Sedov 64³ path through the port's API."""
    from repro_torch.kernels.sph_pair import kernel as K
    from repro_torch.sph import build_simulation
    spec = sedov_spec(max_depth=max_depth)
    t0 = time.perf_counter()
    sim = build_simulation(spec, device=dev)
    synchronize(dev)
    say({"phase": "main_path_build", "particles": sim.engine.n,
         "cells": sim.engine.spec.ncells, "C": sim.engine.spec.capacity,
         "pairs": int(sim.engine.pairs.ci.shape[0]),
         "max_depth": spec.max_depth,
         "seconds": time.perf_counter() - t0})
    say({"phase": "main_path_cut", "max_depth": max_depth,
         "default_max_depth": 10,
         "reason": "the ladder goes non-finite within the first cycle at "
                   "depth 10 on this IC (port and JAX reference alike)"})
    e0, p0 = sim.diagnostics()
    K.reset_launches()
    for c in range(SIM_CYCLES):
        st = sim.step()
        say({"phase": "main_path_cycle", "cycle": c, "wall_s": st["wall"],
             "depth": st["depth"], "substeps": st["substeps"],
             "force_substeps": st["force_substeps"],
             "particle_updates": st["updates"],
             "updates_per_s": st["updates"] / st["wall"],
             "pair_tasks": st["pair_tasks"], "t": st["t"]})
    launches = {"density_pair": K.density_pair.launches,
                "force_pair": K.force_pair.launches}
    e1, p1 = sim.diagnostics()
    state = sim.state
    fields = dict(state._asdict(), **state.cells._asdict())
    finite = all(bool(torch.isfinite(v.float()).all())
                 for k, v in fields.items() if k != "cells")
    drift = abs(e1 - e0) / abs(e0)
    say({"phase": "main_path_check", "energy_drift": drift,
         "momentum": [float(x) for x in p1], "finite": finite,
         "launches": launches})
    assert finite, "non-finite state after the main path"
    assert drift < DRIFT_BOUND, f"energy drift {drift} over {DRIFT_BOUND}"
    assert all(v > 0 for v in launches.values()), launches
    return launches


def card_matches_cpu(dev, n_side: int = 10, max_depth: int = 4):
    """Phase 5b: the same small time-bin run on the card and on the CPU
    (plain versions, which the CPU tests hold against the JAX reference)
    agrees — counts exactly, fields within the tests' trajectory tolerance
    (1e-4 of each field's scale). Sedov 10³ keeps the CPU half to seconds
    while its ladder still takes interior sub-steps; the reference's
    conformance size, 6³, bins into 2³ cells of capacity 88."""
    from repro_torch.sph import build_simulation
    from repro_torch.sph.convert import to_numpy
    spec = sedov_spec(n_side, max_depth=max_depth)
    runs = []
    for d in (dev, "cpu"):
        sim = build_simulation(spec, device=d)
        capacity = sim.engine.spec.capacity
        stats = [sim.step() for _ in range(2)]
        counts = [[st[k] for k in ("depth", "substeps", "force_substeps",
                                   "updates", "pair_tasks")] for st in stats]
        snap = to_numpy(sim.state)
        snap.update(snap.pop("cells"))
        runs.append((counts, snap))
    (ca, a), (cb, b) = runs
    worst, same = 0.0, True
    for k in a:
        same &= a[k].tobytes() == b[k].tobytes()
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        scale = max(float(np.abs(y).max()), 1e-30)
        worst = max(worst, float(np.abs(x - y).max()) / scale)
    say({"phase": "card_vs_cpu", "n_side": n_side, "C": capacity,
         "max_depth": max_depth,
         "cycles": 2,
         "counts_equal": ca == cb, "bitwise_equal": bool(same),
         "max_rel_diff": worst})
    assert ca == cb and worst <= 1e-4, "card and CPU runs disagree"


def global_path(dev):
    """Phase 6: the global-dt engine on the same IC, 3 steps of fixed dt,
    with its own launch counts (set to 0 before the build, which runs the
    initial density and force passes)."""
    from repro_torch.kernels.sph_pair import kernel as K
    from repro_torch.sph import build_simulation
    spec = sedov_spec(integrator="global", dt=1e-5)
    K.reset_launches()
    sim = build_simulation(spec, device=dev)
    e0, _ = sim.diagnostics()
    walls = [sim.step()["wall"] for _ in range(3)]
    e1, _ = sim.diagnostics()
    launches = {"density_pair": K.density_pair.launches,
                "force_pair": K.force_pair.launches}
    c = sim.state.cells
    finite = all(bool(torch.isfinite(t).all()) for t in c)
    say({"phase": "global_dt", "steps": 3, "dt": spec.dt, "wall_s": walls,
         "energy_drift": abs(e1 - e0) / abs(e0), "finite": finite,
         "launches": launches})
    assert finite and abs(e1 - e0) / abs(e0) < 0.05
    assert all(v >= 3 for v in launches.values()), launches


def determinism(dev):
    """Phase 7: the same spec run twice gives bitwise-equal state."""
    from repro_torch.sph import build_simulation
    from repro_torch.sph.convert import to_numpy
    spec = sedov_spec(16, max_depth=MAIN_MAX_DEPTH)
    snaps = []
    for _ in range(2):
        sim = build_simulation(spec, device=dev)
        sim.step()
        snaps.append(to_numpy(sim.state))

    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v

    a, b = dict(flat(snaps[0])), dict(flat(snaps[1]))
    same = all(a[k].tobytes() == b[k].tobytes() for k in a)
    say({"phase": "determinism", "n_side": 16, "cycles": 1,
         "fields": sorted(a), "bitwise_equal": same})
    assert same, "two identical runs differ"


# ---------------------------------------------------------------- LM slice
def ssd_inputs(B, S, H, hp, N, dev, seed=0):
    """The inputs of tests/test_kernel_ssd_scan.py:11, made on the host from
    a seed and moved to ``dev``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, hp)).astype(np.float32),
            (0.05 + 0.1 * rng.random((B, S, H))).astype(np.float32),
            (-(0.1 + rng.random(H))).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.random(H).astype(np.float32)]
    return [torch.from_numpy(a).to(dev) for a in arrs]


def scan_inputs(B, S, dI, N, dev, seed=0):
    """The inputs of tests/test_kernel_mamba_scan.py:make_inputs, made on
    the host from a seed and moved to ``dev``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, dI)).astype(np.float32),
            (0.05 + 0.1 * rng.random((B, S, dI))).astype(np.float32),
            (-rng.random((dI, N)) - 0.1).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.random(dI).astype(np.float32)]
    return [torch.from_numpy(a).to(dev) for a in arrs]


def qkv_inputs(B, S, T, H, K, hd, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev)
            for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]


def lm_shapes(cfg, B: int, S: int):
    """The serve path's kernel shapes: ssd (B, S, H, hp, N), flash
    (B, S, H, K, hd)."""
    return ((B, S, cfg.d_inner // cfg.ssm_headdim, cfg.ssm_headdim,
             cfg.d_state),
            (B, S, cfg.n_heads, cfg.n_kv, cfg.head_dim))


def scan_shape(cfg, B: int, S: int):
    """The Mamba-1 serve path's selective_scan shape (B, S, dI, N)."""
    return B, S, cfg.d_inner, cfg.d_state


def scan_ops_bytes(B, S, dI, N, with_h0=False):
    """Operations and bytes of the selective scan as a function: per
    (b, t, d, n) dt·A, exp, the decay multiply and the input and C FMAs (7,
    an FMA counted as 2), per (b, t, d) dt·u and D·u plus its add (3);
    bytes: u, dt, B, C, A, D (and h0) read once, y and h written once."""
    ops = B * S * dI * (7 * N + 3)
    moved = 4 * (3 * B * S * dI + 2 * B * S * N + dI * N + dI
                 + B * dI * N * (2 if with_h0 else 1))
    return float(ops), float(moved)


def ssd_chunked_ops(S, N, hp, Q):
    """Operations of one (batch, head) strip of the SSD scan in the chunked
    form at chunk length Q, the ragged last chunk at its own length L (no
    padded steps): per chunk the triangular C·Bᵀ and M·u products (s ≤ t
    only), C·h and the state update (2·L·N·hp each), and the state's decay
    (N·hp); an FMA counts 2."""
    def chunk(L):
        return L * (L + 1) * (N + hp) + 4 * L * N * hp + N * hp
    full, last = divmod(S, Q)
    return full * chunk(Q) + (chunk(last) if last else 0)


def ssd_ops_bytes(B, S, H, hp, N):
    """Operations and bytes of the SSD scan as a function, whatever chunk a
    kernel uses: the least operation count over chunk lengths, or the
    sequential recurrence's 5·N·hp per step (decay, outer-product FMA, C·h)
    where that is lower; bytes: each input read once, y and h written once."""
    per_strip = min(min(ssd_chunked_ops(S, N, hp, Q) for Q in range(1, S + 1)),
                    5 * N * hp * S)
    moved = 4 * (2 * B * S * H * hp + 2 * B * S * N + B * S * H + 2 * H
                 + B * H * N * hp)
    return float(B * H * per_strip), float(moved)


def flash_ops_bytes(B, S, T, H, K, hd, causal, window):
    """Operations and bytes of attention over the live (query, key) pairs
    of this mask: q·k and p·v, 2·hd each, an FMA counted as 2; bytes: q, k,
    v read once, o written once."""
    qpos = np.arange(S)[:, None] + (T - S)
    kpos = np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    ops = 4.0 * hd * float(ok.sum()) * B * H
    moved = 4.0 * (2 * B * S * H * hd + 2 * B * T * K * hd)
    return ops, moved


def lm_bound(name, ops, moved) -> dict:
    """The least time of an LM kernel's work: bytes over the memory rate
    against operations over the peak rate of the units that do them. The
    kernels on the tensor cores (``TENSOR_CORE_KERNELS``) keep f32 accuracy
    with three TF32 products each; the f32 FMA figure stands beside their
    bound as ``fma_bound_ms``."""
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    if name not in TENSOR_CORE_KERNELS:
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    t_tc = TF32_SPLIT * ops / PEAK_TF32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_tc),
            "bound_by": "bytes" if t_bytes >= t_tc else "operations (3×TF32)",
            "fma_bound_ms": max(t_bytes, t_ops)}


def lm_check_kernels(dev):
    """Phase 8: each LM kernel against its plain version at the serve
    path's shapes, plus GQA + window and ragged lengths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    cfg = get_config(LM_ARCH)
    (sB, sS, sH, shp, sN), (fB, fS, fH, fK, fhd) = lm_shapes(
        cfg, LM_BATCH, LM_PROMPT)
    errs = {"ssd_scan": 0.0, "flash_attention": 0.0}
    for S, with_h0 in ((sS, False), (sS - 77, True)):
        args = ssd_inputs(sB, S, sH, shp, sN, dev, seed=S)
        h0 = (torch.randn(sB, sH, sN, shp, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
              if with_h0 else None)
        got = ssd_scan(*args, h0=h0)
        same = bits_equal(got, ssd_scan(*args, h0=h0))
        want = ssd_scan_ref(*args, chunk=cfg.ssm_chunk, h0=h0)
        e, ok = max_err(got, want, LM_RTOL)
        say({"phase": "lm_parity", "kernel": "ssd_scan",
             "shape": [sB, S, sH, shp, sN], "h0": with_h0,
             "max_abs_err": e, "rtol": LM_RTOL, "ok": ok,
             "run_twice_bitwise_equal": same})
        assert ok, "ssd_scan disagrees with its plain version"
        assert same, "ssd_scan differs from run to run"
        errs["ssd_scan"] = max(errs["ssd_scan"], e)
    for B, S, T, H, K, causal, window in (
            (fB, fS, fS, fH, fK, True, None),          # the serve path's
            (2, 1000, 1000, fH, fH // 4, True, 256),   # GQA 4:1, window, ragged
            (2, 333, 1000, fH, fK, True, None)):        # offset queries
        q, k, v = qkv_inputs(B, S, T, H, K, fhd, dev, seed=S + T)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        e, ok = max_err([got], [want], LM_RTOL)
        say({"phase": "lm_parity", "kernel": "flash_attention",
             "shape": [B, S, T, H, K, fhd], "causal": causal,
             "window": window, "max_abs_err": e, "rtol": LM_RTOL, "ok": ok})
        assert ok, "flash_attention disagrees with its plain version"
        errs["flash_attention"] = max(errs["flash_attention"], e)
    errs["selective_scan"] = lm_check_scan(dev)
    return errs


def lm_check_scan(dev) -> float:
    """Phase 8, selective_scan: at the falcon-mamba-7b serve shape, and
    ragged (S and dI not multiples of the kernel's tiles) with an initial
    state."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)
    B, S, dI, N = scan_shape(get_config(MAMBA1_ARCH), LM_BATCH, LM_PROMPT)
    worst = 0.0
    for S_, dI_, with_h0 in ((S, dI, False), (S - 77, dI - 40, True)):
        args = scan_inputs(B, S_, dI_, N, dev, seed=S_)
        h0 = (torch.randn(B, dI_, N, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
              if with_h0 else None)
        got = selective_scan(*args, h0=h0)
        same = bits_equal(got, selective_scan(*args, h0=h0))
        want = selective_scan_ref(*args, h0=h0)
        e, ok = max_err(got, want, LM_RTOL)
        say({"phase": "lm_parity", "kernel": "selective_scan",
             "shape": [B, S_, dI_, N], "h0": with_h0, "max_abs_err": e,
             "rtol": LM_RTOL, "ok": ok, "run_twice_bitwise_equal": same})
        assert ok, "selective_scan disagrees with its plain version"
        assert same, "selective_scan differs from run to run"
        worst = max(worst, e)
    return worst


def lm_time_kernels(dev):
    """Phase 9: LM kernel times at the serve path's shapes, beside the
    bound, the plain version and (attention) the library's call."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    cfg = get_config(LM_ARCH)
    (sB, sS, sH, shp, sN), (fB, fS, fH, fK, fhd) = lm_shapes(
        cfg, LM_BATCH, LM_PROMPT)
    rows = {}
    args = ssd_inputs(sB, sS, sH, shp, sN, dev)
    ops, moved = ssd_ops_bytes(sB, sS, sH, shp, sN)
    rows["ssd_scan"] = dict(
        ms=cuda_time_ms(lambda: ssd_scan(*args), reps=20),
        plain_ms=cuda_time_ms(
            lambda: ssd_scan_ref(*args, chunk=cfg.ssm_chunk), reps=3),
        library_ms=None, operations=ops, bytes=moved,
        shape=[sB, sS, sH, shp, sN])
    del args
    q, k, v = qkv_inputs(fB, fS, fS, fH, fK, fhd, dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ops, moved = flash_ops_bytes(fB, fS, fS, fH, fK, fhd, True, None)
    rows["flash_attention"] = dict(
        ms=cuda_time_ms(lambda: flash_attention(q, k, v), reps=20),
        plain_ms=cuda_time_ms(lambda: flash_attention_ref(q, k, v), reps=3),
        library_ms=cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True), reps=20),
        operations=ops, bytes=moved, shape=[fB, fS, fS, fH, fK, fhd])
    del q, k, v, qt, kt, vt
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)
    shape = scan_shape(get_config(MAMBA1_ARCH), LM_BATCH, LM_PROMPT)
    args = scan_inputs(*shape, dev)
    ops, moved = scan_ops_bytes(*shape)
    rows["selective_scan"] = dict(
        ms=cuda_time_ms(lambda: selective_scan(*args), reps=20),
        plain_ms=cuda_time_ms(lambda: selective_scan_ref(*args), reps=3),
        library_ms=None, operations=ops, bytes=moved, shape=list(shape))
    del args
    for name, r in rows.items():
        r.update(lm_bound(name, r["operations"], r["bytes"]))
        say({"phase": "lm_timing", "kernel": name, **r,
             "share_of_bound": r["bound_ms"] / r["ms"]})
    torch.cuda.empty_cache()
    return rows


def lm_kernel_modules():
    """The LM kernels' wrapper modules by kernel name."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.mamba_scan import kernel as MK
    from repro_torch.kernels.ssd_scan import kernel as SK
    return {"ssd_scan": (SK, SK.ssd_scan),
            "flash_attention": (FK, FK.flash_attention),
            "selective_scan": (MK, MK.selective_scan)}


def lm_expected_launches(cfg) -> dict:
    """Launches of each LM kernel in one full prefill of ``cfg``."""
    if cfg.ssm == "mamba1":
        return {"ssd_scan": 0, "flash_attention": 0,
                "selective_scan": cfg.n_layers}
    return {"ssd_scan": cfg.n_layers,
            "flash_attention": cfg.n_layers // cfg.shared_attn_every,
            "selective_scan": 0}


def lm_serve_path(dev, arch: str):
    """Phase 10: ``arch`` at full width through the port's serving entry
    points (``prefill``, ``greedy_decode``), as
    ``python -m repro_torch.launch.serve`` drives them."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import leaves
    from repro_torch.serve.serve_step import greedy_decode, prefill
    kernels = lm_kernel_modules()

    def reset():
        for mod, _ in kernels.values():
            mod.reset_launches()

    def read():
        return {name: fn.launches for name, (_, fn) in kernels.items()}

    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    synchronize(dev)
    n_params = sum(t.numel() for t in leaves(params))
    say({"phase": "lm_setup", "arch": cfg.name, "params": n_params,
         "analytic_params": cfg.n_params(),
         "seconds": time.perf_counter() - t0})
    cache_len = LM_PROMPT + LM_NEW
    with torch.inference_mode():
        # a first prefill warms the libraries; its logits are the first of
        # the run-twice pair
        first, caches, _ = prefill(params, cfg, prompts, cache_len=cache_len)
        del caches
        synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        t0 = time.perf_counter()
        logits, caches, rolling = prefill(params, cfg, prompts,
                                          cache_len=cache_len)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0
        prefill_launches = read()
        same = torch.equal(first, logits)
        finite = bool(torch.isfinite(logits).all())
        reset()
        marks = [time.perf_counter()]
        step_finite = []

        def on_step(step_logits):
            step_finite.append(torch.isfinite(step_logits).all())
            synchronize(dev)
            marks.append(time.perf_counter())

        tokens = greedy_decode(params, cfg, logits, caches, LM_PROMPT,
                               LM_NEW, rolling=rolling, on_step=on_step)
        decode_launches = read()
    finite &= all(bool(f) for f in step_finite)
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    window_s = marks[-1] - marks[0]
    peak = torch.cuda.max_memory_allocated(dev)
    say({"phase": "lm_serve", "arch": cfg.name, "batch": LM_BATCH,
         "prompt_len": LM_PROMPT, "new_tokens": LM_NEW,
         "prefill_s": t_prefill,
         "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / t_prefill,
         "decode_ms_per_step": float(np.median(step_ms)),
         "decode_ms_per_step_all": step_ms,
         "decode_tokens_per_s": LM_BATCH * 1e3 / float(np.median(step_ms)),
         "decode_window_s": window_s,
         "decode_window_tokens_per_s": LM_BATCH * len(step_ms) / window_s,
         "peak_memory_bytes": peak, "logits_finite": finite,
         "prefill_launches": prefill_launches,
         "decode_launches": decode_launches,
         "prefill_twice_bitwise_equal": same,
         "sample_tokens": tokens[0, :16].tolist()})
    assert finite, "non-finite logits on the serve path"
    assert same, "two full-width prefills gave different logits"
    want = lm_expected_launches(cfg)
    assert prefill_launches == want, (prefill_launches, want)
    assert not any(decode_launches.values()), decode_launches
    del params, caches, logits, first
    torch.cuda.empty_cache()
    return {k: prefill_launches[k] + decode_launches[k]
            for k, v in want.items() if v}


def lm_run(params, cfg, tokens, prompt_len):
    """Teacher-forced prefill + decode over ``tokens`` and greedy
    generation of 8 tokens from the prompt; logits and tokens on the
    host."""
    from repro_torch.serve.serve_step import (decode_step, greedy_generate,
                                              prefill)
    S = tokens.shape[1]
    with torch.inference_mode():
        lg, caches, rolling = prefill(params, cfg, tokens[:, :prompt_len],
                                      cache_len=S)
        steps = [lg.cpu().numpy()]
        for t in range(prompt_len, S):
            lg, caches = decode_step(params, cfg, tokens[:, t:t + 1], caches,
                                     t, rolling=rolling)
            steps.append(lg.cpu().numpy())
        greedy = greedy_generate(params, cfg, tokens[:, :prompt_len], 8)
    return np.stack(steps), greedy.cpu().numpy()


def lm_card_matches_cpu(dev, arch: str, prompt_len: int = 100,
                        steps: int = 8):
    """Phase 11: ``arch``'s reduced configuration on the card and on the
    CPU (plain versions, which the CPU tests hold against the JAX
    reference): teacher-forced logits within 1e-4 of their scale, greedy
    tokens equal."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import tree_map
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(LM_SEED))
    tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (2, prompt_len + steps)))
    on_card = tree_map(lambda t: t.to(dev), params)
    a, ga = lm_run(on_card, cfg, tokens.to(dev), prompt_len)
    b, gb = lm_run(params, cfg, tokens, prompt_len)
    scale = float(np.abs(b).max())
    rel = float(np.abs(a - b).max()) / scale
    same_argmax = bool((a.argmax(-1) == b.argmax(-1)).all())
    same_greedy = bool((ga == gb).all())
    say({"phase": "lm_card_vs_cpu", "arch": cfg.name,
         "prompt_len": prompt_len, "decode_steps": steps,
         "max_rel_diff": rel, "rtol": LM_CARD_CPU_RTOL,
         "argmax_equal": same_argmax, "greedy_tokens_equal": same_greedy})
    assert rel <= LM_CARD_CPU_RTOL, "card and CPU logits disagree"
    assert same_argmax and same_greedy, "card and CPU tokens differ"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.sph_pair import kernel as K
    warnings.simplefilter("ignore", DeprecationWarning)
    t_start = time.perf_counter()
    dev = resolve_device(None)
    card = card_line()
    say({"phase": "card", "nvidia_smi": card,
         "name": torch.cuda.get_device_name(0),
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
         "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    mods = [K] + [mod for mod, _ in lm_kernel_modules().values()]
    t0 = time.perf_counter()
    # each library() builds at first use; from one thread each, one nvcc
    # process each runs at once
    with ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda mod: mod.library(), mods))
    say({"phase": "build", "seconds": time.perf_counter() - t0,
         "log": build.BUILD_LOG})

    spec, cells, pairs, thermo = sedov_setup(dev)
    errs = check_kernels(dev, spec, cells, pairs, thermo)
    timing = time_kernels(spec, cells, pairs, thermo)
    del cells, pairs, thermo
    torch.cuda.empty_cache()

    launches = main_path(dev)
    card_matches_cpu(dev)
    card_matches_cpu(dev, n_side=6)     # the conformance size, C = 88
    global_path(dev)
    determinism(dev)

    errs.update(lm_check_kernels(dev))
    timing.update(lm_time_kernels(dev))
    for arch in (LM_ARCH, MAMBA1_ARCH):
        launches.update(lm_serve_path(dev, arch))
    for arch in (LM_ARCH, MAMBA1_ARCH):
        lm_card_matches_cpu(dev, arch)

    sph = "src/repro_torch/kernels/sph_pair/csrc/sph_pair.cu"
    source = {"density_pair": sph, "force_pair": sph,
              "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
              "flash_attention": "src/repro_torch/kernels/flash_attention/"
                                 "csrc/flash_attention.cu",
              "selective_scan": "src/repro_torch/kernels/mamba_scan/csrc/"
                                "selective_scan.cu"}
    replaces = {"density_pair": "src/repro/kernels/sph_pair/kernel.py:132",
                "force_pair": "src/repro/kernels/sph_pair/kernel.py:224",
                "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:82",
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:80",
                "selective_scan": "src/repro/kernels/mamba_scan/kernel.py:51"}
    say({"kernels": [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": timing[name]["ms"],
         "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name].get("library_ms")}
        for name in source]})
    say({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
