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
   (C = 40, a chunk of 8,192 pairs around the blast centre), the pair
   momentum antisymmetry, and a padded, masked pair list contributing +0.0;
4. kernel times (median of CUDA-event timed launches) at the full pair list
   (P = 307,328), beside the bound and the plain version's time;
5. the main path: Sedov 64³ through the hierarchical time-bin ladder
   (``build_simulation(SimulationSpec(integrator="timebin"))``, max_depth
   cut to 4, see MAIN_MAX_DEPTH) for two cycles, with the kernels' launch
   counts read around it; then the same small run (Sedov 10³ at depth 4)
   on the card and on the CPU, compared;
6. the global-dt engine on the same initial conditions, 3 steps, with the
   kernels' launch counts read around it;
7. run-twice bitwise determinism of a one-cycle Sedov 16³ run.

Then the ``kernels`` JSON line, the card line, and as the last line
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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.device import synchronize  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor-core f32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
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


def sedov_setup(dev):
    """Sedov 64³ binned on the card, its full pair list, and the density /
    ghost fields the force kernel reads."""
    from repro_torch.sph import SPHConfig
    from repro_torch.sph.cellgrid import bin_particles, build_pair_list, \
        choose_grid
    from repro_torch.sph.engine import _density_pass
    from repro_torch.sph.ic import sedov_ic
    from repro_torch.sph.physics import ghost_update
    ic = sedov_ic(NSIDE)
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


def check_kernels(dev, spec, cells, pairs, thermo):
    """Phase 3: each kernel against its plain version, antisymmetry, and
    masked padding."""
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
    for alpha in (0.0, 1.0):
        got = K.force_pair(*force_in, alpha_visc=alpha)
        want = ref.force_pair_ref(*force_in, alpha_visc=alpha)
        mask_i, mask_j = force_in[8], force_in[17]
        masks = (mask_i[..., None], mask_i, mask_j[..., None], mask_j)
        e, ok = max_err([g * m for g, m in zip(got, masks)],
                        [w * m for w, m in zip(want, masks)],
                        RTOL["force_pair"])
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
        say({"phase": "parity", "kernel": "force_pair", "alpha_visc": alpha,
             "pairs": len(idx), "max_abs_err": e, "ok": ok,
             "antisymmetry_max_rel": ratio, "antisymmetry_ok": anti_ok})
        assert ok, f"force_pair (alpha={alpha}) disagrees with plain version"
        assert anti_ok, "force_pair breaks pair momentum antisymmetry"
        errs["force_pair"] = max(errs["force_pair"], e)
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


def time_kernels(spec, cells, pairs, thermo):
    """Phase 4: kernel and plain-version times at the full pair list, with
    the bound reckoned from this run's inputs."""
    from repro_torch.kernels.sph_pair import kernel as K, ops, ref
    dens_in = ops.density_inputs(cells, pairs)
    force_in = ops.force_inputs(cells, pairs, *thermo)
    occ = cells.mask.sum(1).double()
    live = float((occ[pairs.ci.long()] * occ[pairs.cj.long()]).sum())
    rows = {}
    for name, fn, plain, args in (
            ("density_pair", K.density_pair, ref.density_pair_ref, dens_in),
            ("force_pair", lambda *a: K.force_pair(*a, alpha_visc=1.0),
             lambda *a: ref.force_pair_ref(*a, alpha_visc=1.0), force_in)):
        ms = cuda_time_ms(lambda: fn(*args), reps=10)
        plain_ms = cuda_time_ms(lambda: plain(*args), reps=1)
        out = fn(*args)
        moved = nbytes(args) + nbytes(out)
        ops_n = live * OPS_PER_ELEMENT[name]
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops_n / PEAK_F32_FLOPS * 1e3
        rows[name] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations",
                          bytes=moved, operations=ops_n,
                          live_slot_pairs=live)
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
    while its ladder still takes interior sub-steps; the conformance size
    6³ would bin into 2³ cells of capacity 88, past what the force kernel's
    shared memory holds (C ≤ 83)."""
    from repro_torch.sph import build_simulation
    from repro_torch.sph.convert import to_numpy
    spec = sedov_spec(n_side, max_depth=max_depth)
    runs = []
    for d in (dev, "cpu"):
        sim = build_simulation(spec, device=d)
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
    say({"phase": "card_vs_cpu", "n_side": n_side, "max_depth": max_depth,
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

    t0 = time.perf_counter()
    K.library()
    say({"phase": "build", "seconds": time.perf_counter() - t0,
         "log": build.BUILD_LOG.get("sph_pair")})

    spec, cells, pairs, thermo = sedov_setup(dev)
    errs = check_kernels(dev, spec, cells, pairs, thermo)
    timing = time_kernels(spec, cells, pairs, thermo)
    del cells, pairs, thermo
    torch.cuda.empty_cache()

    launches = main_path(dev)
    card_matches_cpu(dev)
    global_path(dev)
    determinism(dev)

    src = "src/repro_torch/kernels/sph_pair/csrc/sph_pair.cu"
    replaces = {"density_pair": "src/repro/kernels/sph_pair/kernel.py:132",
                "force_pair": "src/repro/kernels/sph_pair/kernel.py:224"}
    say({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": timing[name]["ms"],
         "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"], "library_ms": None}
        for name in ("density_pair", "force_pair")]})
    say({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
