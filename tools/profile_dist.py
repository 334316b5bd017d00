"""Where one step of the global × distributed quadrant spends its time.

    python3 tools/profile_dist.py [n_side=48] [ranks=4] [halo=ring]

Builds ``chip_smoke.py``'s distributed spec (``chip_smoke.dist_spec``:
Sedov ``n_side``³, global dt, ``ranks`` ranks stacked on the CUDA device;
the decomposition runs once, in the build), takes one step to warm up and
one unprofiled (its wall is printed), then one under ``torch.profiler``
recording CUDA activity only, then one more recording host activity too,
with the step's pieces labelled (``PIECES``: each function of
``repro_torch.sph.distributed`` wrapped in a ``record_function`` range for
that step). Prints one JSON line: the steps' wall seconds; over the
CUDA-only step, the device time summed over every device-side event, the
device's idle share (1 − device time / wall), the ten largest device-time
entries and the pair kernels' device time; and for each piece in the
labelled step its host milliseconds (the range's span on the host clock:
its indexing and launches), its device milliseconds (the device events of
the host ops inside it) and its calls. The pair kernels are launched
through ctypes, so the profiler ties them to no host op: the pieces leave
them out, and ``kernels_device_ms`` reports them by name, beside the same
kernels' device ms in one step of the local global-dt engine on the same
initial conditions (each pair once, both sides kept). If the profiler
reports no device time, says so instead.
"""

import json
import os
import sys
import time
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import DIST_DT, dist_spec, sedov_spec  # noqa: E402
from repro_torch.sph import build_simulation  # noqa: E402
from repro_torch.sph import distributed as D  # noqa: E402

# the halo exchanges, the extended (owned + halo) arrays, the force
# kernel's gathered blocks and the per-rank sums; the two pair loops
# contain their kernel launch, their gathers and their sums
PIECES = ("_exchange", "_extend", "_pair_density", "_pair_force",
          "_force_blocks", "_rank_sums")
PORT_KERNELS = ("density_pair_kernel", "force_pair_kernel")


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def labelled_step(sim) -> dict:
    """One step with each of PIECES run inside a ``record_function``
    range; each piece's host ms, device ms and calls (ranges nest: a pair
    loop includes its gathers and sums)."""
    saved = {n: getattr(D, n) for n in PIECES}

    def label(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    for name, fn in saved.items():
        setattr(D, name, label(name, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.step()
            torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(D, name, fn)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ops = [e for e in events if e.name not in saved and e.kernels]
    pieces = {}
    for r in (e for e in events if e.name in saved):
        us = sum(k.duration for e in ops if e.thread == r.thread
                 and r.time_range.start <= e.time_range.start
                 and e.time_range.end <= r.time_range.end
                 for k in e.kernels)
        d = pieces.setdefault(r.name, {"host_ms": 0.0, "device_ms": 0.0,
                                       "calls": 0})
        d["host_ms"] += (r.time_range.end - r.time_range.start) / 1e3
        d["device_ms"] += us / 1e3
        d["calls"] += 1
    return pieces


def local_kernels_ms(n_side: int) -> dict:
    """The pair kernels' device ms in one step of the local global-dt
    engine on the same initial conditions and dt: every pair once, both
    sides kept (the distributed step runs each same-rank pair twice and
    keeps one side of each)."""
    local = build_simulation(sedov_spec(n_side, integrator="global",
                                        dt=DIST_DT, rebin_every=100))
    local.step()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        local.step()
    return {e.key[:60]: device_us(e) / 1e3 for e in prof.key_averages()
            if any(n in e.key for n in PORT_KERNELS)}


def main(n_side: int = 48, ranks: int = 4, halo: str = "ring") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_dist: needs a CUDA device")
    warnings.simplefilter("ignore", DeprecationWarning)
    t0 = time.perf_counter()
    sim = build_simulation(dist_spec(n_side, halo=halo, ranks=ranks))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sim.step()
    t0 = time.perf_counter()
    sim.step()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step()
        wall = time.perf_counter() - t0
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:10]
    kernels = {k[:60]: us / 1e3 for k, us, _ in rows
               if any(n in k for n in PORT_KERNELS)}
    pieces = labelled_step(sim)
    if not any(v["device_ms"] for v in pieces.values()):
        pieces = "not measured"
    plan = sim.engine.plan
    local = local_kernels_ms(n_side)
    print(json.dumps({
        "n_side": n_side, "ranks": ranks, "halo": halo,
        "device": torch.cuda.get_device_name(0),
        "entries": plan.ndev * plan.Pmax, "K": plan.K, "Bi": plan.Bi,
        "build_s": build_s, "setup_s": sim.engine.setup_s,
        "wall_s": wall, "unprofiled_wall_s": wall_plain,
        "device_s": busy if rows else None,
        "idle_share": (1.0 - busy / wall) if rows else "not measured",
        "top_device": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                       for k, us, n in top],
        "kernels_device_ms": kernels,
        "local_engine_kernels_device_ms": local,
        "pieces": pieces}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:4]
    main(*(int(a) for a in args[:2]), *args[2:3])
