"""Where one cycle of the time-bin × distributed quadrant spends its time.

    python3 tools/profile_timebin_dist.py [n_side=48] [ranks=4] [transport=collective] [residency=host] [schedule=host] [segment_cycles=1]

Builds ``chip_smoke.py``'s phase-6e spec (``chip_smoke.tb_spec``: Sedov
``n_side``³, the depth-4 ladder, ``ranks`` per-rank states on the CUDA
device, ``transport`` ``host`` or ``collective``, ``residency`` ``host`` or
``device`` — the stacked resident states and one fused program a sub-step
— and at device residency ``schedule`` ``host`` or ``device``, the
latter in segments of ``segment_cycles`` cycles, one program a cycle; the
decomposition runs once, in the build). It measures in segments (one
cycle at the host schedule): one to warm up and one unprofiled (its wall
is printed), then one under ``torch.profiler`` recording CUDA activity
only, then one more recording host activity too, with the segment's
pieces labelled (``PIECES``: each engine method wrapped in a
``record_function`` range). Prints one JSON line: the segments' wall
seconds and per cycle; over the CUDA-only segment, the device time summed
over every device-side event, the device's idle share (1 − device time /
wall), the ten largest device-time entries and the pair kernels' device
time and launches; and for each piece in the labelled segment its host
milliseconds (the range's span on the host clock), its device
milliseconds (the device events of the host ops inside it) and its calls.
At the device schedule the pieces are the segment's: the table upload
(``_segment_tables``, ``_place_scalars``), the trips (``scan_call``, one
call a cycle), the plan calls (``plan_call``), the boundary pull
(``_pull_segment``), the gather, re-binning and the repartition check, and
the host prologue of its first cycle (``_plan_cycle``).
The pair kernels are launched through ctypes, so the profiler ties them to
no host op: the phase pieces leave them out, and ``kernels_device_ms``
reports them by name. If the profiler reports no device time, says so.
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

from chip_smoke import tb_spec  # noqa: E402
from repro_torch.sph import build_simulation  # noqa: E402

# engine methods: the sub-step's pair subsets and incoming tables (host),
# the exchanges, the owned bins pulled to the host, the per-rank phases
# (their kernels' launches are reported apart), drift, the scatter and
# gather of the global mirror, the cycle plan, re-binning and the
# repartition check
PIECES = ("_rank_pair_subsets", "exchange", "_pull_owned_bins",
          "_sub_density_p", "_sub_force_p", "_final_density_p",
          "_final_force_p", "_drift", "_scatter_state", "_gather_state",
          "_plan_cycle", "_rebin_state", "_maybe_repartition",
          # device residency: the stacked scatter and gather, each
          # sub-step's tables, and each call of its fused program
          # ("fused_call": the engine fetches it through _fused_program)
          "_scatter_resident", "_gather_resident", "_fused_tables",
          "_fused_program",
          # device schedule: the segment's table upload, its programs
          # (fetched through _cycle_scan_program / _plan_program and called
          # once a cycle: "scan_call", "plan_call") and the boundary pull
          "_segment_tables", "_place_scalars", "_cycle_scan_program",
          "_plan_program", "_pull_segment")
# program getters whose returned program's calls are labelled too
CALLS = {"_fused_program": "fused_call", "_cycle_scan_program": "scan_call",
         "_plan_program": "plan_call"}
PORT_KERNELS = ("density_pair_kernel", "force_pair_kernel")


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _owners(eng):
    for name in PIECES:
        yield (eng._transport if name == "exchange" else eng), name


def labelled_cycle(sim, steps: int = 1) -> dict:
    """``steps`` cycles (a segment) with each of PIECES run inside a
    ``record_function`` range; each piece's host ms, device ms and
    calls."""
    eng = sim.engine
    saved = []
    for obj, name in _owners(eng):
        fn = getattr(obj, name)

        def run(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                out = _fn(*a, **k)
            if _name not in CALLS:
                return out

            def call(*pa, **pk):
                with record_function(CALLS[_name]):
                    return out(*pa, **pk)
            return call
        saved.append((obj, name, fn))
        setattr(obj, name, run)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                sim.step()
            torch.cuda.synchronize()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    names = set(PIECES) | set(CALLS.values())
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ops = [e for e in events if e.name not in names and e.kernels]
    pieces = {}
    for r in (e for e in events if e.name in names):
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


def segment(sim, steps: int) -> tuple:
    """``steps`` cycles: (their stats, the wall to the last one's end)."""
    t0 = time.perf_counter()
    stats = [sim.step() for _ in range(steps)]
    torch.cuda.synchronize()
    return stats, time.perf_counter() - t0


def main(n_side: int = 48, ranks: int = 4,
         transport: str = "collective", residency: str = "host",
         schedule: str = "host", segment_cycles: int = 1) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_timebin_dist: needs a CUDA device")
    warnings.simplefilter("ignore", DeprecationWarning)
    spec = tb_spec(n_side, transport=transport).with_(
        ranks=ranks, residency=residency, schedule=schedule,
        segment_cycles=segment_cycles)
    steps = int(segment_cycles)
    t0 = time.perf_counter()
    sim = build_simulation(spec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    segment(sim, steps)
    plain, wall_plain = segment(sim, steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stats, wall = segment(sim, steps)
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:10]
    kernels = {k[:60]: {"device_ms": us / 1e3, "launches": n}
               for k, us, n in rows if any(p in k for p in PORT_KERNELS)}
    pieces = labelled_cycle(sim, steps)
    if not any(v["device_ms"] for v in pieces.values()):
        pieces = {"note": "no device time attributed", **pieces}
    eng = sim.engine
    plan = eng._get_plan()
    print(json.dumps({
        "n_side": n_side, "ranks": ranks, "transport": transport,
        "residency": residency, "schedule": schedule,
        "segment_cycles": steps,
        "device": torch.cuda.get_device_name(0),
        "K": plan.K, "H": plan.H, "cut_slots": plan.cut_slots,
        "build_s": build_s, "setup_s": eng.setup_s,
        "unprofiled_wall_s": wall_plain,
        "unprofiled_wall_per_cycle_s": wall_plain / steps,
        "unprofiled_force_substeps": [s["force_substeps"] for s in plain],
        "wall_s": wall, "wall_per_cycle_s": wall / steps,
        "force_substeps": [s["force_substeps"] for s in stats],
        "substeps": [s["substeps"] for s in stats],
        "halo_exported_slots": [s["halo_exported_slots"] for s in stats],
        "halo_full_slots": [s["halo_full_slots"] for s in stats],
        "segments": getattr(eng, "segments", None),
        "segment_aborts": getattr(eng, "segment_aborts", None),
        "segment_flags_last": getattr(eng, "segment_flags_last", None),
        "repartitions": eng.repartitions,
        "repartition_s": eng.repartition_seconds,
        "device_s": busy if rows else None,
        "idle_share": (1.0 - busy / wall) if rows else "not measured",
        "top_device": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                       for k, us, n in top],
        "kernels_device_ms": kernels,
        "transport_stats": {k: v for k, v in eng.transport_stats().items()
                            if k != "compiles"},
        "pieces": pieces}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:7]
    main(*(int(a) for a in args[:2]), *args[2:5],
         *(int(a) for a in args[5:6]))
