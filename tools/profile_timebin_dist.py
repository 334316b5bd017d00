"""Where one cycle of the time-bin × distributed quadrant spends its time.

    python3 tools/profile_timebin_dist.py [n_side=48] [ranks=4] [transport=collective] [residency=host]

Builds ``chip_smoke.py``'s phase-6e spec (``chip_smoke.tb_spec``: Sedov
``n_side``³, the depth-4 ladder, ``ranks`` per-rank states on the CUDA
device, ``transport`` ``host`` or ``collective``, ``residency`` ``host`` or
``device`` — the stacked resident states and one fused program a sub-step;
the decomposition runs once, in the build), runs one cycle to warm up and
one unprofiled (its
wall is printed), then one under ``torch.profiler`` recording CUDA
activity only, then one more recording host activity too, with the
cycle's pieces labelled (``PIECES``: each engine method wrapped in a
``record_function`` range for that cycle). Prints one JSON line: the
cycles' wall seconds; over the CUDA-only cycle, the device time summed
over every device-side event, the device's idle share (1 − device time /
wall), the ten largest device-time entries and the pair kernels' device
time and launches; and for each piece in the labelled cycle its host
milliseconds (the range's span on the host clock), its device
milliseconds (the device events of the host ops inside it) and its calls.
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
          "_fused_program")
FUSED_CALL = "fused_call"
PORT_KERNELS = ("density_pair_kernel", "force_pair_kernel")


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _owners(eng):
    for name in PIECES:
        yield (eng._transport if name == "exchange" else eng), name


def labelled_cycle(sim) -> dict:
    """One cycle with each of PIECES run inside a ``record_function``
    range; each piece's host ms, device ms and calls."""
    eng = sim.engine
    saved = []
    for obj, name in _owners(eng):
        fn = getattr(obj, name)

        def run(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                out = _fn(*a, **k)
            if _name != "_fused_program":
                return out

            def call(*pa, **pk):
                with record_function(FUSED_CALL):
                    return out(*pa, **pk)
            return call
        saved.append((obj, name, fn))
        setattr(obj, name, run)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.step()
            torch.cuda.synchronize()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    names = set(PIECES) | {FUSED_CALL}
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


def main(n_side: int = 48, ranks: int = 4,
         transport: str = "collective", residency: str = "host") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_timebin_dist: needs a CUDA device")
    warnings.simplefilter("ignore", DeprecationWarning)
    spec = tb_spec(n_side, transport=transport).with_(ranks=ranks,
                                                      residency=residency)
    t0 = time.perf_counter()
    sim = build_simulation(spec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sim.step()
    t0 = time.perf_counter()
    st_plain = sim.step()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = sim.step()
        wall = time.perf_counter() - t0
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:10]
    kernels = {k[:60]: {"device_ms": us / 1e3, "launches": n}
               for k, us, n in rows if any(p in k for p in PORT_KERNELS)}
    pieces = labelled_cycle(sim)
    if not any(v["device_ms"] for v in pieces.values()):
        pieces = {"note": "no device time attributed", **pieces}
    eng = sim.engine
    plan = eng._get_plan()
    print(json.dumps({
        "n_side": n_side, "ranks": ranks, "transport": transport,
        "residency": residency,
        "device": torch.cuda.get_device_name(0),
        "K": plan.K, "H": plan.H, "cut_slots": plan.cut_slots,
        "build_s": build_s, "setup_s": eng.setup_s,
        "unprofiled_wall_s": wall_plain,
        "unprofiled_force_substeps": st_plain["force_substeps"],
        "wall_s": wall, "force_substeps": st["force_substeps"],
        "halo_exported_slots": st["halo_exported_slots"],
        "halo_full_slots": st["halo_full_slots"],
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
    args = sys.argv[1:5]
    main(*(int(a) for a in args[:2]), *args[2:4])
