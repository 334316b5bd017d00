"""Where one time-bin cycle of the main path spends the card's time.

    python3 tools/profile_cycle.py [n_side=64] [max_depth=4]

Builds ``chip_smoke.py``'s main path (``chip_smoke.sedov_spec``) on the
CUDA device, runs one cycle to warm up and one unprofiled (its wall is
printed for comparison), then one under ``torch.profiler`` recording CUDA
activity only, then one more recording host activity too, with the pair
passes' pieces labelled (``PIECES``: each function of
``repro_torch.kernels.sph_pair.ops`` that exists in the tree, wrapped in a
``record_function`` range for that cycle). Prints one JSON line: the
cycles' wall seconds; over the CUDA-only cycle, the device time summed over
every device-side event (kernels, copies, fills), the device's idle share
(1 − device time / wall), the device time without the host copies
(``kernel_s``: their time follows the host's paging), the ten largest
device-time entries and the port's pair kernels' device time; and each
piece's device time and calls in the labelled cycle (ranges nest: a pass
includes its gather and sums). If the profiler reports no device time,
says so instead.
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

from chip_smoke import sedov_spec  # noqa: E402
from repro_torch.kernels.sph_pair import ops  # noqa: E402
from repro_torch.sph import build_simulation  # noqa: E402

# the pair passes (density_pairs, force_pairs) and the PyTorch work they
# call: the gathers of the pair blocks and the per-cell sums. The port's own
# kernels are launched through ctypes, so the profiler ties them to no host
# op: the passes' figures leave them out, and PORT_KERNELS reports them by
# name.
PIECES = ("density_pairs", "force_pairs", "density_inputs", "force_inputs",
          "_cell_sums")
PORT_KERNELS = ("density_pair_kernel", "force_pair_kernel")


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def labelled_cycle(sim) -> dict:
    """One cycle with each of PIECES present in ``ops`` run inside a
    ``record_function`` range; each piece's device ms and calls. A piece's
    device time is the sum of the device events (kernels, copies) of the
    host ops inside its range on the same thread: the profiler's own total
    for a range is the span of its device activity, idle gaps included."""
    saved = {n: getattr(ops, n) for n in PIECES if hasattr(ops, n)}

    def label(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    for name, fn in saved.items():
        setattr(ops, name, label(name, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.step()
            torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ops_ = [e for e in events if e.name not in saved and e.kernels]
    pieces = {}
    for r in (e for e in events if e.name in saved):
        us = sum(k.duration for e in ops_ if e.thread == r.thread
                 and r.time_range.start <= e.time_range.start
                 and e.time_range.end <= r.time_range.end
                 for k in e.kernels)
        d = pieces.setdefault(r.name, {"device_ms": 0.0, "calls": 0})
        d["device_ms"] += us / 1e3
        d["calls"] += 1
    return pieces


def main(n_side: int = 64, max_depth: int = 4) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_cycle: needs a CUDA device")
    warnings.simplefilter("ignore", DeprecationWarning)
    sim = build_simulation(sedov_spec(n_side, max_depth=max_depth))
    sim.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = sim.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows) / 1e6
    copies = sum(r[1] for r in rows if r[0].startswith(("Memcpy", "Memset")))
    top = sorted(rows, key=lambda r: -r[1])[:10]
    port = {k[:60]: us / 1e3 for k, us, _ in rows
            if any(n in k for n in PORT_KERNELS)}
    pieces = labelled_cycle(sim)
    if not any(v["device_ms"] for v in pieces.values()):
        pieces = "not measured"
    print(json.dumps({
        "n_side": n_side, "max_depth": max_depth,
        "device": torch.cuda.get_device_name(0),
        "substeps": stats["substeps"], "wall_s": wall,
        "unprofiled_wall_s": wall_plain,
        "device_s": busy if rows else None,
        "kernel_s": (busy - copies / 1e6) if rows else None,
        "idle_share": (1.0 - busy / wall) if rows else "not measured",
        "top_device": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                       for k, us, n in top],
        "port_kernels_device_ms": port,
        "pieces": pieces}), flush=True)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]]
    main(*args)
