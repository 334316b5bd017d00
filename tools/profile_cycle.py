"""Where one time-bin cycle of the main path spends the card's time.

    python3 tools/profile_cycle.py [n_side=64] [max_depth=4]

Builds ``chip_smoke.py``'s main path (``chip_smoke.sedov_spec``) on the
CUDA device, runs one cycle to warm up and one unprofiled (its wall is
printed for comparison), then one under ``torch.profiler`` recording CUDA
activity only. Prints one JSON line: the
cycles' wall seconds, the device time summed over every device-side event
of the profiled cycle (kernels, copies, fills), the device's idle share
over that cycle (1 − device time / wall), and the ten largest device-time
entries. If the profiler reports no device time, says so instead.
"""

import json
import os
import sys
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import sedov_spec  # noqa: E402
from repro_torch.sph import build_simulation  # noqa: E402


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


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
    top = sorted(rows, key=lambda r: -r[1])[:10]
    print(json.dumps({
        "n_side": n_side, "max_depth": max_depth,
        "device": torch.cuda.get_device_name(0),
        "substeps": stats["substeps"], "wall_s": wall,
        "unprofiled_wall_s": wall_plain,
        "device_s": busy if rows else None,
        "idle_share": (1.0 - busy / wall) if rows else "not measured",
        "top_device": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                       for k, us, n in top]}), flush=True)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]]
    main(*args)
