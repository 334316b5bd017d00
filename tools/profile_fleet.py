"""Where the fleet serve path spends the card's time.

    python3 tools/profile_fleet.py [n_side=32] [requests=16] [steps=4]

Serves ``chip_smoke.py``'s fleet cell (``--scenario mixed``, 3 waves) on
the CUDA device through ``repro_torch.fleet.__main__.serve`` once to warm
up, then once under ``torch.profiler`` recording CUDA activity. Prints one
JSON line: both runs' walls and host seconds by phase (the runner's
``host_s``: build, re-bin and stack, steps, results; the warm-up run's as
``first_*``), the profiled run's device time summed over every device-side
event, its idle share (1 − device time / wall), the ten largest
device-time entries and the port's pair kernels' device time; then the
device time of one batched step of 8 Sedov lanes and of one lane's step,
each profiled alone. If the profiler reports no device time, says so
instead.
"""

import json
import os
import sys
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import FLEET_WAVES, fleet_argv, fleet_lanes  # noqa: E402
from repro_torch.fleet.__main__ import serve  # noqa: E402

PORT_KERNELS = ("density_pair_kernel", "force_pair_kernel")


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_rows(prof):
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    return [r for r in rows if r[1] > 0]


def step_device_ms(n_side: int, bucket: int) -> dict:
    """One batched step of ``bucket`` Sedov lanes, profiled after a warm
    one: summed device ms, and the step's wall."""
    _, pairs, _, step = fleet_lanes(torch.device("cuda"), bucket, n_side)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    return {"lanes": bucket, "pairs": int(pairs.ci.shape[0]),
            "wall_ms": 1e3 * wall,
            "device_ms": sum(r[1] for r in rows) / 1e3 if rows
            else "not measured",
            "port_kernels_ms": {k[:40]: us / 1e3 for k, us, _ in rows
                                if any(n in k for n in PORT_KERNELS)}}


def main(n_side: int = 32, requests: int = 16, steps: int = 4) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_fleet: needs a CUDA device")
    warnings.simplefilter("ignore", DeprecationWarning)
    argv = fleet_argv(n_side, requests, steps, FLEET_WAVES)
    rc0, first, _, _ = serve(argv)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc1, out, _, _ = serve(argv)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:10]
    print(json.dumps({
        "n_side": n_side, "requests": requests, "steps": steps,
        "device": torch.cuda.get_device_name(0), "rc": [rc0, rc1],
        "first_wall_s": first["wall_s"],
        "first_host_s": first["stats"]["host_s"],
        "wall_s": out["wall_s"], "host_s": out["stats"]["host_s"],
        "particle_steps_per_s": out["particle_steps_per_s"],
        "device_s": busy if rows else None,
        "idle_share": (1.0 - busy / out["wall_s"]) if rows
        else "not measured",
        "top_device": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                       for k, us, n in top],
        "port_kernels_device_ms": {k[:40]: us / 1e3 for k, us, _ in rows
                                   if any(n in k for n in PORT_KERNELS)},
        "step_8_lanes": step_device_ms(n_side, 8),
        "step_1_lane": step_device_ms(n_side, 1)}), flush=True)


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:4]])
