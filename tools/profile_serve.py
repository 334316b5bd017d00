"""Where a serve path spends the card's time.

    python3 tools/profile_serve.py [--arch zamba2-1.2b] [batch=4]
        [prompt_len=2048] [steps=8]

Builds ``chip_smoke.py``'s serve configuration of ``--arch`` (zamba2-1.2b,
falcon-mamba-7b, granite-8b, gemma-7b at full width, gemma3-27b at full
width cut to ``chip_smoke.GEMMA3_LAYERS`` layers; f32, random weights from
a seeded generator) on the CUDA device, warms up
with one prefill, then profiles the first decode step (the first use of
the decode shapes), one prefill and ``steps`` decode steps under
``torch.profiler`` (CUDA activity only), each window on its own. Prints
one JSON line per window: its wall seconds, the device time summed over
every device-side event (kernels, copies, fills), the device's idle share
(1 − device time / wall), the time of each of the port's LM kernels, the
matrix products' (every entry whose name holds ``gemm``) and their shares
of the device time, and the ten largest device-time entries. If the profiler
reports no device time, says so instead. Stops without a CUDA device.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from chip_smoke import GEMMA3_LAYERS, LM_ARCH, LM_SEED  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    decode_step, greedy_decode, prefill)

KERNELS = {"ssd_scan": "ssd_scan_kernel", "flash_attention": "flash_kernel",
           "selective_scan": "selective_scan_kernel"}


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def report(window: str, prof, wall: float, extra: dict) -> None:
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows) / 1e6
    kern = {name: sum(us for k, us, _ in rows if tag in k) / 1e3
            for name, tag in KERNELS.items()}
    gemm = sum(us for k, us, _ in rows if "gemm" in k.lower()) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:10]
    print(json.dumps({
        "window": window, **extra, "wall_s": wall,
        "device_s": busy if rows else None,
        "idle_share": (1.0 - busy / wall) if rows else "not measured",
        "kernel_device_ms": kern,
        "kernel_share": ({k: ms / 1e3 / busy for k, ms in kern.items()}
                         if rows else None),
        "gemm_device_ms": gemm,
        "gemm_share": gemm / 1e3 / busy if rows else None,
        "top_device": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                       for k, us, n in top]}), flush=True)


def main(arch: str = LM_ARCH, batch: int = 4, prompt_len: int = 2048,
         steps: int = 8) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    if arch == "gemma3-27b":
        cfg = dataclasses.replace(cfg, n_layers=GEMMA3_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device=dev)
    cache_len = prompt_len + steps + 1
    extra = {"card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
             "batch": batch, "prompt_len": prompt_len}
    with torch.inference_mode():
        logits, caches, rolling = prefill(params, cfg, prompts,
                                          cache_len=cache_len)
        tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode_step(params, cfg, tok, caches, prompt_len, rolling=rolling)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("decode_first", prof, wall, dict(extra, steps=1))
        del caches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, caches, rolling = prefill(params, cfg, prompts,
                                              cache_len=cache_len)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("prefill", prof, wall, extra)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            greedy_decode(params, cfg, logits, caches, prompt_len, steps + 1,
                          rolling=rolling)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("decode", prof, wall, dict(extra, steps=steps))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=LM_ARCH)
    ap.add_argument("sizes", nargs="*", type=int,
                    help="batch, prompt_len, steps")
    args = ap.parse_args()
    main(args.arch, *args.sizes[:3])
