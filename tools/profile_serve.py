"""Where a serve path spends the card's time.

    python3 tools/profile_serve.py [--arch zamba2-1.2b] [--dtype float32]
        [--ssm-bf16] [batch] [prompt_len=2048] [steps=8]

Builds ``chip_smoke.py``'s serve configuration of ``--arch`` (zamba2-1.2b,
falcon-mamba-7b, granite-8b, gemma-7b, qwen1.5-32b, seamless-m4t-large-v2,
internvl2-2b, mixtral-8x7b, mixtral-8x22b at full width; random weights
from a seeded generator; the enc-dec model's encoder frames, as many as
the prompt's tokens, and the VLM's patch embeddings drawn as ``python -m
repro_torch.launch.serve`` draws them) on the CUDA device in ``--dtype``:
f32 (gemma3-27b cut to ``chip_smoke.GEMMA3_LAYERS`` layers; qwen1.5-32b
does not fit) or bf16, the configuration's own (gemma3-27b at all 62
layers, qwen1.5-32b at batch 1 unless a batch is given; ``--ssm-bf16``
sets the Mamba-2 ``ssm_bf16`` path); the mixtrals, which do not fit the
card at full size, at ``chip_smoke.MOE_LAYERS``'s layer cut of the dtype
(f32 12 and 6 layers, bf16 24 and 12). It warms up with one prefill, then profiles the first decode step (the first use of
the decode shapes), one prefill and ``steps`` decode steps under
``torch.profiler`` (CUDA activity only), each window on its own. Prints
one JSON line per window: its wall seconds, the device time summed over
every device-side event (kernels, copies, fills), the device's idle share
(1 − device time / wall), the time of each of the port's LM kernels (both
entries of each) beside the profiler's count of its device events and the
wrappers' count of their launches in the window, the matrix products'
(every entry whose name holds
``gemm``, ``gemv`` or ``nvjet``, cuBLAS's Hopper kernels) and their shares
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

from chip_smoke import (BF16_SERVE, LM_ARCH, LM_SEED,  # noqa: E402
                        lm_kernel_modules, lm_launches, serve_layers)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import frontend_inputs  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    decode_step, greedy_decode, prefill)

# name fragments of each LM kernel's device functions (the bf16 flash
# entry's Hopper kernel at hd 64, 128 and 256 is flash_bf16_hopper, the
# bf16 SSD entry's at N = hp = 64 ssd_bf16_hopper)
KERNELS = {"ssd_scan": ("ssd_scan_kernel", "ssd_bf16_hopper"),
           "flash_attention": ("flash_kernel", "flash_bf16_hopper"),
           "selective_scan": ("selective_scan_kernel",)}
GEMM_TAGS = ("gemm", "gemv", "nvjet")


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def reset_launches() -> None:
    for mod, _ in lm_kernel_modules().values():
        mod.reset_launches()


def report(window: str, prof, wall: float, extra: dict) -> None:
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows) / 1e6
    kern = {name: sum(us for k, us, _ in rows
                      if any(tag in k for tag in tags)) / 1e3
            for name, tags in KERNELS.items()}
    events = {name: sum(n for k, _, n in rows
                        if any(tag in k for tag in tags))
              for name, tags in KERNELS.items()}
    gemm = sum(us for k, us, _ in rows
               if any(t in k.lower() for t in GEMM_TAGS)) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:10]
    print(json.dumps({
        "window": window, **extra, "wall_s": wall,
        "device_s": busy if rows else None,
        "idle_share": (1.0 - busy / wall) if rows else "not measured",
        "kernel_device_ms": kern, "kernel_device_events": events,
        "wrapper_launches": {k: n for k, n in lm_launches().items() if n},
        "kernel_share": ({k: ms / 1e3 / busy for k, ms in kern.items()}
                         if rows else None),
        "gemm_device_ms": gemm,
        "gemm_share": gemm / 1e3 / busy if rows else None,
        "top_device": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                       for k, us, n in top]}), flush=True)


def main(arch: str = LM_ARCH, dtype: str = "float32", ssm_bf16: bool = False,
         batch: int = None, prompt_len: int = 2048, steps: int = 8) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    cfg = dataclasses.replace(get_config(arch), ssm_bf16=ssm_bf16)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    n_layers = serve_layers(arch, cfg.dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if batch is None:
        batch = 4 if dtype == "float32" else {a: b for a, b, _ in
                                               BF16_SERVE}.get(arch, 4)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device=dev)
    front = frontend_inputs(cfg, batch, prompt_len, gen, dev)
    P = cfg.vlm_patches                 # the patches come before the prompt
    cache_len = prompt_len + steps + 1 + P
    extra = {"card": card, "arch": cfg.name, "dtype": str(cfg.dtype),
             "ssm_bf16": ssm_bf16, "n_layers": cfg.n_layers,
             "batch": batch, "prompt_len": prompt_len}
    with torch.inference_mode():
        logits, caches, rolling = prefill(params, cfg, prompts,
                                          cache_len=cache_len, **front)
        tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode_step(params, cfg, tok, caches, prompt_len + P,
                        rolling=rolling)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("decode_first", prof, wall, dict(extra, steps=1))
        del caches
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, caches, rolling = prefill(params, cfg, prompts,
                                              cache_len=cache_len, **front)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("prefill", prof, wall, extra)
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            greedy_decode(params, cfg, logits, caches, prompt_len + P,
                          steps + 1, rolling=rolling)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("decode", prof, wall, dict(extra, steps=steps))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=LM_ARCH)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--ssm-bf16", action="store_true")
    ap.add_argument("sizes", nargs="*", type=int,
                    help="batch, prompt_len, steps")
    args = ap.parse_args()
    main(args.arch, args.dtype, args.ssm_bf16, *args.sizes[:3])
