"""Serving entry point: batched prefill + greedy decode loop (the port's
counterpart of ``python -m repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --reduced --batch 4 --prompt-len 32 --new-tokens 32 --device cpu

``--arch`` is any of ``repro_torch.configs.ARCH_NAMES``: zamba2-1.2b,
falcon-mamba-7b, granite-8b, gemma-7b, gemma3-27b, qwen1.5-32b.

Runs in float32 on one device, as the reference does on one device
(``repro/launch/serve.py:34-35``), with weights and prompts drawn from
``--seed``. The device is the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config
    from ..device import resolve_device, synchronize
    from ..models import init_params
    from ..serve.serve_step import greedy_decode, prefill

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch, reduced=args.reduced),
                              dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen)

    B, S0, N = args.batch, args.prompt_len, args.new_tokens
    prompts = torch.randint(0, cfg.vocab, (B, S0), generator=gen,
                            device=dev)
    synchronize(dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, caches, rolling = prefill(params, cfg, prompts,
                                          cache_len=S0 + N)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0
        print(f"prefill: {B}×{S0} tokens in {t_prefill*1e3:.0f} ms "
              f"({B*S0/t_prefill:.0f} tok/s) on {dev}")

        t0 = time.perf_counter()
        tokens = greedy_decode(params, cfg, logits, caches, S0, N,
                               rolling=rolling)
        synchronize(dev)
        t_decode = time.perf_counter() - t0
    steps = max(N - 1, 1)
    print(f"decode: {B * (N - 1)} tokens in {t_decode*1e3:.0f} ms "
          f"({B * (N - 1) / max(t_decode, 1e-9):.0f} tok/s, "
          f"{t_decode / steps * 1e3:.1f} ms/step) on {dev}")
    sample = tokens[0, :16]
    print("sample tokens:", [int(t) for t in sample])


if __name__ == "__main__":
    main()
