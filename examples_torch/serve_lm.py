"""Serve a small model with batched requests on the PyTorch/CUDA port:
prefill + decode loop with a continuous-batching-style slot manager
(finished sequences are replaced by queued requests between decode steps).

**Legacy (LM-zoo era).** The repo's serving path is the simulation fleet
— ``python -m repro_torch.fleet --scenario sedov --requests 64`` — which
applies the same continuous-batching idea to whole simulation requests
(see ``examples_torch/fleet_serve.py``). This example stays as a model-zoo
exercise: granite-8b's reduced configuration in f32, random weights from a
seed, its attention through the port's flash kernel on the card.

Runs on the CUDA device unless ``--device cpu`` is given.

Run:  python examples_torch/serve_lm.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import dataclasses
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device, synchronize
    from repro_torch.models import init_params
    from repro_torch.serve.serve_step import decode_step, prefill

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_config("granite-8b", reduced=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    B, S0, MAXLEN = 4, 16, 64
    n_requests = 12
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, S0).astype(np.int64)
             for _ in range(n_requests)]

    with torch.no_grad():
        # fill the first batch
        active = [queue.pop(0) for _ in range(B)]
        prompts = torch.from_numpy(np.stack(active)).to(dev)
        logits, caches, rolling = prefill(params, cfg, prompts,
                                          cache_len=MAXLEN)
        tok = torch.argmax(logits, -1)[:, None]
        lengths = [S0] * B
        done = 0
        synchronize(dev)
        t0 = time.perf_counter()
        decoded = 0
        pos = S0
        # simple continuous batching: sequences "finish" at a random target
        targets = [int(rng.integers(S0 + 8, MAXLEN - 1)) for _ in range(B)]
        while done < n_requests and pos < MAXLEN - 1:
            logits, caches = decode_step(params, cfg, tok, caches, pos,
                                         rolling=rolling)
            tok = torch.argmax(logits, -1)[:, None]
            decoded += B
            pos += 1
            for b in range(B):
                lengths[b] += 1
                if lengths[b] >= targets[b]:
                    done += 1
                    if queue:
                        # slot reuse: in a full serving stack the slot would
                        # be re-prefilled; here we just restart its counter
                        queue.pop(0)
                        lengths[b] = S0
                        targets[b] = int(rng.integers(S0 + 8, MAXLEN - 1))
        synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"served {done}/{n_requests} requests, {decoded} tokens in "
          f"{dt*1e3:.0f} ms ({decoded/max(dt,1e-9):.0f} tok/s) on {dev}")


if __name__ == "__main__":
    main()
