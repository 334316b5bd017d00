"""Training launcher (the port's counterpart of ``python -m
repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --reduced --steps 100 --batch 8 --seq 256 --device cpu

Runs the fault-tolerant loop (checkpoint/restart, NaN guard, straggler
accounting) on one device: the card unless ``--device cpu`` is given. The
flags and defaults are the reference's (``repro/launch/train.py``):
granite-8b, batch 8, sequence 256, 100 steps, AdamW at 3e-4 with a warmup
of 10 steps; ``--d-model`` and ``--n-layers`` override the width and the
depth. On one device the reference trains in float32, and so does the
port. ``--mesh production`` (the reference's multi-chip mesh) raises: the
mesh and sharding modules are out of scope (README). ``--compression`` is
accepted and not applied, as in the reference's train step.

granite-8b at full width needs 16 bytes a parameter in f32 with AdamW (the
weight, its gradient and two moments): all 36 layers (8.05 B parameters,
~129 GB) do not fit one 80 GB card; ``--n-layers 16`` does. Its checkpoints
hold the weights and both moments (12 bytes a parameter): point ``--ckpt``
at a disk with room for two of them. An enc-dec model (seamless-m4t-large-v2)
gets encoder frames as long as the sequence and a VLM (internvl2-2b) its
patch embeddings, both standard normal × 0.1 drawn from the step, so the
stream stays replayable. Weights and data are drawn from seed 0, as the
reference's launcher draws them. The Mamba kinds train on the card
through the scans' f32 kernels and their backward kernels:
``--arch zamba2-1.2b`` uncut (~20 GB of f32 train state), ``--arch
falcon-mamba-7b --n-layers 32`` (every published width; all 64 layers,
~116 GB, do not fit one 80 GB card). Only the MoE models do not train on
the card yet (ROADMAP queue 1, item 13f): they raise there and train on the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np


class FrontendStream:
    """A token stream whose batches also carry the stub frontends' inputs
    of an enc-dec or VLM model, drawn from the step."""

    def __init__(self, stream, cfg):
        self.stream, self.cfg = stream, cfg

    def batch(self, step: int):
        out = dict(self.stream.batch(step))
        cfg = self.cfg
        B, S = out["tokens"].shape
        rng = np.random.default_rng(step ^ (1 << 31))
        if cfg.is_encdec:
            out["enc_inputs"] = (rng.standard_normal((B, S, cfg.d_model))
                                 * 0.1).astype(np.float32)
        if cfg.vlm_patches:
            out["patch_embeds"] = (rng.standard_normal(
                (B, cfg.vlm_patches, cfg.d_model)) * 0.1).astype(np.float32)
        return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test scale config")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (custom scale runs)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--mesh", default="host", choices=["host", "production"])
    ap.add_argument("--compression", default=None,
                    choices=[None, "int8", "topk"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh == "production":
        raise ValueError("--mesh production: the multi-chip mesh and the "
                         "sharding modules are out of scope for the port "
                         "(README); it trains on one device")

    import torch

    from ..configs import get_config
    from ..device import resolve_device
    from ..models.convert import leaves
    from ..train import (AdamConfig, Checkpointer, DataConfig,
                         FaultTolerantLoop, LoopConfig, TokenStream,
                         TrainConfig, init_train_state, make_train_step)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.n_layers:
        overrides["n_layers"] = args.n_layers
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)   # one device

    tcfg = TrainConfig(adam=AdamConfig(lr=args.lr, warmup_steps=10,
                                       total_steps=args.steps),
                       compression=args.compression)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt = init_train_state(cfg, gen, tcfg)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={dev}")

    step_fn = make_train_step(cfg, tcfg)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq=args.seq,
                                    batch=args.batch))
    if cfg.is_encdec or cfg.vlm_patches:
        stream = FrontendStream(stream, cfg)
    ck = Checkpointer(args.ckpt, keep=3, async_save=True)
    loop = FaultTolerantLoop(
        train_step=step_fn, params=params, opt_state=opt, stream=stream,
        ckpt=ck, loop_cfg=LoopConfig(total_steps=args.steps,
                                     checkpoint_every=args.checkpoint_every,
                                     log_every=max(args.steps // 50, 1)))
    result = loop.run()
    for m in result["log"]:
        print(f"step {m['step']:6d}  loss {m['loss']:.4f}  "
              f"wall {m['wall'] * 1e3:.0f} ms")
    print(f"done: steps={result['final_step']} restores={result['restores']}"
          f" stragglers={result['stragglers']}")


if __name__ == "__main__":
    main()
