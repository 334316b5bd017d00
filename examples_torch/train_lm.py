"""End-to-end training on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps.

Uses the port's training substrate end to end — config system, AdamW,
deterministic data pipeline, async checkpointing and the fault-tolerant
loop — on one device: the card unless ``--device cpu`` is given (the
reference's sharding rules over a mesh are not ported; one device trains
in f32, as the reference does on one). ``--n-layers`` cuts the depth for a
quick run (default 12, the model's).

Run:  python examples_torch/train_lm.py [--steps 200] [--device cpu]
(A 3-step smoke variant runs in seconds on the card: --steps 3.)
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--n-layers", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch
    from repro_torch.device import resolve_device
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import leaves
    from repro_torch.train import (AdamConfig, Checkpointer, DataConfig,
                                   FaultTolerantLoop, LoopConfig, TokenStream,
                                   TrainConfig, init_train_state,
                                   make_train_step)

    dev = resolve_device(args.device)
    # ~100M params: granite-style dense decoder
    cfg = ModelConfig(
        name="lm-100m", family="dense", n_layers=args.n_layers, d_model=768,
        n_heads=12, n_kv=4, head_dim=64, d_ff=2048, vocab=32000,
        tie_embeddings=True, dtype=torch.float32, scan_group=4)
    tcfg = TrainConfig(adam=AdamConfig(lr=6e-4, warmup_steps=20,
                                       total_steps=args.steps))
    params, opt = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), tcfg)
    n = sum(t.numel() for t in leaves(params))
    print(f"model: {n/1e6:.1f}M params | {args.steps} steps of "
          f"{args.batch}×{args.seq} tokens on {dev}")

    step_fn = make_train_step(cfg, tcfg)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq=args.seq,
                                    batch=args.batch, seed=7))
    ck = Checkpointer(args.ckpt, keep=2, async_save=True)
    loop = FaultTolerantLoop(
        train_step=step_fn, params=params, opt_state=opt, stream=stream,
        ckpt=ck, loop_cfg=LoopConfig(
            total_steps=args.steps,
            checkpoint_every=max(args.steps // 4, 1),
            log_every=max(args.steps // 20, 1)))
    result = loop.run()
    losses = [m["loss"] for m in result["log"]]
    for m in result["log"]:
        print(f"  step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"{m['wall']*1e3:7.0f} ms")
    if len(losses) >= 2:
        print(f"loss: {losses[0]:.3f} → {losses[-1]:.3f} "
              f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")


if __name__ == "__main__":
    main()
