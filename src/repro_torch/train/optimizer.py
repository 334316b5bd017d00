"""AdamW over the port's parameter trees (the counterpart of
``repro.train.optimizer``).

The reference's arithmetic in its order: global-norm clipping, linear
warmup then cosine decay of the rate, f32 moments, bias correction, decoupled
weight decay. The moments are f32 whatever the parameters' dtype, and the
update is written back in the parameter's dtype. In PyTorch's idiom the
step updates the parameters and the moments **in place** (one copy of the
state on the card; at granite-8b's width a second copy would not fit) and
returns them with the new step count. The reference's ZeRO-1 sharding of
the moments is out of scope with the sharding modules (README).

Square roots are correctly rounded on both devices: PyTorch's CPU float32
``sqrt`` misrounds ~0.7 % of inputs, so on the CPU the root is taken in
float64 and rounded once (as ``repro_torch.sph.physics.sqrt_rn``); CUDA's
``sqrt`` already rounds correctly, as XLA's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..models.convert import leaves, tree_map

F32 = torch.float32


class AdamState(NamedTuple):
    step: torch.Tensor    # () int32, on the parameters' device
    mu: Any               # f32 tree like params
    nu: Any               # f32 tree like params


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _sqrt_rn(x):
    """Correctly rounded f32 square root on either device."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def adam_init(params) -> AdamState:
    """Zero f32 moments like ``params``, step 0 on the parameters' device."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                           device=p.device), params)
    dev = next(iter(leaves(params))).device
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                     tree_map(torch.clone, zeros))


def lr_schedule(cfg: AdamConfig, step):
    """Linear warmup → cosine decay to min_lr_frac·lr, f32 (``step`` an
    integer tensor or an int)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares."""
    total = sum(torch.sum(torch.square(x.to(F32))) for x in leaves(tree))
    return _sqrt_rn(total)


@torch.no_grad()
def adam_step(cfg: AdamConfig, params, grads, state: AdamState
              ) -> Tuple[Any, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and the moments updated in place; returns
    (params, the state with step + 1, {"grad_norm", "lr"})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    flat: List = list(zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)))
    for p, g, mu, nu in flat:
        g = g.to(F32) * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = (mu / bc1).div_(_sqrt_rn(nu / bc2).add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.to(F32))
        p.copy_((p.to(F32) - lr * delta).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamState(step, state.mu, state.nu), metrics
