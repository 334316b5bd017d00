"""The training step (the counterpart of ``repro.train.train_step``).

``train_step(params, opt_state, batch)`` takes the loss and every
parameter's gradient by PyTorch's autograd through ``lm_loss`` (whose
train-mode forward runs the reference's two remat levels as checkpoint
regions, and on the card every attention call through the flash kernels,
forward and backward), then one AdamW step in place. The reference jits
this function over a mesh; the port runs it eagerly on one device, so
``rules`` (sharding) must be None — the sharding modules are out of scope
(README). ``compression`` is accepted and not applied, exactly as the
reference's ``make_train_step`` ignores it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.convert import leaves, tree_map
from ..models.model import init_params, lm_loss
from .optimizer import AdamConfig, AdamState, adam_init, adam_step


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adam: AdamConfig = AdamConfig()
    aux_weight: float = 0.01
    compression: Optional[str] = None        # None | "int8" | "topk"


def _no_rules(rules) -> None:
    if rules is not None:
        raise ValueError("sharding rules are out of scope for the port "
                         "(README): it trains on one device")


def _on(x, dev):
    """A batch entry (numpy or tensor) as a tensor on ``dev``."""
    if x is None:
        return None
    t = torch.from_numpy(np.asarray(x)) if not isinstance(
        x, torch.Tensor) else x
    return t.to(dev)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    rules=None) -> Callable:
    """Returns train_step(params, opt_state, batch) → (params, opt,
    metrics); ``batch`` holds ``tokens`` and ``targets`` (B, S) and, for an
    enc-dec or VLM model, ``enc_inputs`` or ``patch_embeds``, numpy or
    tensors. The parameters and moments are updated in place; ``metrics``
    holds the loss, the summed expert counts, the gradient norm and the
    rate, as 0-d (counts: 1-d) tensors on the parameters' device."""
    _no_rules(rules)

    def train_step(params, opt_state: AdamState, batch):
        ps = list(leaves(params))
        dev = ps[0].device
        for p in ps:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, counts = lm_loss(
                params, cfg, _on(batch["tokens"], dev),
                _on(batch["targets"], dev), aux_weight=tcfg.aux_weight,
                enc_inputs=_on(batch.get("enc_inputs"), dev),
                patch_embeds=_on(batch.get("patch_embeds"), dev))
            flat = torch.autograd.grad(loss, ps, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(ps, flat)])
        grads = tree_map(lambda _: next(it), params)
        del flat
        params, opt_state, om = adam_step(tcfg.adam, params, grads,
                                          opt_state)
        metrics = {"loss": loss.detach(), "expert_counts": counts.detach(),
                   **om}
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     tcfg: TrainConfig, rules=None):
    """(params, opt_state): ``init_params`` drawn from ``gen`` on its
    device (the reference takes a PRNG key), every leaf requiring grad,
    and zero f32 moments."""
    _no_rules(rules)
    params = init_params(cfg, gen)
    for p in leaves(params):
        p.requires_grad_(True)
    return params, adam_init(params)
