"""Mixture-of-Experts layer (the port's counterpart of
``repro.models.moe``): Mixtral's experts, top-k routing into per-expert
capacity buffers, the experts' FFN as one batched product.

The routing decides which token goes where, so it follows the reference
step for step (``repro/models/moe.py:47-121``):

* tokens in groups of ``g = min(group_size, N)``, halved until it divides
  N, each expert ``cap = max(ceil(top_k·g/E·capacity_factor), top_k)``
  slots a group;
* the router product in x's dtype, then f32 for the softmax (in bf16 the
  logits are bf16-rounded first, as the reference's);
* the top-k experts with the lower index first among equal probabilities,
  as ``jax.lax.top_k`` orders them. ``torch.topk`` promises no order among
  ties, so the port takes the first k of a stable descending sort;
* each (token, k) takes the next free slot of its expert in the group's
  flattened (token, k) order; those past ``cap`` are dropped (the
  reference's scatter with ``mode="drop"``).

On the card every index operation is deterministic: gathers
(``index_select``) and one ``scatter_`` whose indices are all distinct
(each dropped pick writes a dump row of its own, sliced off), never
``index_add_``, which sums with atomics. The experts' products are
``torch.bmm`` over (E, G·cap, d), as the reference leaves its einsums to
XLA outside any Pallas kernel. Training differentiates this layer with
PyTorch's autograd through the same operations (the combine weights and the
router's softmax carry the gradient, the aux loss joins ``lm_loss``), on
the CPU and on the card alike. The gradients of the two gathers are
``index_add_``, which sums with atomics on the card; with top-k routing
each row of x and of the experts' output gets at most k nonzero terms, the
others ±0 of masked or dropped slots, so the sum is the same in any order
and a train step is bitwise the same twice (``chip_smoke.py`` phase 17
checks it at full width).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import normal

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             *, dtype=torch.float32) -> Params:
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    E = n_experts
    return {"router": normal(gen, (d_model, E), s_in, dtype),
            "wi": normal(gen, (E, d_model, d_ff), s_in, dtype),
            "wg": normal(gen, (E, d_model, d_ff), s_in, dtype),
            "wo": normal(gen, (E, d_ff, d_model), s_out, dtype)}


class MoEStats(NamedTuple):
    tokens_per_expert: torch.Tensor    # (E,) f32: picks before capacity
    aux_loss: torch.Tensor             # () f32: Switch load-balancing loss
    dropped_fraction: torch.Tensor     # () f32


class Routing(NamedTuple):
    """Where each token goes: the (G, g, top_k) picks of the G groups of g
    tokens, each expert ``cap`` slots a group."""
    probs: torch.Tensor        # (G, g, E) f32 router softmax
    gate_vals: torch.Tensor    # (G, g, k) f32, renormalised over the k
    gate_idx: torch.Tensor     # (G, g, k) int64 experts, best first
    pos: torch.Tensor          # (G, g, k) int64 slot in the expert's buffer
    keep: torch.Tensor         # (G, g, k) bool: pos < cap
    cap: int


def route(p: Params, x, *, top_k: int = 2, capacity_factor: float = 1.25,
          group_size: int = 1024) -> Routing:
    """The reference's routing of x (B, S, d) (``repro/models/moe.py:
    60-77``): groups, router softmax, top-k, slots."""
    B, S, d = x.shape
    E = p["router"].shape[1]
    N = B * S
    g = min(group_size, N)
    while N % g:
        g //= 2
    G = N // g
    cap = max(int(math.ceil(top_k * g / E * capacity_factor)), top_k)

    logits = (x.reshape(G, g, d) @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                    # (G, g, E)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], order[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # slot of each (token, k): its rank among the group's picks of that
    # expert in (token, k) order
    flat = (gate_idx.reshape(G, g * top_k, 1)
            == torch.arange(E, device=x.device)).to(torch.int64)
    pos = ((torch.cumsum(flat, 1) * flat).sum(-1) - 1).reshape(G, g, top_k)
    return Routing(probs, gate_vals, gate_idx, pos, pos < cap, cap)


def moe(p: Params, x, *, top_k: int = 2, capacity_factor: float = 1.25,
        group_size: int = 1024) -> Tuple[torch.Tensor, MoEStats]:
    """x (B, S, d) → (B, S, d), top-k routing with capacity buffers and
    SwiGLU experts."""
    B, S, d = x.shape
    E = p["router"].shape[1]
    r = route(p, x, top_k=top_k, capacity_factor=capacity_factor,
              group_size=group_size)
    G, g, _ = r.gate_idx.shape
    N, gk, cap = B * S, g * top_k, r.cap
    dev = x.device
    e_f, pos, keep = (t.reshape(G, gk) for t in (r.gate_idx, r.pos, r.keep))

    # dispatch: src[grp, e·cap + s] = the token in slot s of expert e
    dest = torch.where(keep, e_f * cap + pos,
                       E * cap + torch.arange(gk, device=dev))
    tok = (torch.arange(G, device=dev)[:, None] * g
           + torch.arange(gk, device=dev) // top_k)            # (G, g·k)
    src = torch.full((G, E * cap + gk), -1, dtype=torch.int64, device=dev)
    src.scatter_(1, dest, tok)
    src = src[:, :E * cap].reshape(G, E, cap).transpose(0, 1).reshape(-1)
    rows = x.reshape(N, d).index_select(0, src.clamp(min=0))
    e_in = rows.masked_fill((src < 0)[:, None], 0).reshape(E, G * cap, d)

    h = F.silu(torch.bmm(e_in, p["wg"].to(x.dtype))) \
        * torch.bmm(e_in, p["wi"].to(x.dtype))
    out = torch.bmm(h, p["wo"].to(x.dtype))                    # (E, G·cap, d)

    # combine: each (token, k) reads its slot's row, weighted by its gate
    grp = torch.arange(G, device=dev)[:, None]
    row = torch.where(keep, e_f * (G * cap) + grp * cap + pos, 0)
    back = out.reshape(E * G * cap, d).index_select(0, row.reshape(-1))
    w = keep.to(x.dtype) * r.gate_vals.reshape(G, gk).to(x.dtype)
    y = (back * w.reshape(-1, 1)).reshape(N, top_k, d).sum(1)

    # stats: the measured load and the Switch aux loss
    experts = torch.arange(E, device=dev)
    me = r.probs.mean((0, 1))                                # (E,)
    ce = (r.gate_idx[..., 0, None] == experts).to(torch.float32).mean((0, 1))
    aux = E * torch.sum(me * ce)
    counts = (r.gate_idx[..., None] == experts).sum((0, 1, 2)).to(
        torch.float32)
    # the reference's keep.mean() multiplies by the f32 reciprocal of the
    # count (XLA's rewrite of the division): the same rounding here
    dropped = 1.0 - keep.sum().to(torch.float32) * (1.0 / keep.numel())
    return y.reshape(B, S, d), MoEStats(counts, aux, dropped)
