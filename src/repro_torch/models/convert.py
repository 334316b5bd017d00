"""Carry parameters and caches between the reference and the port.

The reference's parameters are a pytree of arrays whose ``segments`` and
``encoder`` leaves carry a leading layer dimension (from ``vmap`` init); the
port keeps one dict per layer. ``params_from_numpy`` takes the reference's
tree as numpy arrays (``jax.tree.map(np.asarray, params)``) and unstacks it;
``params_to_numpy`` stacks the port's parameters back into the same tree
(dense trees too: ``q_norm``/``k_norm``, the QKV biases, an untied
``head``, gemma3's period and remainder segments; enc-dec trees: the
encoder, ``enc_ln_f``, the ``dec`` blocks' ``ln_x`` and ``xattn``; MoE
trees: each ``moe`` block's ``router`` (d, E) and experts ``wi``/``wg``
(E, d, ff), ``wo`` (E, ff, d)).
``to_numpy`` turns any nest of lists, tuples, dicts and named tuples of
tensors (the port's caches, say) into the same nest of numpy arrays;
``caches_from_numpy`` takes the reference's per-layer decode caches
(``make_caches(..., stacked=False)`` or a decode step's, full or rolling;
a ``dec`` layer's the pair (self, cross); a ``moe`` layer's one KV cache,
as an ``attn`` layer's) as numpy leaves into the port's;
``tree_map`` and ``leaves`` walk such a nest. Nothing here imports JAX,
nor ``ml_dtypes``.

bf16 leaves cross bit for bit both ways. In: a numpy array whose dtype is
named ``bfloat16`` (the reference's default dtype, an ``ml_dtypes`` type)
is read as its uint16 bit patterns and viewed as ``torch.bfloat16``. Out:
a ``torch.bfloat16`` tensor comes back as a **numpy uint16 array of its
bit patterns** (numpy has no bf16 of its own): compare it exactly with
``ref.view(np.uint16)``, or view it as ``ml_dtypes.bfloat16`` on the
caller's side to get the reference's array back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .layers import KVCache
from .mamba import Mamba1State, Mamba2State
from .model import ATTN_KINDS, plan_segments


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # bit patterns, no ml_dtypes
        bits = np.array(a.view(np.uint16), copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_map(fn, t):
    """Map ``fn`` over the leaves of a nest of dicts, lists, tuples and
    named tuples (a parameter tree, the caches)."""
    if isinstance(t, dict):
        return {k: tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, v) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, v) for v in t)
    return fn(t)


_STACKED = ("segments", "encoder")


def _unstack(stacked, device) -> list:
    """A tree of arrays with a leading layer dimension → per-layer trees."""
    n = len(next(iter(leaves(stacked))))
    return [tree_map(lambda a, r=r: _tensor(a[r], device), stacked)
            for r in range(n)]


def params_from_numpy(tree: dict, *, device="cpu") -> dict:
    """The reference's parameter tree (numpy leaves, stacked segments and
    encoder) → the port's parameters on ``device`` (one dict per layer)."""
    out = {k: tree_map(lambda a: _tensor(a, device), v)
           for k, v in tree.items() if k not in _STACKED}
    out["segments"] = [[_unstack(stacked, device) for stacked in seg]
                       for seg in tree["segments"]]
    if "encoder" in tree:
        out["encoder"] = _unstack(tree["encoder"], device)
    return out


def params_to_numpy(params: dict) -> dict:
    """The port's parameters → the reference's tree layout, numpy leaves
    (segments and encoder stacked along a leading layer dimension)."""
    out = {k: to_numpy(v) for k, v in params.items() if k not in _STACKED}
    out["segments"] = [[_stack([to_numpy(p) for p in layers])
                        for layers in seg] for seg in params["segments"]]
    if "encoder" in params:
        out["encoder"] = _stack([to_numpy(p) for p in params["encoder"]])
    return out


def caches_from_numpy(cfg, tree: list, *, device="cpu") -> list:
    """The reference's per-layer decode caches of ``cfg`` (numpy leaves,
    ``caches[segment][position][repeat]``) → the port's on ``device``,
    with each KV cache's ``pos`` an int."""
    def kv(c):
        return KVCache(_tensor(c[0], device), _tensor(c[1], device),
                       int(c[2]))

    def block(kind, c):
        if kind in ATTN_KINDS:
            return kv(c)
        if kind == "dec":
            return (kv(c[0]), kv(c[1]))
        if kind == "mamba1":
            return Mamba1State(*(_tensor(a, device) for a in c))
        if kind == "mamba2":
            return Mamba2State(*(_tensor(a, device) for a in c))
        return (kv(c[0]), Mamba2State(*(_tensor(a, device) for a in c[1])))

    return [[[block(kind, c) for c in tree[si][pi]]
             for pi, kind in enumerate(pattern)]
            for si, (pattern, _) in enumerate(plan_segments(cfg))]


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def leaves(t):
    """The leaves of a nest of dicts, lists and tuples, in order."""
    if isinstance(t, dict):
        for v in t.values():
            yield from leaves(v)
    elif isinstance(t, (list, tuple)):
        for v in t:
            yield from leaves(v)
    else:
        yield t


def to_numpy(t: Any):
    """A nest of tensors (and ints) → the same nest of numpy arrays; a bf16
    tensor → its uint16 bit patterns (see the module's docstring)."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            if a.dtype == torch.bfloat16:
                return a.view(torch.int16).numpy().view(np.uint16)
            return a.numpy()
        return np.asarray(a)
    return tree_map(leaf, t)
