"""Carry parameters and caches between the reference and the port.

The reference's parameters are a pytree of arrays whose ``segments`` leaves
carry a leading repeat dimension (from ``vmap`` init); the port keeps one
dict per layer. ``params_from_numpy`` takes the reference's tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and unstacks it;
``params_to_numpy`` stacks the port's parameters back into the same tree.
``to_numpy`` turns any nest of lists, tuples, dicts and named tuples of
tensors (the port's caches, say) into the same nest of numpy arrays;
``tree_map`` and ``leaves`` walk such a nest.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a, device):
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


def params_from_numpy(tree: dict, *, device="cpu") -> dict:
    """The reference's parameter tree (numpy leaves, stacked segments) →
    the port's parameters on ``device`` (one dict per layer)."""
    out = {k: tree_map(lambda a: _tensor(a, device), v)
           for k, v in tree.items() if k != "segments"}
    segs = []
    for seg in tree["segments"]:
        pos = []
        for stacked in seg:
            repeats = len(next(iter(leaves(stacked))))
            pos.append([tree_map(lambda a, r=r: _tensor(a[r], device), stacked)
                        for r in range(repeats)])
        segs.append(pos)
    out["segments"] = segs
    return out


def params_to_numpy(params: dict) -> dict:
    """The port's parameters → the reference's tree layout, numpy leaves
    (segments stacked along a leading repeat dimension)."""
    out = {k: to_numpy(v) for k, v in params.items() if k != "segments"}
    segs = []
    for seg in params["segments"]:
        pos = []
        for layers in seg:
            per = [to_numpy(p) for p in layers]
            pos.append(_stack(per))
        segs.append(pos)
    out["segments"] = segs
    return out


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
    """A nest of tensors (and ints) → the same nest of numpy arrays."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return np.asarray(a)
    return tree_map(leaf, t)
