"""Gradient compression with error feedback (the counterpart of
``repro.distributed.compression``), on one device.

Two schemes with **error feedback** (residual carried to the next step so
compression error doesn't bias the optimizer — Karimireddy et al. 2019):

* int8 quantisation — per-tensor symmetric scale; 4× traffic reduction.
* top-k sparsification — keep the k largest-|g| entries; (1-k/n)× reduction.

``compress_grads``/``decompress_grads`` wrap a gradient tree (nested dicts,
lists and tuples of tensors). Numerical contract (tested): with error
feedback the *running sum* of decompressed gradients tracks the running sum
of true gradients. As in the reference, ``TrainConfig.compression`` is
accepted and the train step does not apply it; the data-parallel
all-reduce it would wrap is out of scope with the sharding modules
(README).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.convert import leaves, tree_map

F32 = torch.float32


class CompressState(NamedTuple):
    residual: Any           # tree like grads (f32)


def init_compress_state(grads) -> CompressState:
    return CompressState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads))


def _quantize_int8(x):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q, scale):
    return q.to(F32) * scale


def _topk_mask(x, frac: float):
    n = x.numel()
    k = max(int(n * frac), 1)
    flat = torch.abs(x).reshape(-1)
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(F32)


class _Payload(tuple):
    """One leaf's payload, (q, scale) or (kept, 0): a tuple that the tree
    walk treats as a leaf."""


def compress_grads(grads, state: CompressState, *, scheme: str = "int8",
                   topk_frac: float = 0.1):
    """Returns (compressed payload tree, new residual state).

    The payload is what would cross the network; ``decompress_grads``
    reconstructs the dense gradient.
    """
    def one(g, r):
        x = g.to(F32) + r
        if scheme == "int8":
            q, scale = _quantize_int8(x)
            approx = _dequantize_int8(q, scale)
            return _Payload((q, scale)), x - approx
        if scheme == "topk":
            mask = _topk_mask(x, topk_frac)
            kept = x * mask
            return (_Payload((kept, torch.zeros((), dtype=F32,
                                                device=x.device))),
                    x - kept)
        raise ValueError(scheme)

    done = [one(g, r) for g, r in zip(leaves(grads), leaves(state.residual))]
    payloads = iter([p for p, _ in done])
    residuals = iter([r for _, r in done])
    return (tree_map(lambda _: next(payloads), grads),
            CompressState(tree_map(lambda _: next(residuals), grads)))


def _walk(fn, tree):
    """Map ``fn`` over the payloads (``_Payload`` leaves) of a tree."""
    if isinstance(tree, _Payload):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _walk(fn, v) for k, v in tree.items()}
    return type(tree)(_walk(fn, v) for v in tree)


def decompress_grads(payload, *, scheme: str = "int8"):
    def one(p):
        if scheme == "int8":
            q, scale = p
            return _dequantize_int8(q, scale)
        kept, _ = p
        return kept

    return _walk(one, payload)


def compressed_bytes(payload, *, scheme: str = "int8") -> int:
    total = 0
    found = []
    _walk(found.append, payload)
    for p in found:
        for leaf in p:
            if scheme == "int8" and leaf.dtype == torch.int8:
                total += leaf.numel()
            elif scheme == "topk":
                total += int(leaf.numel() * 4)   # value+index stream estimate
            else:
                total += leaf.numel() * leaf.element_size()
    return total
