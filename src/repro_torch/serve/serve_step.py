"""Serving: prefill and decode steps (the port's counterpart of
``repro.serve.serve_step``).

The caches are per-layer lists (the reference's decode layout). A decode
step writes each KV cache in place at ``pos`` and returns the caches; the
SSM states are replaced. Rolling (sliding-window) caches are not ported yet
(ROADMAP queue 1 item 13).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.layers import KVCache
from ..models.model import forward, plan_segments


def _pad_kv(kv: KVCache, target_len: int) -> KVCache:
    """Grow a prefill-built KV cache to ``target_len`` slots (zeros after
    the prompt's keys)."""
    B, S0, K, hd = kv.k.shape
    if target_len < S0:
        raise ValueError(f"cache_len {target_len} < prompt length {S0}")
    k = kv.k.new_zeros((B, target_len, K, hd))
    v = kv.v.new_zeros((B, target_len, K, hd))
    k[:, :S0] = kv.k
    v[:, :S0] = kv.v
    return KVCache(k, v, kv.pos)


def pad_caches(cfg: ModelConfig, caches: list, cache_len: int,
               rolling: Dict[str, bool]) -> list:
    """Grow prefill caches to decode capacity, kind-aware."""
    if any(rolling.values()):
        raise NotImplementedError("rolling KV caches are not ported yet: "
                                  "ROADMAP queue 1 item 13")
    out = []
    for si, (pattern, _) in enumerate(plan_segments(cfg)):
        pos_out = []
        for pi, kind in enumerate(pattern):
            layers = caches[si][pi]
            if kind == "mamba2s":
                layers = [(_pad_kv(kv, cache_len), ssm) for kv, ssm in layers]
            pos_out.append(list(layers))     # mamba states pass through
        out.append(pos_out)
    return out


def prefill(params, cfg: ModelConfig, tokens, *, cache_len: int):
    """Run the prompt, return (last-token logits, decode-ready caches,
    rolling map)."""
    rolling: Dict[str, bool] = {}     # no kind of this slice rolls
    res = forward(params, cfg, tokens, mode="prefill", rolling=rolling)
    caches = pad_caches(cfg, res.caches, cache_len, rolling)
    return res.logits[:, -1], caches, rolling


def decode_step(params, cfg: ModelConfig, token, caches, pos: int, *,
                rolling: Dict[str, bool]):
    """One decode step. token (B, 1) int64; pos (tokens so far).

    Returns (logits (B, vocab), new caches).
    """
    positions = pos + torch.arange(token.shape[1], device=token.device)
    res = forward(params, cfg, token, mode="decode", caches=caches,
                  rolling=rolling, positions=positions)
    return res.logits[:, -1], res.caches


def greedy_decode(params, cfg: ModelConfig, logits, caches, pos: int,
                  n_new: int, *, rolling: Dict[str, bool],
                  on_step: Optional[Callable[[torch.Tensor], None]] = None):
    """The greedy decode loop after ``prefill``: the argmax of the prompt's
    last ``logits`` is the first new token, then ``n_new - 1`` decode steps
    from position ``pos``. ``on_step(logits)``, if given, is called after
    each step with that step's logits. Returns the ``n_new`` tokens
    (B, n_new)."""
    tok = torch.argmax(logits, -1)[:, None]
    outs = [tok]
    for i in range(n_new - 1):
        logits, caches = decode_step(params, cfg, tok, caches, pos + i,
                                     rolling=rolling)
        tok = torch.argmax(logits, -1)[:, None]
        outs.append(tok)
        if on_step is not None:
            on_step(logits)
    return torch.cat(outs, dim=1)


def greedy_generate(params, cfg: ModelConfig, prompt, n_new: int, *,
                    cache_len: Optional[int] = None):
    """Greedy generation: prefill, then ``n_new - 1`` decode steps.
    Returns the ``n_new`` tokens (B, n_new)."""
    B, S0 = prompt.shape
    cache_len = cache_len or (S0 + n_new)
    logits, caches, rolling = prefill(params, cfg, prompt,
                                      cache_len=cache_len)
    return greedy_decode(params, cfg, logits, caches, S0, n_new,
                         rolling=rolling)
