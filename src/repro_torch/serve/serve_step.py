"""Serving: prefill and decode steps (the port's counterpart of
``repro.serve.serve_step``).

The caches are per-layer lists (the reference's decode layout). A decode
step writes each KV cache in place at ``pos`` (at ``pos % window`` for a
rolling, window-sized cache) and returns the caches; the SSM states are
replaced; an enc-dec decoder's cross caches, built at prefill from the
encoder's output, are read only. A VLM's patch embeddings take the first
positions: its decode starts at the prompt's length plus the patches.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.layers import KVCache
from ..models.model import (ATTN_KINDS, attn_spec, forward, plan_segments,
                            rolling_map)


def _pad_kv(kv: KVCache, target_len: int, rolling: bool = False) -> KVCache:
    """Grow a prefill-built KV cache to ``target_len`` slots (zeros after
    the prompt's keys); a rolling cache keeps the last ``target_len`` keys
    in wrap-aligned slots."""
    B, S0, K, hd = kv.k.shape
    if rolling:
        W = target_len
        # slot s ← key position p: the largest p < S0 with p ≡ s (mod W)
        s = torch.arange(W, device=kv.k.device)
        p = s + torch.div(S0 - 1 - s, W, rounding_mode="floor") * W
        valid = ((p >= 0) & (p < S0))[None, :, None, None]
        idx = p.clamp(0, S0 - 1)
        return KVCache(torch.where(valid, kv.k[:, idx], 0.0),
                       torch.where(valid, kv.v[:, idx], 0.0), kv.pos)
    if target_len < S0:
        raise ValueError(f"cache_len {target_len} < prompt length {S0}")
    k = kv.k.new_zeros((B, target_len, K, hd))
    v = kv.v.new_zeros((B, target_len, K, hd))
    k[:, :S0] = kv.k
    v[:, :S0] = kv.v
    return KVCache(k, v, kv.pos)


def pad_caches(cfg: ModelConfig, caches: list, cache_len: int,
               rolling: Dict[str, bool]) -> list:
    """Grow prefill caches to decode capacity, kind-aware: a rolling
    attention cache to its window, any other self-attention KV cache to
    ``cache_len``; a cross cache stays as the encoder filled it."""
    out = []
    for si, (pattern, _) in enumerate(plan_segments(cfg)):
        pos_out = []
        for pi, kind in enumerate(pattern):
            layers = caches[si][pi]
            if kind in ATTN_KINDS:
                roll = rolling.get(kind, False)
                tgt = attn_spec(cfg, kind).window if roll else cache_len
                layers = [_pad_kv(kv, tgt, roll) for kv in layers]
            elif kind == "dec":
                layers = [(_pad_kv(kv, cache_len), cross)
                          for kv, cross in layers]
            elif kind == "mamba2s":
                layers = [(_pad_kv(kv, cache_len), ssm) for kv, ssm in layers]
            pos_out.append(list(layers))     # mamba states pass through
        out.append(pos_out)
    return out


def prefill(params, cfg: ModelConfig, tokens, *, cache_len: int,
            enc_inputs=None, patch_embeds=None):
    """Run the prompt (after the patches ``patch_embeds``, if given; with
    the encoder over ``enc_inputs`` for an enc-dec model), return
    (last-token logits, decode-ready caches, rolling map). ``cache_len``
    counts the patches."""
    # the map make_caches returns, without allocating the caches
    rolling = rolling_map(cfg, cache_len)
    res = forward(params, cfg, tokens, mode="prefill", rolling=rolling,
                  enc_inputs=enc_inputs, patch_embeds=patch_embeds)
    # a copy of the last position's logits, so the (B, S, vocab) logits
    # are freed before the caches are padded
    logits, caches = res.logits[:, -1].clone(), res.caches
    del res
    return logits, pad_caches(cfg, caches, cache_len, rolling), rolling


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
                    cache_len: Optional[int] = None, enc_inputs=None,
                    patch_embeds=None):
    """Greedy generation: prefill, then ``n_new - 1`` decode steps from
    the prompt's length plus the patches. Returns the ``n_new`` tokens
    (B, n_new). The default ``cache_len`` holds the patches, the prompt
    and the new tokens, as ``repro.launch.serve`` sizes it (the
    reference's ``greedy_generate`` leaves the patches out of its
    default)."""
    B, S0 = prompt.shape
    extra = patch_embeds.shape[1] if patch_embeds is not None else 0
    cache_len = cache_len or (S0 + extra + n_new)
    logits, caches, rolling = prefill(params, cfg, prompt,
                                      cache_len=cache_len,
                                      enc_inputs=enc_inputs,
                                      patch_embeds=patch_embeds)
    return greedy_decode(params, cfg, logits, caches, S0 + extra, n_new,
                         rolling=rolling)
