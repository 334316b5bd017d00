"""Model primitives (the port's counterpart of ``repro.models.layers``).

Plain functions over parameter dicts of tensors, in the reference's layouts
(``(B, S, H, hd)`` at every public function), with the reference's names.
Attention has the reference's three modes:

* train / prefill — full sequence through the flash attention op (the Hopper
  kernel on the card, its plain version on the CPU), causal with the
  layer's sliding window, or without any mask for the encoder's
  bidirectional layers, with the layer's soft-cap; prefill also returns
  the KV cache. The reference's banded branch (``_banded_sdpa``, taken
  when S is a multiple ≥ 2 of the window) masks the same keys as the
  window does, so it runs through the same op;
* decode — q_len tokens against a full or a rolling (wrap-around,
  window-sized) cache, in plain PyTorch (``_sdpa`` with a slot mask), as
  the reference computes it outside any Pallas kernel.

Cross-attention (the enc-dec decoder's): at prefill, k and v come from the
encoder's output ``kv_x`` (S ≠ T), without RoPE, through the flash op with
no mask, and the cache it returns holds them; at decode, the queries attend
to that read-only cache with the plain ``_sdpa``, as the reference does.

Variants: GQA, QKV bias, ``qk_norm`` (RMSNorm of q and k per head, eps
1e-6, never plus-one), soft-capping, per-layer RoPE base and windows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.flash_attention import flash_attention_op

Params = Dict[str, Any]


# ---------------------------------------------------------------- norms
def rmsnorm(x, w, *, eps: float = 1e-6, plus_one: bool = False):
    dt = x.dtype
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wf = w.to(torch.float32)
    scale = (1.0 + wf) if plus_one else wf
    return (xf * inv * scale).to(dt)


def layernorm(x, w, b, *, eps: float = 1e-5):
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


# ----------------------------------------------------------------- rope
def rope_tables(positions, head_dim: int, base: float = 10000.0):
    """positions (…,) int → cos, sin of shape (…, head_dim/2), f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (torch.tensor(base, dtype=torch.float32,
                                device=positions.device) ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, S, H, hd); cos/sin (S, hd/2) or (B, S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    c, s = c.to(x.dtype), s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ------------------------------------------------------------ activations
def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             dtype=torch.float32) -> Params:
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {"wi": normal(gen, (d_model, d_ff), s_in, dtype),
            "wg": normal(gen, (d_model, d_ff), s_in, dtype),
            "wo": normal(gen, (d_ff, d_model), s_out, dtype)}


def mlp(p: Params, x, *, act: str = "silu"):
    """Gated MLP: act(x·wg) ⊙ (x·wi) · wo  (SwiGLU for silu, GeGLU for gelu)."""
    g = _act(act)(x @ p["wg"])
    h = g * (x @ p["wi"])
    return h @ p["wo"]


def normal(gen: torch.Generator, shape, scale: float, dtype):
    """Standard normal draws from ``gen`` (on its device) times ``scale``,
    cast to ``dtype`` — the reference's ``normal(key, shape) * s``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(dtype)       # in place: one f32 copy at a time


# -------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    softcap: Optional[float] = None
    rope_base: float = 10000.0
    window: Optional[int] = None          # sliding-window size (None = full)
    causal: bool = True


def init_attention(gen: torch.Generator, spec: AttnSpec, *,
                   dtype=torch.float32) -> Params:
    d, H, K, hd = spec.d_model, spec.n_heads, spec.n_kv, spec.head_dim
    s = 1.0 / math.sqrt(d)
    dev = gen.device
    p = {"wq": normal(gen, (d, H * hd), s, dtype),
         "wk": normal(gen, (d, K * hd), s, dtype),
         "wv": normal(gen, (d, K * hd), s, dtype),
         "wo": normal(gen, (H * hd, d), 1.0 / math.sqrt(H * hd), dtype)}
    if spec.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((K * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((K * hd,), dtype=dtype, device=dev)
    if spec.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


class KVCache(NamedTuple):
    """Dense KV cache. A rolling cache (``rolling=True`` in decode) is
    window-sized and its writes wrap."""
    k: torch.Tensor       # (B, S_cache, n_kv, hd)
    v: torch.Tensor       # (B, S_cache, n_kv, hd)
    pos: int              # tokens already absorbed


def make_cache(batch: int, length: int, spec: AttnSpec, *,
               dtype=torch.float32, device=None) -> KVCache:
    """Zero KV cache of ``length`` slots, on the card unless ``device``
    says otherwise."""
    device = resolve_device(device)
    shape = (batch, length, spec.n_kv, spec.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def _sdpa(q, k, v, mask, *, softcap=None):
    """q (B,S,H,hd), k/v (B,T,K,hd) with H = K·G. mask (B?,S,T) additive."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores + mask[:, None, None, :, :]
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    return out.reshape(B, S, H * hd)


def _train_mask(q_pos, k_pos, *, causal: bool, window: Optional[int],
                valid=None):
    """Additive mask (1, S, T) from query/key absolute positions; with
    ``valid`` (B, T) bool, (B, S, T) with the invalid keys masked too."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((dq.shape[0], dk.shape[1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window is not None:
        ok &= dk > dq - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    m = torch.where(ok, zero, zero - 1e30)
    if valid is not None:
        return m + torch.where(valid, zero, zero - 1e30)[:, None, :]
    return m[None]


def _decode(q, k, v, cache: KVCache, spec: AttnSpec, rolling: bool):
    """Write q_len tokens' k/v into ``cache`` at ``cache.pos`` (in place;
    at ``pos % T`` if ``rolling``) and attend to the slots that hold keys.
    Returns (out (B, S, H·hd), new cache)."""
    S = q.shape[1]
    T = cache.k.shape[1]
    dev = q.device
    start = cache.pos % T if rolling else cache.pos
    if start + S > T:
        what = ("a rolling write may not wrap inside one step" if rolling
                else "the KV cache is full")
        raise ValueError(f"{what}: {T} slots, pos {cache.pos} + {S}")
    cache.k[:, start:start + S] = k.to(cache.k.dtype)
    cache.v[:, start:start + S] = v.to(cache.v.dtype)
    # absolute key position held by each cache slot
    slot = torch.arange(T, device=dev)
    if rolling:
        cur = cache.pos + S - 1
        # the largest position ≡ slot (mod T) that is ≤ cur (floor division)
        kpos = slot + torch.div(cur - slot, T, rounding_mode="floor") * T
        kvalid = kpos >= 0
    else:
        kpos = slot
        kvalid = slot < cache.pos + S
    qpos = cache.pos + torch.arange(S, device=dev)
    mask = _train_mask(qpos, kpos, causal=spec.causal, window=spec.window)[0]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mask = mask + torch.where(kvalid, zero, zero - 1e30)[None, :]
    out = _sdpa(q, cache.k, cache.v, mask[None], softcap=spec.softcap)
    return out, KVCache(cache.k, cache.v, cache.pos + S)


def attention(p: Params, x, spec: AttnSpec, *, cos=None, sin=None,
              cache: Optional[KVCache] = None, update_cache: bool = False,
              rolling: bool = False, kv_x=None, cross: bool = False,
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Attention in the reference's modes.

      * cache None, update False — training forward (full sequence).
      * cache None, update True  — prefill: also return the built cache.
      * cache given, cross False — decode: write q_len tokens into the
                                   cache at ``cache.pos`` (in place;
                                   wrapping if ``rolling``) and attend.
      * cache given, cross True  — decode cross-attention against the
                                   read-only cache built at prefill.
    ``kv_x`` — a separate KV source (cross-attention prefill).
    """
    B, S, _ = x.shape
    H, K, hd = spec.n_heads, spec.n_kv, spec.head_dim

    q = x @ p["wq"]
    if spec.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, H, hd)
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"])

    if cross and cache is not None:
        # read-only cross-attention against the encoder cache (no RoPE)
        mask = torch.zeros((1, S, cache.k.shape[1]), dtype=torch.float32,
                           device=x.device)
        out = _sdpa(q, cache.k, cache.v, mask, softcap=spec.softcap)
        return out @ p["wo"], cache

    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if spec.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, Skv, K, hd)
    v = v.reshape(B, Skv, K, hd)
    if spec.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    if not cross:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)      # self-attention: S == Skv

    new_cache = None
    if cache is not None:
        out, new_cache = _decode(q, k, v, cache, spec, rolling)
    else:
        # the reference masks nothing across (cross) or within (encoder)
        masked = spec.causal and not cross
        out = flash_attention_op(q, k, v, causal=masked,
                                 window=spec.window if masked else None,
                                 softcap=spec.softcap).reshape(B, S, H * hd)
        if update_cache:
            new_cache = KVCache(k, v, Skv)
    return out @ p["wo"], new_cache
