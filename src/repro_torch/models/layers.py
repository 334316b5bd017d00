"""Model primitives (the port's counterpart of ``repro.models.layers``).

Plain functions over parameter dicts of tensors, in the reference's layouts
(``(B, S, H, hd)`` at every public function), with the reference's names.
Attention has the reference's three modes:

* train / prefill — full sequence through the flash attention op (the Hopper
  kernel on the card, its plain version on the CPU); prefill also returns
  the KV cache;
* decode — q_len tokens against a full (non-rolling) cache, in plain
  PyTorch (``_sdpa`` with a slot mask), as the reference computes it
  outside any Pallas kernel.

The banded, cross-attention, soft-capped, ``qk_norm`` and rolling-cache
branches are not ported yet (ROADMAP queue 1 item 13) and raise.
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
LATER = "not ported yet: ROADMAP queue 1 item 13"


# ---------------------------------------------------------------- norms
def rmsnorm(x, w, *, eps: float = 1e-6, plus_one: bool = False):
    dt = x.dtype
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wf = w.to(torch.float32)
    scale = (1.0 + wf) if plus_one else wf
    return (xf * inv * scale).to(dt)


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
    return (x * scale).to(dtype)


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
        raise NotImplementedError(f"qk_norm attention is {LATER}")
    return p


class KVCache(NamedTuple):
    """Dense KV cache (non-rolling)."""
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


def _sdpa(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,T,K,hd) with H = K·G. mask (B?,S,T) additive."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = scores + mask[:, None, None, :, :]
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    return out.reshape(B, S, H * hd)


def _train_mask(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """Additive mask (1, S, T) from query/key absolute positions."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((dq.shape[0], dk.shape[1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window is not None:
        ok &= dk > dq - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, zero - 1e30)[None]


def attention(p: Params, x, spec: AttnSpec, *, cos=None, sin=None,
              cache: Optional[KVCache] = None, update_cache: bool = False,
              rolling: bool = False, kv_x=None, cross: bool = False,
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention in the reference's modes.

      * cache None, update False — training forward (full sequence).
      * cache None, update True  — prefill: also return the built cache.
      * cache given              — decode: write q_len tokens into the cache
                                   at ``cache.pos`` (in place) and attend.
    """
    if cross or kv_x is not None:
        raise NotImplementedError(f"cross-attention is {LATER}")
    if rolling:
        raise NotImplementedError(f"rolling KV caches are {LATER}")
    if spec.softcap is not None:
        raise NotImplementedError(f"soft-capped attention is {LATER}")
    if spec.qk_norm:
        raise NotImplementedError(f"qk_norm attention is {LATER}")
    B, S, _ = x.shape
    H, K, hd = spec.n_heads, spec.n_kv, spec.head_dim

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, K, hd), cos, sin)
    v = v.reshape(B, S, K, hd)

    new_cache = None
    if cache is not None:
        # decode: write k/v at cache.pos, in place, and attend to the slots
        # written so far
        T = cache.k.shape[1]
        start = cache.pos
        if start + S > T:
            raise ValueError(f"KV cache of {T} slots is full "
                             f"(pos {start} + {S})")
        cache.k[:, start:start + S] = k.to(cache.k.dtype)
        cache.v[:, start:start + S] = v.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, start + S)
        slot = torch.arange(T, device=x.device)
        qpos = start + torch.arange(S, device=x.device)
        mask = _train_mask(qpos, slot, causal=spec.causal,
                           window=spec.window)[0]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        mask = mask + torch.where(slot < start + S, zero, zero - 1e30)[None, :]
        out = _sdpa(q, cache.k, cache.v, mask[None])
    else:
        banded = (spec.window is not None and spec.causal
                  and S % spec.window == 0 and S // spec.window >= 2)
        if banded:
            raise NotImplementedError(f"banded attention is {LATER}")
        out = flash_attention_op(q, k, v, causal=spec.causal,
                                 window=spec.window).reshape(B, S, H * hd)
        if update_cache:
            new_cache = KVCache(k, v, S)
    return out @ p["wo"], new_cache
