"""Model assembly (the port's counterpart of ``repro.models.model``).

The reference lowers each segment — a (pattern, repeats) pair of block
kinds — to a two-level ``lax.scan`` over parameters stacked along the repeat
dimension. PyTorch runs eagerly, so the port keeps one parameter dict per
layer and walks the layers in a plain loop; its caches are per-layer lists,
the reference's decode layout (``make_caches(..., stacked=False)``).

Block kinds of the ported slices: ``mamba1`` (Mamba-1 mixer with B/C/dt
RMS norms, falcon-mamba-7b), ``mamba2`` (Mamba-2/SSD mixer, zamba2's
backbone) and ``mamba2s`` (zamba2's shared attention block, params reused
across invocations, with a per-invocation LoRA, then Mamba-2). Every other
kind of the reference raises, naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from .config import ModelConfig
from .layers import (AttnSpec, attention, init_attention, init_mlp,
                     make_cache, mlp, normal, rmsnorm, rope_tables)
from .mamba import (init_mamba1, init_mamba2, make_mamba1_state,
                    make_mamba2_state, mamba1_forward, mamba1_step,
                    mamba2_forward, mamba2_step)

Params = Dict[str, Any]
PORTED_KINDS = ("mamba1", "mamba2", "mamba2s")


def _later(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: ROADMAP queue 1 item 13 "
        f"(rest of the LM zoo)")


# ------------------------------------------------------------------ helpers
def _norm(cfg: ModelConfig, w, x):
    return rmsnorm(x, w, plus_one=cfg.rms_plus_one)


def attn_spec(cfg: ModelConfig, kind: str) -> AttnSpec:
    window = None
    base = cfg.rope_base
    if kind == "local":
        window = cfg.local_window
    elif kind == "global":
        base = cfg.global_rope_base
    elif cfg.window is not None and kind in ("attn", "moe"):
        window = cfg.window
    return AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                    head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
                    qk_norm=cfg.qk_norm, softcap=cfg.attn_softcap,
                    rope_base=base, window=window, causal=(kind != "enc"))


def shared_attn_spec(cfg: ModelConfig) -> AttnSpec:
    """Zamba2's shared block runs at concat width 2·d_model."""
    return AttnSpec(d_model=2 * cfg.d_model, n_heads=cfg.n_heads,
                    n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                    rope_base=cfg.rope_base, causal=True)


def plan_segments(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """Decoder-side segments, as the reference plans them."""
    L = cfg.n_layers
    if cfg.local_global is not None:
        loc, glob = cfg.local_global
        k = loc + glob
        segs: List[Tuple[Tuple[str, ...], int]] = []
        if L // k:
            segs.append((("local",) * loc + ("global",) * glob, L // k))
        if L % k:
            segs.append((("local",) * (L % k), 1))
        return segs
    if cfg.family == "moe":
        return [(("moe",), L)]
    if cfg.ssm == "mamba1":
        return [(("mamba1",), L)]
    if cfg.shared_attn_every:
        k = cfg.shared_attn_every
        segs = []
        if L // k:
            segs.append((("mamba2s",) + ("mamba2",) * (k - 1), L // k))
        if L % k:
            segs.append((("mamba2",) * (L % k), 1))
        return segs
    if cfg.ssm == "mamba2":
        return [(("mamba2",), L)]
    if cfg.is_encdec:
        return [(("dec",), L)]
    return [(("attn",), L)]


def _check_ported(cfg: ModelConfig) -> None:
    for pattern, _ in plan_segments(cfg):
        for kind in pattern:
            if kind not in PORTED_KINDS:
                raise _later(kind)
    if cfg.is_encdec or cfg.vlm_patches:
        raise _later("enc-dec / vlm")


# ----------------------------------------------------------- block init
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    if kind not in PORTED_KINDS:
        raise _later(kind)
    dt = cfg.dtype
    d = cfg.d_model
    ln1 = torch.ones((d,), dtype=dt, device=gen.device)
    if kind == "mamba1":
        return {"ln1": ln1,
                "mix": init_mamba1(gen, d, d_state=cfg.d_state,
                                   d_conv=cfg.d_conv, expand=cfg.expand,
                                   bcdt_rms=True, dtype=dt)}
    p = {"ln1": ln1,
         "mix": init_mamba2(gen, d, d_state=cfg.d_state, d_conv=cfg.d_conv,
                            expand=cfg.expand, headdim=cfg.ssm_headdim,
                            dtype=dt)}
    if kind == "mamba2s":
        # per-invocation LoRA on the shared block's output projection
        r = cfg.shared_lora_rank
        p["lora_a"] = normal(gen, (2 * d, r), 1.0 / math.sqrt(2 * d), dt)
        p["lora_b"] = torch.zeros((r, d), dtype=dt, device=gen.device)
    return p


def init_shared_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Zamba2 shared transformer block at width 2·d_model, projecting to d."""
    dt = cfg.dtype
    d2 = 2 * cfg.d_model
    return {
        "ln1": torch.ones((d2,), dtype=dt, device=gen.device),
        "ln2": torch.ones((d2,), dtype=dt, device=gen.device),
        "attn": init_attention(gen, shared_attn_spec(cfg), dtype=dt),
        "ffn": init_mlp(gen, d2, cfg.d_ff, dtype=dt),
        "out": normal(gen, (d2, cfg.d_model), 1.0 / math.sqrt(d2), dt),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters with the reference's distributions
    (``repro/models/model.py:178``), drawn from ``gen`` on its device.

    Layout: ``segments[si][pi]`` is the list of the ``repeats`` per-layer
    dicts of pattern position ``pi`` (the reference stacks them instead).
    """
    _check_ported(cfg)
    dt = cfg.dtype
    p: Params = {
        "embed": normal(gen, (cfg.vocab_padded, cfg.d_model), 0.02, dt),
        "ln_f": (torch.zeros if cfg.rms_plus_one else torch.ones)(
            (cfg.d_model,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = normal(gen, (cfg.d_model, cfg.vocab_padded),
                           1.0 / math.sqrt(cfg.d_model), dt)
    p["segments"] = [[[init_block(gen, cfg, kind) for _ in range(repeats)]
                      for kind in pattern]
                     for pattern, repeats in plan_segments(cfg)]
    if cfg.shared_attn_every:
        p["shared"] = init_shared_block(gen, cfg)
    return p


# -------------------------------------------------------------------- caches
def make_caches(cfg: ModelConfig, batch: int, cache_len: int, *,
                device=None) -> Tuple[list, Dict[str, bool]]:
    """Zero caches for decode, one per layer (the reference's
    ``stacked=False`` layout), on the card unless ``device`` says otherwise.
    Returns (caches, rolling map); no ported kind has a rolling
    cache, so the map is empty."""
    _check_ported(cfg)
    device = resolve_device(device)

    def block_cache(kind: str):
        if kind == "mamba1":
            return make_mamba1_state(batch, cfg.d_model, d_state=cfg.d_state,
                                     d_conv=cfg.d_conv, expand=cfg.expand,
                                     dtype=cfg.dtype, device=device)
        ssm = make_mamba2_state(batch, cfg.d_model, d_state=cfg.d_state,
                                d_conv=cfg.d_conv, expand=cfg.expand,
                                headdim=cfg.ssm_headdim, dtype=cfg.dtype,
                                device=device)
        if kind == "mamba2":
            return ssm
        kv = make_cache(batch, cache_len, shared_attn_spec(cfg),
                        dtype=cfg.dtype, device=device)
        return (kv, ssm)

    caches = [[[block_cache(kind) for _ in range(repeats)]
               for kind in pattern]
              for pattern, repeats in plan_segments(cfg)]
    return caches, {}


# --------------------------------------------------------------- block apply
@dataclasses.dataclass
class BlockIO:
    cfg: ModelConfig
    mode: str                                  # train | prefill | decode
    rope: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    shared: Optional[Params] = None
    x0: Optional[torch.Tensor] = None          # zamba2: initial embedding


def apply_block(p: Params, x, kind: str, io: BlockIO, cache):
    """One block (``repro/models/model.py:367-414`` for the ported
    kinds). Returns (x, new_cache)."""
    if kind not in PORTED_KINDS:
        raise _later(kind)
    cfg = io.cfg
    decode = io.mode == "decode"
    prefill = io.mode == "prefill"
    if kind == "mamba1":
        h = _norm(cfg, p["ln1"], x)
        if decode and x.shape[1] == 1:
            y, new_state = mamba1_step(p["mix"], h, cache,
                                       d_state=cfg.d_state, bcdt_rms=True)
        else:
            y, new_state = mamba1_forward(
                p["mix"], h, d_state=cfg.d_state, bcdt_rms=True,
                state=cache if decode else None,
                return_state=decode or prefill)
        return x + y, new_state
    if kind == "mamba2s":
        kv_cache = cache[0] if cache is not None else None
        ssm_cache = cache[1] if cache is not None else None
        sh = io.shared
        spec = shared_attn_spec(cfg)
        cos, sin = io.rope["default"]
        xc = torch.cat([x, io.x0], dim=-1)
        h = _norm(cfg, sh["ln1"], xc)
        a, new_kv = attention(sh["attn"], h, spec, cos=cos, sin=sin,
                              cache=kv_cache if decode else None,
                              update_cache=prefill)
        xc = xc + a
        h2 = _norm(cfg, sh["ln2"], xc)
        xc = xc + mlp(sh["ffn"], h2, act=cfg.act)
        delta = xc @ sh["out"] + (xc @ p["lora_a"]) @ p["lora_b"]
        x = x + delta
    else:
        ssm_cache = cache
        new_kv = None
    h = _norm(cfg, p["ln1"], x)
    if decode and x.shape[1] == 1:
        y, new_state = mamba2_step(p["mix"], h, ssm_cache,
                                   d_state=cfg.d_state,
                                   headdim=cfg.ssm_headdim)
    else:
        y, new_state = mamba2_forward(
            p["mix"], h, d_state=cfg.d_state, headdim=cfg.ssm_headdim,
            chunk=cfg.ssm_chunk, bf16_einsum=cfg.ssm_bf16,
            state=ssm_cache if decode else None,
            return_state=decode or prefill)
    x = x + y
    if kind == "mamba2s":
        return x, ((new_kv, new_state) if (decode or prefill) else None)
    return x, new_state


# ----------------------------------------------------------------- top level
def _rope_for(cfg: ModelConfig, positions) -> Dict[str, tuple]:
    """RoPE tables by name; the kinds of this slice use ``default`` only
    (the reference's ``global`` tables serve gemma3's global layers)."""
    return {"default": rope_tables(positions, cfg.head_dim, cfg.rope_base)}


def _embed(params: Params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                             device=x.device)
    return x


def _logits(params: Params, cfg: ModelConfig, x):
    x = _norm(cfg, params["ln_f"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


class ForwardResult(NamedTuple):
    logits: torch.Tensor
    caches: Optional[list]


def forward(params: Params, cfg: ModelConfig, tokens, *,
            mode: str = "train", caches: Optional[list] = None,
            rolling: Optional[Dict[str, bool]] = None,
            positions=None) -> ForwardResult:
    """Unified forward.

    train:   tokens (B, S)                          → logits (B, S, V)
    prefill: as train, also returns per-layer caches
    decode:  tokens (B, S_small) + caches + positions → logits + new caches
             (KV caches are written in place)
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "decode" and caches is None:
        raise ValueError("decode needs caches")
    if rolling and any(rolling.values()):
        raise NotImplementedError("rolling KV caches are not ported yet: "
                                  "ROADMAP queue 1 item 13")
    _check_ported(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    io = BlockIO(cfg=cfg, mode=mode, rope=_rope_for(cfg, positions))
    if cfg.shared_attn_every:
        io.shared = params["shared"]
        io.x0 = x
    want = mode in ("prefill", "decode")
    new_caches = [] if want else None
    for si, (pattern, repeats) in enumerate(plan_segments(cfg)):
        seg_p = params["segments"][si]
        seg_new = [[None] * repeats for _ in pattern]
        for r in range(repeats):
            for i, kind in enumerate(pattern):
                c = caches[si][i][r] if caches is not None else None
                x, nc = apply_block(seg_p[i][r], x, kind, io, c)
                seg_new[i][r] = nc
        if want:
            new_caches.append(seg_new)
    return ForwardResult(_logits(params, cfg, x), new_caches)
