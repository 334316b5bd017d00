"""Model assembly (the port's counterpart of ``repro.models.model``).

The reference lowers each segment — a (pattern, repeats) pair of block
kinds — to a two-level ``lax.scan`` over parameters stacked along the repeat
dimension. PyTorch runs eagerly, so the port keeps one parameter dict per
layer and walks the layers in a plain loop; its caches are per-layer lists,
the reference's decode layout (``make_caches(..., stacked=False)``).

Block kinds, every one of the reference's: ``attn`` (dense pre-norm
attention + gated MLP: granite, gemma, qwen), ``local`` (sliding-window
attention + MLP, gemma3's local layers), ``global`` (full attention + MLP
with the long RoPE base, gemma3's global layers), ``moe`` (attention with
the model's sliding window + the top-k MoE FFN of ``moe.py``: mixtral),
``mamba1`` (Mamba-1 mixer with B/C/dt RMS norms, falcon-mamba-7b),
``mamba2`` (Mamba-2/SSD mixer, zamba2's backbone), ``mamba2s`` (zamba2's
shared attention block, params reused across invocations, with a
per-invocation LoRA, then Mamba-2), ``enc`` (bidirectional attention +
MLP, the encoder of seamless-m4t-large-v2) and ``dec`` (causal
self-attention, cross-attention to the encoder's output, then MLP).
``forward`` returns the MoE layers' aux loss and per-expert token counts
summed over the layers, as the reference's does (zeros for a model
without experts).

In train mode with grad on, each segment runs under the reference's two
remat levels (``run_segment``, ``repro/models/model.py:420-497``) as
``torch.utils.checkpoint`` regions: groups of ``_group(repeats,
cfg.scan_group)`` layers (the reference's outer ``jax.checkpoint``), and
inside them each block on its own when ``cfg.block_remat`` is set. A
backward then runs each block's forward three times with both levels on
(once, then the group's recompute, then the block's), but a group's last
block twice: the group's recompute stops once it holds every tensor the
group saved (PyTorch's non-reentrant checkpoint), and it saved only that
block's input. With the group level alone, twice. ``lm_loss`` is the
reference's causal-LM cross-entropy.

The enc-dec model runs its encoder over precomputed frame embeddings
(``enc_inputs``, a stub frontend) in every mode but decode, whose
cross-attention reads the caches built at prefill; the VLM prepends
precomputed patch embeddings (``patch_embeds``) to the token embeddings.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .config import ModelConfig
from .layers import (AttnSpec, attention, init_attention, init_mlp,
                     make_cache, mlp, normal, rmsnorm, rope_tables)
from .mamba import (init_mamba1, init_mamba2, make_mamba1_state,
                    make_mamba2_state, mamba1_forward, mamba1_step,
                    mamba2_forward, mamba2_step)
from .moe import init_moe, moe

Params = Dict[str, Any]
BLOCK_KINDS = ("attn", "local", "global", "moe", "enc", "dec", "mamba1",
               "mamba2", "mamba2s")
# the kinds whose cache is one self-attention KV cache
ATTN_KINDS = ("attn", "local", "global", "moe")
# the kinds built of attention + an FFN (``dec`` adds cross-attention;
# ``moe``'s FFN is the MoE, the others' the gated MLP)
TRANSFORMER_KINDS = ATTN_KINDS + ("enc", "dec")


# ------------------------------------------------------------------ helpers
def _norm(cfg: ModelConfig, w, x):
    return rmsnorm(x, w, plus_one=cfg.rms_plus_one)


def _group(repeats: int, target: int) -> int:
    """Largest divisor of ``repeats`` that is ≤ target (≥1)."""
    g = 1
    for d in range(1, min(repeats, target) + 1):
        if repeats % d == 0:
            g = d
    return g


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


# the kernel calls of one block of each kind in a forward (``dec``: self-
# and cross-attention; ``mamba2s``: zamba2's shared attention block and its
# Mamba-2 mixer), and the backward kernel of each
BLOCK_KERNEL_CALLS = {
    "attn": {"flash_attention": 1}, "local": {"flash_attention": 1},
    "global": {"flash_attention": 1}, "moe": {"flash_attention": 1},
    "enc": {"flash_attention": 1}, "dec": {"flash_attention": 2},
    "mamba1": {"selective_scan": 1}, "mamba2": {"ssd_scan": 1},
    "mamba2s": {"ssd_scan": 1, "flash_attention": 1}}
KERNEL_BACKWARD = {"flash_attention": "flash_attention_bwd",
                   "selective_scan": "selective_scan_bwd",
                   "ssd_scan": "ssd_scan_bwd"}


def train_step_launches(cfg: ModelConfig) -> Dict[str, int]:
    """The kernel launches of one train step of ``cfg`` on the card, by
    entry (the forwards' f32 entries and ``KERNEL_BACKWARD``; for a bf16
    ``cfg`` attention's bf16 entry and its backward, ``flash_attention_bf16``
    and ``flash_attention_bwd_bf16``, the SSD scan's, ``ssd_scan_bf16`` and
    ``ssd_scan_bwd_bf16``, only under ``ssm_bf16``, while the scans take
    their f32 entries otherwise, as the models pass them f32): per segment
    (``plan_segments``, and an enc-dec model's encoder) of R repeats of a
    pattern, in groups of ``_group(R, scan_group)`` repeats, each block's
    calls (``BLOCK_KERNEL_CALLS``) run backward once and forward: with both
    remat levels 3 times (its own, again in its block's recompute and in
    its group's) but for the pattern's last block, whose group recompute
    stops before it (2 in each group); with the group level alone
    (``block_remat`` off) twice."""
    segments = list(plan_segments(cfg))
    if cfg.is_encdec:
        segments.append((("enc",), cfg.n_enc_layers))
    out = dict.fromkeys(list(KERNEL_BACKWARD) + list(
        KERNEL_BACKWARD.values()), 0)
    out.update(flash_attention_bf16=0, flash_attention_bwd_bf16=0,
               ssd_scan_bf16=0, ssd_scan_bwd_bf16=0)
    bf16 = cfg.dtype == torch.bfloat16
    bf16_kernels = {"flash_attention"} | ({"ssd_scan"} if cfg.ssm_bf16
                                          else set())
    for pattern, R in segments:
        groups = R // _group(R, cfg.scan_group)
        for i, kind in enumerate(pattern):
            last = i == len(pattern) - 1
            for name, n in BLOCK_KERNEL_CALLS[kind].items():
                fwd = (3 * R - (groups if last else 0) if cfg.block_remat
                       else 2 * R)
                suffix = "_bf16" if bf16 and name in bf16_kernels else ""
                out[name + suffix] += fwd * n
                out[KERNEL_BACKWARD[name] + suffix] += R * n
    return out


# ----------------------------------------------------------- block init
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    dt = cfg.dtype
    d = cfg.d_model
    if kind in TRANSFORMER_KINDS:
        norm = torch.zeros if cfg.rms_plus_one else torch.ones
        p = {"ln1": norm((d,), dtype=dt, device=gen.device),
             "ln2": norm((d,), dtype=dt, device=gen.device),
             "attn": init_attention(gen, attn_spec(cfg, kind), dtype=dt),
             "ffn": (init_moe(gen, d, cfg.d_ff, cfg.n_experts, dtype=dt)
                     if kind == "moe" else
                     init_mlp(gen, d, cfg.d_ff, dtype=dt))}
        if kind == "dec":
            p["ln_x"] = torch.ones((d,), dtype=dt, device=gen.device)
            p["xattn"] = init_attention(gen, attn_spec(cfg, kind), dtype=dt)
        return p
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
    dicts of pattern position ``pi``, and an enc-dec model's ``encoder``
    the list of its ``n_enc_layers`` per-layer dicts (the reference stacks
    both instead).
    """
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
    if cfg.is_encdec:
        p["encoder"] = [init_block(gen, cfg, "enc")
                        for _ in range(cfg.n_enc_layers)]
        p["enc_ln_f"] = torch.ones((cfg.d_model,), dtype=dt,
                                   device=gen.device)
    return p


# -------------------------------------------------------------------- caches
def rolling_map(cfg: ModelConfig, cache_len: int) -> Dict[str, bool]:
    """Which attention kinds use wrap-around (rolling) KV caches at this
    cache length: those with a window shorter than the cache."""
    rolling: Dict[str, bool] = {}
    for pattern, _ in plan_segments(cfg):
        for kind in pattern:
            if kind in TRANSFORMER_KINDS:
                spec = attn_spec(cfg, kind)
                rolling[kind] = (spec.window is not None
                                 and cache_len > spec.window)
    return rolling


def make_caches(cfg: ModelConfig, batch: int, cache_len: int, *,
                enc_len: int = 0, device=None
                ) -> Tuple[list, Dict[str, bool]]:
    """Zero caches for decode, one per layer (the reference's
    ``stacked=False`` layout), on the card unless ``device`` says otherwise.
    Returns (caches, rolling map: kind → whether its KV cache wraps); a
    rolling cache has the window's length. A ``dec`` layer's cache is the
    pair (self, cross): the cross cache has ``enc_len`` slots, all held
    (``pos = enc_len``)."""
    device = resolve_device(device)
    rolling: Dict[str, bool] = {}

    def kv_len(kind: str) -> int:
        spec = attn_spec(cfg, kind)
        if spec.window is not None and cache_len > spec.window:
            rolling[kind] = True
            return spec.window
        rolling.setdefault(kind, False)
        return cache_len

    def block_cache(kind: str):
        if kind in ATTN_KINDS:
            return make_cache(batch, kv_len(kind), attn_spec(cfg, kind),
                              dtype=cfg.dtype, device=device)
        if kind == "dec":
            spec = attn_spec(cfg, kind)
            cross = make_cache(batch, enc_len, spec, dtype=cfg.dtype,
                               device=device)
            return (make_cache(batch, kv_len(kind), spec, dtype=cfg.dtype,
                               device=device), cross._replace(pos=enc_len))
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
    return caches, rolling


# --------------------------------------------------------------- block apply
@dataclasses.dataclass
class BlockIO:
    cfg: ModelConfig
    mode: str                                  # train | prefill | decode
    rope: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    rolling: Dict[str, bool] = dataclasses.field(default_factory=dict)
    enc_out: Optional[torch.Tensor] = None     # enc-dec: encoder output
    shared: Optional[Params] = None
    x0: Optional[torch.Tensor] = None          # zamba2: initial embedding
    # each ``moe`` block's (aux loss, tokens per expert), in layer order
    moe_stats: list = dataclasses.field(default_factory=list)


def apply_block(p: Params, x, kind: str, io: BlockIO, cache):
    """One block (``repro/models/model.py:330-414``). Returns (x,
    new_cache); a ``dec`` block's cache is the pair (self, cross). A ``moe``
    block appends its (aux loss, tokens per expert) to ``io.moe_stats``
    (the reference returns them as a third value)."""
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    cfg = io.cfg
    decode = io.mode == "decode"
    prefill = io.mode == "prefill"
    if kind in TRANSFORMER_KINDS:
        spec = attn_spec(cfg, kind)
        cos, sin = io.rope["global" if kind == "global" else "default"]
        self_cache = cache[0] if kind == "dec" and cache is not None else cache
        h = _norm(cfg, p["ln1"], x)
        a, new_kv = attention(p["attn"], h, spec, cos=cos, sin=sin,
                              cache=self_cache if decode else None,
                              update_cache=prefill,
                              rolling=io.rolling.get(kind, False) and decode)
        x = x + a
        if kind == "dec":
            h = _norm(cfg, p["ln_x"], x)
            if decode:
                xa, new_cross = attention(p["xattn"], h, spec, cross=True,
                                          cache=cache[1])
            else:
                xa, new_cross = attention(p["xattn"], h, spec, cross=True,
                                          kv_x=io.enc_out,
                                          update_cache=prefill)
            x = x + xa
            new_kv = (new_kv, new_cross) if (decode or prefill) else None
        h = _norm(cfg, p["ln2"], x)
        if kind == "moe":
            m, stats = moe(p["ffn"], h, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor)
            io.moe_stats.append((stats.aux_loss, stats.tokens_per_expert))
            return x + m, new_kv
        return x + mlp(p["ffn"], h, act=cfg.act), new_kv
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


# ------------------------------------------------------------ train remat
def _block_with_stats(p, kind: str, x, io: BlockIO):
    """One block in train mode; returns x and its (aux loss, expert
    counts) as outputs (zeros but for a ``moe`` block), so that a
    recomputed region does not append to ``io``."""
    local = dataclasses.replace(io, moe_stats=[])
    x, _ = apply_block(p, x, kind, local, None)
    if local.moe_stats:
        return (x,) + tuple(local.moe_stats[0])
    return (x, torch.zeros((), dtype=torch.float32, device=x.device),
            torch.zeros((max(io.cfg.n_experts, 1),), dtype=torch.float32,
                        device=x.device))


def _train_segment(seg_p, x, pattern, repeats: int, io: BlockIO):
    """One segment in train mode under the reference's remat levels: each
    group of ``_group(repeats, scan_group)`` layers is a checkpoint region,
    and with ``block_remat`` each block inside it is one too. The MoE
    blocks' (aux, counts) go to ``io.moe_stats`` once a group."""
    G = _group(repeats, io.cfg.scan_group)

    def block(p, kind, x):
        if io.cfg.block_remat:
            return checkpoint(_block_with_stats, p, kind, x, io,
                              use_reentrant=False)
        return _block_with_stats(p, kind, x, io)

    def group(r0, x):
        aux = counts = None
        for r in range(r0, r0 + G):
            for i, kind in enumerate(pattern):
                x, a, c = block(seg_p[i][r], kind, x)
                aux, counts = ((a, c) if aux is None
                               else (aux + a, counts + c))
        return x, aux, counts

    for r0 in range(0, repeats, G):
        x, aux, counts = checkpoint(group, r0, x, use_reentrant=False)
        io.moe_stats.append((aux, counts))
    return x


# ----------------------------------------------------------------- top level
def _rope_for(cfg: ModelConfig, positions) -> Dict[str, tuple]:
    """RoPE tables by name: ``default``, and ``global`` for gemma3's global
    layers (their own base; the default tables where there is none)."""
    out = {"default": rope_tables(positions, cfg.head_dim, cfg.rope_base)}
    if cfg.local_global is not None:
        out["global"] = rope_tables(positions, cfg.head_dim,
                                    cfg.global_rope_base)
    else:
        out["global"] = out["default"]
    return out


def _run_encoder(params: Params, cfg: ModelConfig, enc_in, io: BlockIO):
    """The encoder stack over precomputed frame embeddings (B, S_enc, d),
    in train mode with RoPE over ``arange(S_enc)``, then its final norm
    (``repro/models/model.py:510-518``)."""
    x = enc_in.to(cfg.dtype)
    enc_io = dataclasses.replace(
        io, mode="train", enc_out=None,
        rope=_rope_for(cfg, torch.arange(x.shape[1], device=x.device)))
    if torch.is_grad_enabled():      # the reference's remat levels
        x = _train_segment([params["encoder"]], x, ("enc",),
                           len(params["encoder"]), enc_io)
    else:
        for p in params["encoder"]:
            x, _ = apply_block(p, x, "enc", enc_io, None)
    return rmsnorm(x, params["enc_ln_f"])


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
    aux_loss: torch.Tensor         # () f32: the MoE layers' summed aux loss
    expert_counts: torch.Tensor    # (max(E, 1),) f32: summed token counts


def forward(params: Params, cfg: ModelConfig, tokens, *,
            mode: str = "train", caches: Optional[list] = None,
            rolling: Optional[Dict[str, bool]] = None,
            positions=None, enc_inputs=None,
            patch_embeds=None) -> ForwardResult:
    """Unified forward.

    train:   tokens (B, S)                          → logits (B, S, V)
    prefill: as train, also returns per-layer caches
    decode:  tokens (B, S_small) + caches + positions → logits + new caches
             (KV caches are written in place; ``rolling`` says which kinds'
             caches wrap)
    enc-dec: enc_inputs (B, S_enc, d) precomputed embeddings (stub
             frontend), run through the encoder in train and prefill
    vlm:     patch_embeds (B, P, d) prepended to the token embeddings
             (logits (B, P + S, V))
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "decode" and caches is None:
        raise ValueError("decode needs caches")
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(cfg.dtype), x], dim=1)
        S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    io = BlockIO(cfg=cfg, mode=mode, rope=_rope_for(cfg, positions),
                 rolling=rolling or {})
    if cfg.shared_attn_every:
        io.shared = params["shared"]
        io.x0 = x
    if cfg.is_encdec and mode != "decode":   # decode: cross caches built
        if enc_inputs is None:
            raise ValueError("an enc-dec model needs encoder inputs")
        io.enc_out = _run_encoder(params, cfg, enc_inputs, io)
    want = mode in ("prefill", "decode")
    new_caches = [] if want else None
    for si, (pattern, repeats) in enumerate(plan_segments(cfg)):
        seg_p = params["segments"][si]
        if mode == "train" and torch.is_grad_enabled():
            x = _train_segment(seg_p, x, pattern, repeats, io)
            continue
        seg_new = [[None] * repeats for _ in pattern]
        for r in range(repeats):
            for i, kind in enumerate(pattern):
                c = caches[si][i][r] if caches is not None else None
                x, nc = apply_block(seg_p[i][r], x, kind, io, c)
                seg_new[i][r] = nc
        if want:
            new_caches.append(seg_new)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = torch.zeros((max(cfg.n_experts, 1),), dtype=torch.float32,
                         device=x.device)
    for a, c in io.moe_stats:
        aux, counts = aux + a, counts + c
    return ForwardResult(_logits(params, cfg, x), new_caches, aux, counts)


def lm_loss(params: Params, cfg: ModelConfig, tokens, targets, *,
            aux_weight: float = 0.01, enc_inputs=None, patch_embeds=None):
    """Causal LM cross-entropy (+ the MoE aux loss), the reference's
    ``lm_loss`` (``repro/models/model.py:588``): the train forward's
    logits in f32, logsumexp minus the target's logit, the mean over
    tokens (the VLM's patch positions sliced off first), plus
    ``aux_weight · aux_loss`` for a model with experts. Returns (loss,
    summed expert counts)."""
    res = forward(params, cfg, tokens, mode="train", enc_inputs=enc_inputs,
                  patch_embeds=patch_embeds)
    logits = res.logits
    if patch_embeds is not None:
        logits = logits[:, patch_embeds.shape[1]:]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if cfg.n_experts:
        loss = loss + aux_weight * res.aux_loss
    return loss, res.expert_counts
