"""Model configuration schema (the port's copy of ``repro.models.config``).

The same fields and defaults as the reference's ``ModelConfig``, with torch
dtypes in place of jnp ones, so one configuration means the same model in
both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_base: float = 10000.0
    window: Optional[int] = None           # SWA for every attn layer (mixtral)
    attn_softcap: Optional[float] = None

    # gemma-isms
    act: str = "silu"                      # silu (SwiGLU) | gelu (GeGLU)
    rms_plus_one: bool = False             # (1 + w) RMSNorm scale
    embed_scale: bool = False              # x *= sqrt(d_model)
    tie_embeddings: bool = False

    # gemma3 local:global interleave
    local_global: Optional[Tuple[int, int]] = None     # e.g. (5, 1)
    local_window: int = 1024
    global_rope_base: float = 1.0e6

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25

    # SSM
    ssm: Optional[str] = None              # mamba1 | mamba2
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_bf16: bool = False          # SSD einsum operands in bf16 (f32 accum)

    # hybrid (zamba2): shared attention block every N backbone layers
    shared_attn_every: int = 0
    shared_lora_rank: int = 32

    # enc-dec
    n_enc_layers: int = 0                  # >0 → encoder-decoder

    # vlm: number of image tokens whose embeddings arrive precomputed (stub)
    vlm_patches: int = 0

    # numerics / compile shape
    dtype: Any = torch.bfloat16
    scan_group: int = 4                    # sqrt-remat group (layers per group)
    block_remat: bool = True               # remat each block (drop S×S resid)
    pad_vocab_multiple: int = 256          # shardable logits (production norm)

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def n_params(self) -> float:
        """Analytic parameter count (embeddings included once)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        H, K, hd = self.n_heads, self.n_kv, self.head_dim
        attn = d * (H * hd) + 2 * d * (K * hd) + (H * hd) * d
        mlp_p = 3 * d * ff
        per_layer = 0.0
        if self.ssm == "mamba1":
            R = max(d // 16, 1)
            dI = self.d_inner
            per_layer = d * 2 * dI + self.d_conv * dI + \
                dI * (R + 2 * self.d_state) + R * dI + dI * d
        elif self.ssm == "mamba2":
            dI = self.d_inner
            nh = dI // self.ssm_headdim
            conv_dim = dI + 2 * self.d_state
            per_layer = d * (2 * dI + 2 * self.d_state + nh) + \
                self.d_conv * conv_dim + dI * d
        elif self.n_experts:
            per_layer = attn + self.n_experts * mlp_p + d * self.n_experts
        else:
            per_layer = attn + mlp_p
        total = self.n_layers * per_layer
        if self.is_encdec:
            total += self.n_enc_layers * (attn + mlp_p) \
                + self.n_layers * attn          # cross-attention
        if self.shared_attn_every:
            d2 = 2 * d
            total += d2 * (H * hd) + 2 * d2 * (K * hd) + (H * hd) * d2 \
                + 3 * d2 * ff + d2 * d
        total += V * d * (1 if self.tie_embeddings else 2)
        return float(total)
