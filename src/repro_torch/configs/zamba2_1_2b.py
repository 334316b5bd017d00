"""zamba2-1.2b — Mamba-2 backbone + shared attention block (+LoRA).
[arXiv:2411.15242; unverified] (the port's copy of
``repro.configs.zamba2_1_2b``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm="mamba2", d_state=64, d_conv=4, expand=2, ssm_headdim=64,
    shared_attn_every=6, shared_lora_rank=32,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512,
    ssm="mamba2", d_state=16, d_conv=4, expand=2, ssm_headdim=16,
    shared_attn_every=4, shared_lora_rank=8, ssm_chunk=16,
)
