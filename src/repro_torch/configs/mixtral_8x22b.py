"""mixtral-8x22b — MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
(the port's copy of ``repro.configs.mixtral_8x22b``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, window=4096,
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, n_experts=4, top_k=2, window=64,
    capacity_factor=8.0,
)
