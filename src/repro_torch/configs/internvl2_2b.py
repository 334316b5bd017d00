"""internvl2-2b — InternViT (stub patch embeddings) + InternLM2 backbone.

The vision frontend is a stub: the model takes precomputed patch
embeddings (B, P, d_model), prepended to the token embeddings.
[arXiv:2404.16821; hf] (the port's copy of ``repro.configs.internvl2_2b``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, head_dim=128,
    d_ff=8192, vocab=92553,
    vlm_patches=256,
)

REDUCED = ModelConfig(
    name="internvl2-2b-reduced", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, vlm_patches=16,
)
