"""gemma3-27b — dense, 5:1 local:global, QK-norm, 128k context.
[hf:google/gemma-3-1b-pt; unverified] (the port's copy of
``repro.configs.gemma3_27b``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv=16, head_dim=128,
    d_ff=21504, vocab=262144,
    act="gelu", rms_plus_one=True, embed_scale=True, tie_embeddings=True,
    local_global=(5, 1), local_window=1024, global_rope_base=1.0e6,
    qk_norm=True,
)

REDUCED = ModelConfig(
    name="gemma3-27b-reduced", family="dense",
    n_layers=8, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
    act="gelu", rms_plus_one=True, embed_scale=True, tie_embeddings=True,
    local_global=(5, 1), local_window=32, global_rope_base=1.0e6,
    qk_norm=True,
)
