"""gemma-7b — dense, GeGLU, head_dim=256, tied embeddings, (1+w) RMSNorm.
[arXiv:2403.08295; hf] (the port's copy of ``repro.configs.gemma_7b``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv=16, head_dim=256,
    d_ff=24576, vocab=256000,
    act="gelu", rms_plus_one=True, embed_scale=True, tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma-7b-reduced", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, head_dim=32,
    d_ff=128, vocab=512,
    act="gelu", rms_plus_one=True, embed_scale=True, tie_embeddings=True,
)
