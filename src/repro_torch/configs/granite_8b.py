"""granite-8b — llama-arch dense (code model). [arXiv:2405.04324; hf]
(the port's copy of ``repro.configs.granite_8b``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=49152,
    act="silu", tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="granite-8b-reduced", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, tie_embeddings=True,
)
