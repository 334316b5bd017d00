"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone.

The modality frontend (speech feature extractor) is a stub: the encoder
takes precomputed frame embeddings (B, S_enc, d_model). [arXiv:2308.11596;
hf] (the port's copy of ``repro.configs.seamless_m4t_large_v2``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, head_dim=64,
    d_ff=8192, vocab=256206,
    n_enc_layers=24,
)

REDUCED = ModelConfig(
    name="seamless-m4t-large-v2-reduced", family="encdec",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512, n_enc_layers=3,
)
