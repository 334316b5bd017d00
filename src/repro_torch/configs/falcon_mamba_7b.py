"""falcon-mamba-7b — attention-free Mamba-1 (with B/C/dt RMS norm).
[arXiv:2410.05355; unverified] (the port's copy of
``repro.configs.falcon_mamba_7b``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv=1, head_dim=64,
    d_ff=0, vocab=65024,
    ssm="mamba1", d_state=16, d_conv=4, expand=2,
)

REDUCED = ModelConfig(
    name="falcon-mamba-7b-reduced", family="ssm",
    n_layers=4, d_model=64, n_heads=1, n_kv=1, head_dim=16,
    d_ff=0, vocab=512,
    ssm="mamba1", d_state=8, d_conv=4, expand=2, ssm_chunk=16,
)
