"""qwen1.5-32b — dense, QKV bias, MHA (kv=40). [hf:Qwen/Qwen1.5-0.5B; hf]
(the port's copy of ``repro.configs.qwen15_32b``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, head_dim=128,
    d_ff=27392, vocab=152064,
    qkv_bias=True, rope_base=1.0e6, act="silu",
)

REDUCED = ModelConfig(
    name="qwen1.5-32b-reduced", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512, qkv_bias=True, rope_base=1.0e6,
)
