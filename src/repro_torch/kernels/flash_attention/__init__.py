"""Flash attention (causal + sliding window + GQA): Hopper CUDA kernel and
plain PyTorch version."""

from .kernel import flash_attention
from .ops import flash_attention_op
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_op", "flash_attention_ref"]
