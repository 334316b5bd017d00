"""Flash attention (causal + sliding window + GQA): Hopper CUDA kernels,
forward and (f32) backward, and plain PyTorch versions."""

from .kernel import flash_attention, flash_attention_bwd
from .ops import flash_attention_op
from .ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                  flash_attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_op",
           "flash_attention_ref", "flash_attention_lse_ref",
           "flash_attention_bwd_ref"]
