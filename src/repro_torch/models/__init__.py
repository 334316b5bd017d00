"""LM models of the ported slices (zamba2-1.2b: Mamba-2 + shared attention).

The port's counterpart of ``repro.models``; block kinds, attention branches
and architectures of later slices raise, naming their ROADMAP item.
"""

from .config import ModelConfig
from .layers import AttnSpec, KVCache, attention, mlp, rmsnorm, rope_tables
from .mamba import Mamba2State, mamba2_forward, mamba2_step
from .model import (ForwardResult, forward, init_params, make_caches,
                    plan_segments)

__all__ = [
    "ModelConfig", "AttnSpec", "KVCache", "attention", "mlp", "rmsnorm",
    "rope_tables", "Mamba2State", "mamba2_forward", "mamba2_step",
    "ForwardResult", "forward", "init_params", "make_caches",
    "plan_segments",
]
