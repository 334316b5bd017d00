"""LM models of the ported slices (zamba2-1.2b: Mamba-2 + shared attention;
falcon-mamba-7b: Mamba-1).

The port's counterpart of ``repro.models``; block kinds, attention branches
and architectures of later slices raise, naming their ROADMAP item.
"""

from .config import ModelConfig
from .layers import AttnSpec, KVCache, attention, mlp, rmsnorm, rope_tables
from .mamba import (Mamba1State, Mamba2State, make_mamba1_state,
                    make_mamba2_state, mamba1_forward, mamba1_step,
                    mamba2_forward, mamba2_step)
from .model import (ForwardResult, forward, init_params, make_caches,
                    plan_segments)

__all__ = [
    "ModelConfig", "AttnSpec", "KVCache", "attention", "mlp", "rmsnorm",
    "rope_tables", "Mamba1State", "Mamba2State", "make_mamba1_state",
    "make_mamba2_state", "mamba1_forward", "mamba1_step", "mamba2_forward",
    "mamba2_step",
    "ForwardResult", "forward", "init_params", "make_caches",
    "plan_segments",
]
