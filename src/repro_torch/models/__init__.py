"""LM models of the ported slices (zamba2-1.2b: Mamba-2 + shared attention;
falcon-mamba-7b: Mamba-1; granite-8b, gemma-7b, gemma3-27b, qwen1.5-32b:
dense attention; mixtral-8x7b, mixtral-8x22b: sliding-window attention +
top-2 MoE; seamless-m4t-large-v2: encoder-decoder; internvl2-2b: dense
attention after a patch prefix).

The port's counterpart of ``repro.models``, every block kind and
architecture of the reference.
"""

from .config import ModelConfig
from .layers import AttnSpec, KVCache, attention, mlp, rmsnorm, rope_tables
from .mamba import (Mamba1State, Mamba2State, make_mamba1_state,
                    make_mamba2_state, mamba1_forward, mamba1_step,
                    mamba2_forward, mamba2_step)
from .model import (ForwardResult, forward, init_params, lm_loss,
                    make_caches, plan_segments, rolling_map)
from .moe import MoEStats, moe

__all__ = [
    "ModelConfig", "AttnSpec", "KVCache", "attention", "mlp", "rmsnorm",
    "rope_tables", "Mamba1State", "Mamba2State", "make_mamba1_state",
    "make_mamba2_state", "mamba1_forward", "mamba1_step", "mamba2_forward",
    "mamba2_step",
    "ForwardResult", "forward", "init_params", "lm_loss", "make_caches",
    "plan_segments", "rolling_map", "MoEStats", "moe",
]
