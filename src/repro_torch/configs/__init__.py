"""Architecture registry: ``--arch <id>`` resolves here.

The port carries the architectures of its ported slices; every other name
of the reference's registry (``repro.configs``) raises, naming the ROADMAP
item that ports it.
"""

from . import (falcon_mamba_7b, gemma3_27b, gemma_7b, granite_8b,
               internvl2_2b, qwen15_32b, seamless_m4t_large_v2, zamba2_1_2b)
from .shapes import SHAPES, Shape, applicable

_MODULES = {
    "qwen1.5-32b": qwen15_32b,
    "gemma-7b": gemma_7b,
    "gemma3-27b": gemma3_27b,
    "granite-8b": granite_8b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "internvl2-2b": internvl2_2b,
    "zamba2-1.2b": zamba2_1_2b,
}

# the reference's other architectures and the ROADMAP item that ports each
_LATER = {
    "mixtral-8x7b": "queue 1 item 13d (MoE)",
    "mixtral-8x22b": "queue 1 item 13d (MoE)",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, *, reduced: bool = False):
    base = name.removesuffix("-reduced")
    if base in _LATER:
        raise NotImplementedError(
            f"{base!r} is not ported yet: ROADMAP {_LATER[base]}")
    if base not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    mod = _MODULES[base]
    return mod.REDUCED if (reduced or name.endswith("-reduced")) else mod.CONFIG


__all__ = ["ARCH_NAMES", "SHAPES", "Shape", "applicable", "get_config"]
