"""Architecture registry: ``--arch <id>`` resolves here.

The port carries every architecture of the reference's registry
(``repro.configs``), with the same configurations.
"""

from . import (falcon_mamba_7b, gemma3_27b, gemma_7b, granite_8b,
               internvl2_2b, mixtral_8x22b, mixtral_8x7b, qwen15_32b,
               seamless_m4t_large_v2, zamba2_1_2b)
from .shapes import SHAPES, Shape, applicable

_MODULES = {
    "qwen1.5-32b": qwen15_32b,
    "gemma-7b": gemma_7b,
    "gemma3-27b": gemma3_27b,
    "granite-8b": granite_8b,
    "mixtral-8x7b": mixtral_8x7b,
    "mixtral-8x22b": mixtral_8x22b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "internvl2-2b": internvl2_2b,
    "zamba2-1.2b": zamba2_1_2b,
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, *, reduced: bool = False):
    base = name.removesuffix("-reduced")
    if base not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    mod = _MODULES[base]
    return mod.REDUCED if (reduced or name.endswith("-reduced")) else mod.CONFIG


__all__ = ["ARCH_NAMES", "SHAPES", "Shape", "applicable", "get_config"]
