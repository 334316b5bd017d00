"""Architecture registry: ``--arch <id>`` resolves here.

The port carries the architectures of its ported slices; every other name
of the reference's registry (``repro.configs``) raises, naming the ROADMAP
item that ports it.
"""

from . import falcon_mamba_7b, zamba2_1_2b

_MODULES = {
    "zamba2-1.2b": zamba2_1_2b,
    "falcon-mamba-7b": falcon_mamba_7b,
}

# the reference's other architectures and the ROADMAP item that ports each
_LATER = {
    "qwen1.5-32b": "queue 1 item 13 (rest of the LM zoo)",
    "gemma-7b": "queue 1 item 13 (rest of the LM zoo)",
    "gemma3-27b": "queue 1 item 13 (rest of the LM zoo)",
    "granite-8b": "queue 1 item 13 (rest of the LM zoo)",
    "mixtral-8x7b": "queue 1 item 13 (rest of the LM zoo, MoE)",
    "mixtral-8x22b": "queue 1 item 13 (rest of the LM zoo, MoE)",
    "seamless-m4t-large-v2": "queue 1 item 13 (rest of the LM zoo)",
    "internvl2-2b": "queue 1 item 13 (rest of the LM zoo)",
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


__all__ = ["ARCH_NAMES", "get_config"]
