"""Assigned input shapes (identical across all 10 LM architectures; the
port's copy of ``repro.configs.shapes``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # train | prefill | decode
    seq: int             # sequence length (KV length for decode)
    batch: int           # global batch


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

# archs whose every attention layer is full/global (KV grows with context and
# attention is quadratic in prefill) — long_500k is skipped for these per the
# assignment; see DESIGN.md §5.
_FULL_ATTENTION = {"qwen1.5-32b", "gemma-7b", "granite-8b",
                   "seamless-m4t-large-v2", "internvl2-2b"}


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape_name == "long_500k" and cfg.name in _FULL_ATTENTION:
        return False, ("pure full-attention arch: 500k dense KV/quadratic "
                       "attention — skipped per assignment (DESIGN.md §5)")
    return True, ""
