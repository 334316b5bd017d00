"""The element types the LM kernels take on the card.

Each LM kernel has two entries in its library, ``*_f32`` and ``*_bf16``:
the tensors it streams (flash attention's q, k, v; a scan's u, Bm, Cm) are
all of one of :data:`ENTRY_DTYPES`, and every other argument is float32.
Nothing is converted to reach an entry: any other dtype or a mix raises.
"""

from __future__ import annotations

from typing import Dict

import torch

ENTRY_DTYPES = (torch.float32, torch.bfloat16)


def check_dtypes(name: str, stream: Dict[str, torch.Tensor],
                 f32: Dict[str, torch.Tensor] = None) -> None:
    """Raise ``TypeError`` unless the tensors of ``stream`` (name → tensor)
    share one of :data:`ENTRY_DTYPES` and every tensor of ``f32`` is
    float32."""
    dtypes = [t.dtype for t in stream.values()]
    if dtypes[0] not in ENTRY_DTYPES or len(set(dtypes)) != 1:
        raise TypeError(f"{name}: {', '.join(stream)} are "
                        f"{', '.join(map(str, dtypes))}; the kernel takes "
                        f"all torch.float32 or all torch.bfloat16")
    for k, t in (f32 or {}).items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} is {t.dtype}; the kernel takes "
                            f"torch.float32")
