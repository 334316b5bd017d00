"""Two-term roofline of one NVIDIA H100 (the port's counterpart of
``repro.analysis.roofline``, whose constants are a TPU v5e's).

    memory term  = bytes the work must move / HBM bandwidth
    compute term = operations it must do / peak rate of the units doing them
    bound        = max of the two (full overlap)

The rates are data-sheet peaks of the H100 SXM part (NVIDIA H100 80GB
HBM3, dense, at its 700 W power limit), not measurements: HBM3 at 3.35
TB/s, 67 TFLOP/s of float32 outside the tensor cores, 495 TFLOP/s of dense
TF32 and 989 TFLOP/s of dense bf16 on them. A card set below 700 W runs slower under load, so a share of
the bound is stated with the card's power limit beside it.

The reference's ``model_flops`` and ``remat_overhead`` count LM training
work and wait for the LM training slice (ROADMAP queue 1, item 13e).
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12       # HBM3 bandwidth
PEAK_F32_FLOPS = 67e12          # float32 FMA pipes, outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # dense TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12        # dense bf16 on the tensor cores


@dataclasses.dataclass(frozen=True)
class Roofline:
    """The least time one card could take for ``bytes`` moved (each input
    read once, each output written once) and ``operations`` done at
    ``peak_flops`` (:data:`PEAK_F32_FLOPS` unless the work runs on the
    tensor cores: :data:`PEAK_TF32_FLOPS`, :data:`PEAK_BF16_FLOPS`), plus
    ``f32_operations`` that run beside them on the f32 pipes (a bf16
    kernel's exponentials and rescales) at :data:`PEAK_F32_FLOPS`; the
    compute term is the larger of the two rates' times."""
    bytes: float
    operations: float
    peak_flops: float = PEAK_F32_FLOPS
    f32_operations: float = 0.0

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    @property
    def t_compute(self) -> float:
        return max(self.operations / self.peak_flops,
                   self.f32_operations / PEAK_F32_FLOPS)

    @property
    def bottleneck(self) -> str:
        """``"bytes"`` or ``"operations"``: the term that bounds."""
        return "bytes" if self.t_memory >= self.t_compute else "operations"

    @property
    def t_bound(self) -> float:
        """Seconds: the larger term."""
        return max(self.t_memory, self.t_compute)
