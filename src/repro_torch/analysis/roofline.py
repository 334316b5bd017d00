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

``model_flops`` and ``remat_overhead`` are the reference's
(``repro/analysis/roofline.py:91``, ``:105``): the useful LM work of a
train, prefill or decode shape (6·N·D, 2·N_active·D) and the executed
over useful ratio of its remat levels. The training path reports its
step's share of :data:`PEAK_F32_FLOPS` as ``model_flops ×
remat_overhead`` over the step's wall.
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


def model_flops(cfg, shape, *, chips: int) -> float:
    """MODEL_FLOPS per chip: 6·N·D train, 2·N_active·D inference (``shape``
    has ``kind``, ``batch`` and ``seq``, as ``configs.shapes.Shape``)."""
    n_act = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        total = 6.0 * n_act * tokens
    elif shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        total = 2.0 * n_act * tokens
    else:                                    # decode: one token per sequence
        total = 2.0 * n_act * shape.batch
    return total / chips


def remat_overhead(cfg, shape) -> float:
    """Executed/useful flops ratio from the remat policy.

    Train = fwd(2ND) + bwd(4ND) + one extra fwd per remat level: the
    group-level sqrt remat always recomputes once, ``block_remat`` adds a
    second recompute ⇒ (6 + 2·levels)/6.
    """
    if shape.kind != "train":
        return 1.0
    levels = 1 + (1 if getattr(cfg, "block_remat", False) else 0)
    return (6.0 + 2.0 * levels) / 6.0
