"""Analysis for the port: the H100 roofline (``roofline``) and the task
timeline / metrics report of observed runs (``report``).

The reference's ``hlo_parse`` reads XLA HLO text and has no counterpart in
PyTorch; it is out of scope for the port, as is the report's dry-run mode,
which reads ``repro.launch.dryrun``'s artifacts (README).
"""

from .roofline import (HBM_BYTES_PER_S, PEAK_F32_FLOPS, PEAK_TF32_FLOPS,
                       Roofline, model_flops, remat_overhead)

__all__ = ["HBM_BYTES_PER_S", "PEAK_F32_FLOPS", "PEAK_TF32_FLOPS",
           "Roofline", "model_flops", "remat_overhead"]
