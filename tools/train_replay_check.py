"""Exercise ``chip_smoke.train_steps``' answer to a trace that disagrees
with the launch counters: every trace is made to disagree (a forced fault
is added to what ``trace_faults`` finds), so each model's phase-17 run
re-profiles one more step and then replays every step unprofiled from a
fresh draw, which must be bit for bit the profiled run.

    PYTHONPATH=src python tools/train_replay_check.py

Runs mixtral-8x22b (1 layer) and mixtral-8x7b (2) and zamba2-1.2b (38) in
f32 and granite-8b (24) in bf16 at phase 17's shape, and prints for each
the faults of the first and the second profile, whether the unprofiled
replay was bitwise and whether the first step was bitwise twice. Needs a
CUDA card with 80 GB.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as MK  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402

RUNS = (("mixtral-8x22b", 1, torch.float32),
        ("mixtral-8x7b", 2, torch.float32),
        ("zamba2-1.2b", 38, torch.float32),
        ("granite-8b", 24, torch.bfloat16))


def main() -> None:
    dev = torch.device("cuda")
    builds = [mod.library for mod, _ in C.lm_kernel_modules().values()]
    builds += [FK.library_bwd, MK.library_bwd, SK.library_bwd]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda build: build(), builds))
    found = C.trace_faults
    C.trace_faults = lambda *a: found(*a) + [("forced", 0, 1)]
    for arch, n_layers, dtype in RUNS:
        line, _ = C.train_steps(dev, C.train_cfg(arch, n_layers,
                                                 dtype=dtype),
                                C.train_tcfg(), 0)
        print("REPLAY", arch, line["trace_faults_first_profile"],
              line["trace_faults"], line["unprofiled_replay_bitwise_equal"],
              line["step_twice_bitwise_equal"], flush=True)


if __name__ == "__main__":
    main()
