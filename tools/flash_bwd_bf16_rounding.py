"""Where the bf16 flash backward kernel rounds, emulated on the CPU: over
``seeds`` draws of each attention case of tests/test_torch_train_bf16.py,
the largest ratio, for each of dq, dk and dv, of the emulated kernel's RMS
distance from the plain bf16 backward to the plain version's own distance
from the plain f32 backward (the card's rule holds it to 2), as the kernel
computes (dP in f32) and with dP rounded to bf16 where the plain version's
autograd rounds the gradient that reaches P through its bf16 cast.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/flash_bwd_bf16_rounding.py [seeds]

Prints one JSON line per case. Needs the reference package's dependencies
(the test module imports JAX); nothing runs on a card.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import test_torch_train_bf16 as T  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)


def main(seeds: int = 20) -> None:
    torch.set_num_threads(1)
    for case in sorted(T.ATTN_CASES):
        causal, window, softcap = T.ATTN_CASES[case][6:9]
        kw = dict(causal=causal, window=window, softcap=softcap)
        worst = {rd: [0.0] * 3 for rd in (False, True)}
        for seed in range(seeds):
            q, k, v, dout = (T.bf16_pair(a)[1]
                             for a in T.attention_inputs(case, 10 + seed))
            out = flash_attention_ref(q, k, v, **kw)
            lse = flash_attention_lse_ref(q, k, **kw)
            p16 = [T.as_f32(g) for g in flash_attention_bwd_ref(
                q, k, v, dout, **kw)]
            p32 = [T.as_f32(g) for g in flash_attention_bwd_ref(
                *(t.float() for t in (q, k, v, dout)), **kw)]
            for rd in worst:
                got = T.kernel_bwd_emulated(q, k, v, out, dout, lse,
                                            round_dp=rd, **kw)
                for i, (g, a, b) in enumerate(zip(got, p16, p32)):
                    ratio = (T.rms_share(T.as_f32(g), a, b)
                             / T.rms_share(a, b, b))
                    worst[rd][i] = max(worst[rd][i], ratio)
        print(json.dumps({"case": case, "seeds": seeds,
                          "max_ratio_dq_dk_dv_dp_f32": worst[False],
                          "max_ratio_dq_dk_dv_dp_rounded": worst[True]}),
              flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
