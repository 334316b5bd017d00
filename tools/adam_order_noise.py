"""How far two correct f32 trainings of a reduced Mamba-kind model drift
apart when only the order of the scans' sums differs (CPU, seconds).

    PYTHONPATH=src python tools/adam_order_noise.py [seeds] [steps]

For zamba2-1.2b and falcon-mamba-7b reduced (the launcher's AdamW: 3e-4, 10
warmup steps; batch 4 × 40, as ``chip_smoke.py`` phase 18), from the same
parameters and batches drawn from each seed, two CPU runs: the scans under
PyTorch's autograd of the plain forwards (the CPU path of the ops), and the
scans through the autograd functions that carry the kernels on the card
(``SelectiveScanF32``, ``SsdScan``) with the plain backwards (the same
gradients, summed in another order). Prints, after each step, the largest
difference of each group of leaves over its own scale (max |a − b| over
max |b|, as phase 18 measures): the leaves the model initialises at zero
(zamba2's conv biases, dt biases and LoRA up-projections: Adam's first
steps put an element at ±lr by the sign of its gradient, so where a
gradient is near zero the last digits of the parameter follow the order of
the sums), the other leaves, and the first step's first moments (0.1 ×
the clipped gradients, and the second moments), and the moments of the
leaves initialised at zero after each step: free-running, and with each
step taken through the functions from the plain run's state before it
(what ``chip_smoke.py`` phase 18 and the card tests hold those leaves by:
the moments then differ by that step's gradients alone). One PyTorch
thread.
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mamba_scan import SelectiveScanF32  # noqa: E402
from repro_torch.kernels.ssd_scan import SsdScan  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models.convert import (leaves, tree_map,  # noqa: E402
                                        zero_leaves)
from repro_torch.train import (AdamConfig, DataConfig, TokenStream,  # noqa
                               TrainConfig, adam_init, make_train_step)


def rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def through_functions(u, dt, A, Bm, Cm, D, *, chunk=None, h0=None):
    args = [t.contiguous() for t in (u, dt, A, Bm, Cm, D)]
    if u.dim() == 4:
        return SsdScan.apply(*args, h0, chunk)
    return SelectiveScanF32.apply(*args, h0)


def run(cfg, tcfg, base, stream, steps, functions: bool, starts=None):
    """``steps`` train steps from ``base``, or each step from a copy of
    its state in ``starts``; returns each step's parameters and moments
    (mu leaves, then nu leaves) and the state before each step."""
    plain = (M.selective_scan_op, M.ssd_scan_op)
    if functions:
        M.selective_scan_op = M.ssd_scan_op = through_functions
    try:
        params = tree_map(lambda t: t.clone(), base)
        opt = adam_init(params)
        step = make_train_step(cfg, tcfg)
        out, moments, before = [], [], []
        for s in range(steps):
            if starts is not None:
                params, opt = tree_map(lambda t: t.detach().clone(),
                                       starts[s])
            before.append(tree_map(lambda t: t.detach().clone(),
                                   (params, opt)))
            params, opt, _ = step(params, opt, stream.batch(s))
            out.append([t.detach().clone() for t in leaves(params)])
            moments.append([t.clone() for t in leaves(opt.mu)]
                           + [t.clone() for t in leaves(opt.nu)])
        return out, moments, before
    finally:
        M.selective_scan_op, M.ssd_scan_op = plain


def main(seeds: int = 4, steps: int = 3) -> None:
    torch.set_num_threads(1)
    tcfg = TrainConfig(adam=AdamConfig(lr=3e-4, warmup_steps=10,
                                       total_steps=100))
    for arch in ("zamba2-1.2b", "falcon-mamba-7b"):
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype=torch.float32)
        for seed in range(seeds):
            base = init_params(cfg, torch.Generator().manual_seed(seed))
            zero = zero_leaves(base)
            stream = TokenStream(DataConfig(vocab=cfg.vocab, seq=40, batch=4,
                                            seed=seed))
            (pa, ma, before), (pb, mb, _) = (
                run(cfg, tcfg, base, stream, steps, f) for f in (False, True))
            # each step again through the functions, from the plain run's
            # state before it: the moments then differ by that step's
            # gradients alone
            _, mf, _ = run(cfg, tcfg, base, stream, steps, True, before)
            rows = []
            for s in range(steps):
                diffs = [rel(b, a) for a, b in zip(pa[s], pb[s])]
                rows.append((max((d for d, z in zip(diffs, zero) if z),
                                 default=0.0),
                             max(d for d, z in zip(diffs, zero) if not z)))

            def zero_moments(got, want):
                return max((rel(b, a) for a, b, z in zip(want, got,
                                                         zero + zero)
                            if z), default=0.0)

            mu = max(rel(b, a) for a, b, z in zip(ma[0], mb[0], zero + zero)
                     if a.abs().max() > 0)
            print(f"{arch} seed {seed}: zero-initialised leaves "
                  f"{[f'{z:.3g}' for z, _ in rows]}, other leaves "
                  f"{[f'{o:.3g}' for _, o in rows]} (steps 1..{steps}); "
                  f"step 1's moments {mu:.3g}; the zero-initialised leaves' "
                  f"moments after each step, free-running "
                  f"{[f'{zero_moments(b, a):.3g}' for a, b in zip(ma, mb)]}, "
                  f"each step from the same state "
                  f"{[f'{zero_moments(b, a):.3g}' for a, b in zip(ma, mf)]}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
