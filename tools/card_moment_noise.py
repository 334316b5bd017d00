"""How far one train step on the card lands Adam's moments from the CPU's,
when both start from the same state: for a reduced zamba2-1.2b (the
launcher's AdamW: 3e-4, 10 warmup steps; batch 4 × 40, seed 0, as
``chip_smoke.py`` phase 18).

    PYTHONPATH=src python tools/card_moment_noise.py

Three CPU steps on one PyTorch thread, keeping the state before each step
and the moments after it; then each step again on the card from the CPU's
state before it, twice: the scans through their kernels (the card's path),
and the scans replaced by their plain versions (``ssd_scan_ref`` under
PyTorch's autograd, on CUDA tensors; the shared attention still through
the flash kernels). Prints, for each, the leaves whose first (mu) or
second (nu) moments land furthest from the CPU's, as max |a − b| over max
|b| of the leaf: those the model initialises at zero (``zero_leaves``),
then the others. A first moment differs by 0.1 × that step's clipped
gradients alone; a second moment, their square, doubles their relative
error. Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_ref  # noqa: E402
from repro_torch.launch.train import FrontendStream  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models.convert import (leaves, tree_map,  # noqa: E402
                                        zero_leaves)
from repro_torch.train import (AdamConfig, DataConfig, TokenStream,  # noqa
                               TrainConfig, adam_init, make_train_step)


def names(t, pre=""):
    """Each leaf's path, in ``leaves`` order."""
    if isinstance(t, dict):
        for k, v in t.items():
            yield from names(v, f"{pre}.{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from names(v, f"{pre}[{i}]")
    else:
        yield pre


def rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def plain_ssd(u, dt, A, Bm, Cm, D, *, chunk=None, h0=None):
    return ssd_scan_ref(u, dt, A, Bm, Cm, D, chunk=chunk or SK.KERNEL_CHUNK,
                        h0=h0)


def main(steps: int = 3, top: int = 4) -> None:
    dev = torch.device("cuda")
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda build: build(), (
            SK.library, SK.library_bwd, FK.library, FK.library_bwd)))
    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True),
                              dtype=torch.float32)
    tcfg = TrainConfig(adam=AdamConfig(lr=3e-4, warmup_steps=10,
                                       total_steps=100))
    stream = FrontendStream(TokenStream(DataConfig(vocab=cfg.vocab, seq=40,
                                                   batch=4)), cfg)
    base = init_params(cfg, torch.Generator().manual_seed(0))
    zero, path = zero_leaves(base), list(names(base))
    step = make_train_step(cfg, tcfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    params = tree_map(lambda t: t.clone(), base)
    opt = adam_init(params)
    states, moments = [], []
    for s in range(steps):
        states.append(tree_map(lambda t: t.detach().clone(), (params, opt)))
        params, opt, _ = step(params, opt, stream.batch(s))
        moments.append(([t.clone() for t in leaves(opt.mu)],
                        [t.clone() for t in leaves(opt.nu)]))
    torch.set_num_threads(threads)
    for label, op in (("kernels", None), ("plain scans", plain_ssd)):
        saved = M.ssd_scan_op
        if op is not None:
            M.ssd_scan_op = op
        rows = []
        try:
            for s, state in enumerate(states):
                o = step(*tree_map(lambda t: t.clone().to(dev), state),
                         stream.batch(s))[1]
                for i, (a, b) in enumerate(zip(leaves(o.mu), leaves(o.nu))):
                    rows.append((rel(a, moments[s][0][i]),
                                 rel(b, moments[s][1][i]), s, path[i],
                                 zero[i]))
        finally:
            M.ssd_scan_op = saved
        for group, rs in (("zero-initialised", [r for r in rows if r[4]]),
                          ("other", [r for r in rows if not r[4]])):
            for key, by in ((0, "mu"), (1, "nu")):
                print(f"{label}: {group} leaves, by {by}:")
                for r in sorted(rs, key=lambda r: -r[key])[:top]:
                    print(f"  mu {r[0]:.3e}  nu {r[1]:.3e}  step {r[2]}  "
                          f"{r[3]}")


if __name__ == "__main__":
    main()
