"""What bounds flash_attention and force_pair: time variants of their sources.

    python3 tools/kernel_variants.py [reps=10]

Builds variants of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu`` and ``src/repro_torch/kernels/sph_pair/csrc/
sph_pair.cu`` into ``build/variants/`` (one ``nvcc`` each, in parallel, with
the port's flags) and times each at its main-path shape on the CUDA device,
in turns (the shipped source and each variant, then the same in reverse
order; median of ``reps`` CUDA-event timed launches per turn):

* attention at the zamba2-1.2b prefill shape (B 4, S = T = 2048, 32 heads,
  hd 64, causal): ``expf`` (the accurate base-e exponential in place of
  the base-2 softmax's ``exp2f``), ``uncapped`` (registers not held to 168,
  so two CTAs an SM, not three), ``single_tf32`` (one TF32 product in place
  of the three-product split: what the split costs; not accurate enough to
  ship);
* force at the full Sedov 64³ pair list (P = 307,328, C = 40, α = 1):
  ``every_element`` (the full element for every live partner, as if all
  were within reach: what the cutoff pass saves), ``uncapped`` (registers
  not held to 64, so seven CTAs an SM, not eight).

Prints one JSON line per variant (its ms per turn, registers, and its
largest difference from the shipped kernel's output), after the card line.
The variants are diagnostics only; the port ships the sources as they are.
Stops without a CUDA device.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import card_line, qkv_inputs, sedov_setup  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
KDIR = os.path.join(ROOT, "src", "repro_torch", "kernels")
FLASH = os.path.join(KDIR, "flash_attention", "csrc", "flash_attention.cu")
PAIR = os.path.join(KDIR, "sph_pair", "csrc", "sph_pair.cu")

VARIANTS = {
    "flash_attention": (FLASH, {
        "expf": [("float x = s[n][2 * r + c] * scale2;",
                  "float x = s[n][2 * r + c] * scale;"),
                 ("alpha = exp2f(m[r] - m_new);",
                  "alpha = expf(m[r] - m_new);"),
                 ("const float p = exp2f(s[n][2 * r + c] - m_new);",
                  "const float p = expf(s[n][2 * r + c] - m_new);")],
        "uncapped": [("__global__ void __launch_bounds__(NT, 3)\n",
                      "__global__ void __launch_bounds__(NT)\n")],
        "single_tf32": [("  mma(d, as, bb0, bb1);\n  mma(d, ab, bs0, bs1);\n",
                         "")],
    }),
    "force_pair": (PAIR, {
        "every_element": [
            ("if (r2 > kEps && r2 + kEps < (hm * hm) * 1.000001f) hit |= 1u << k;",
             "hit |= 1u << k;")],
        "uncapped": [
            ("__launch_bounds__(kThreads, 8) force_pair_kernel",
             "__launch_bounds__(kThreads) force_pair_kernel")],
    }),
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(name, src, edits):
    text = open(src).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: pattern not in the source: {old!r}")
        text = text.replace(old, new)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib{name}.so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    regs = [ln.split("Used ")[1].split(",")[0]
            for ln in (proc.stdout + proc.stderr).splitlines()
            if "Used" in ln and "registers" in ln]
    return name, lib, regs


def flash_caller(lib):
    lib.flash_attention_f32.argtypes = [_P] * 4 + [_I] * 8 + [_P]
    B, S, H, hd = 4, 2048, 32, 64
    q, k, v = qkv_inputs(B, S, S, H, H, hd, "cuda")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.flash_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), B, S, S, H, H, hd, 1, 0,
                                     stream)
        assert rc == 0, rc
        return [o]
    return run


def force_caller(lib, args):
    lib.sph_force_pair.argtypes = [_P] * 22 + [_I, _I, _I] + [_F] * 3 + [_P]
    P, C = args[0].shape[:2]
    kw = dict(dtype=torch.float32, device="cuda")
    outs = [torch.empty((P, C, 3), **kw), torch.empty((P, C), **kw),
            torch.empty((P, C, 3), **kw), torch.empty((P, C), **kw)]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.sph_force_pair(*(t.data_ptr() for t in list(args) + outs),
                                P, C, 0, 1.0, -1.0, 2.0, stream)
        assert rc == 0, rc
        return outs
    return run


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def main(reps: int = 10) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    jobs = [(f"{kern}_{v}", src, edits)
            for kern, (src, vs) in VARIANTS.items()
            for v, edits in [("shipped", [])] + list(vs.items())]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    print(card_line(), flush=True)
    from repro_torch.kernels.sph_pair import ops
    spec, cells, pairs, thermo = sedov_setup("cuda")
    force_in = ops.force_inputs(cells, pairs, *thermo)
    for kern in VARIANTS:
        mine = [(n, lib, regs) for n, lib, regs in built
                if n.startswith(kern)]
        runs = {}
        for n, lib, _ in mine:
            cl = ctypes.CDLL(lib)
            runs[n] = (flash_caller(cl) if kern == "flash_attention"
                       else force_caller(cl, force_in))
        ref = [t.clone() for t in runs[f"{kern}_shipped"]()]
        turns = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                turns[n].append(time_ms(runs[n], reps))
        for n, _, regs in mine:
            got = runs[n]()
            diff = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            print(json.dumps({"variant": n, "ms": turns[n], "registers": regs,
                              "max_abs_diff_vs_shipped": diff}), flush=True)
        del runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
