"""What bounds the selective-scan kernel: time variants of its source.

    python3 tools/scan_variants.py [reps=20]

Builds variants of ``src/repro_torch/kernels/mamba_scan/csrc/
selective_scan.cu`` into ``build/variants/`` (one ``nvcc`` each, in
parallel, with the port's flags) and times each at the falcon-mamba-7b
prefill shape (B 4, S 2048, dI 8192, N 16) on the CUDA device, in turns
(each variant, then each again in reverse order; median of ``reps``
CUDA-event timed launches per turn), beside the shipped source:

* ``fast_expf``: ``__expf`` in place of the accurate ``expf``;
* ``spt8``: 8 states a thread (2 lanes a channel, not 4);
* ``spt16``: 16 states a thread (one lane a channel).

Prints one JSON line per variant (its ms per turn, registers, and its
largest error against the plain version), after the card line. The
variants are diagnostics only; the port ships the source as it is. Stops
without a CUDA device.
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

from chip_smoke import card_line, scan_inputs  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as MK  # noqa: E402
from repro_torch.kernels.mamba_scan import selective_scan_ref  # noqa: E402

SHAPE = (4, 2048, 8192, 16)
OUT = os.path.join(ROOT, "build", "variants")

FLOAT4 = """      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][r][g * SPT]);
      const float4 cv = *reinterpret_cast<const float4*>(&Cs[buf][r][g * SPT]);
      const float bn[SPT] = {bv.x, bv.y, bv.z, bv.w};
      const float cn[SPT] = {cv.x, cv.y, cv.z, cv.w};"""
SCALAR = """      float bn[SPT], cn[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        bn[j] = Bs[buf][r][g * SPT + j];
        cn[j] = Cs[buf][r][g * SPT + j];
      }"""
SMALL_N = """    case 4:
      return (int)launch<4>(u, dt, A, Bm, Cm, D, h0, y, hout, B, S, dI, st);
    case 8:
      return (int)launch<8>(u, dt, A, Bm, Cm, D, h0, y, hout, B, S, dI, st);
"""


def edit(src: str, pairs) -> str:
    for a, b in pairs:
        if a not in src:
            raise SystemExit(f"scan_variants: the source no longer has {a!r}")
        src = src.replace(a, b)
    return src


def variants(src: str) -> dict:
    def spt(n):   # n states a thread; only N = 16 instantiated
        return edit(src, [("constexpr int SPT = 4;",
                           f"constexpr int SPT = {n};"),
                          (FLOAT4, SCALAR), (SMALL_N, "")])
    return {"shipped": src,
            "fast_expf": edit(src, [("expf(dtt * a[j])",
                                     "__expf(dtt * a[j])")]),
            "spt8": spt(8), "spt16": spt(16)}


def build(name: str, src: str):
    cu = os.path.join(OUT, f"{name}.cu")
    so = os.path.join(OUT, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so, cu],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}")
    lines = proc.stdout.splitlines()
    at = next(i for i, ln in enumerate(lines)
              if "Compiling entry" in ln and "ILi16E" in ln)   # N = 16
    regs = next(ln.strip() for ln in lines[at:] if "registers" in ln)
    lib = ctypes.CDLL(so)
    lib.selective_scan_f32.argtypes = ([ctypes.c_void_p] * 9
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
    return lib, regs


def main(reps: int = 20) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: needs a CUDA device")
    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    with open(MK.SOURCES[0]) as f:
        srcs = variants(f.read())
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(lambda kv: build(*kv), srcs.items())))
    B, S, dI, N = SHAPE
    args = scan_inputs(*SHAPE, dev)
    y_ref, h_ref = selective_scan_ref(*args)
    y = torch.empty_like(args[0])
    h = torch.empty((B, dI, N), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib):
        rc = lib.selective_scan_f32(*(a.data_ptr() for a in args), None,
                                    y.data_ptr(), h.data_ptr(), B, S, dI, N,
                                    stream)
        if rc != 0:
            raise SystemExit(f"scan_variants: launch failed ({rc})")

    def timed(lib):
        run(lib)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(lib)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    print(card_line(), flush=True)
    ms = {name: [] for name in built}
    for name in list(built) + list(built)[::-1]:
        ms[name].append(timed(built[name][0]))
    for name, (lib, regs) in built.items():
        run(lib)
        torch.cuda.synchronize()
        print(json.dumps({
            "variant": name, "shape": list(SHAPE), "ms": ms[name],
            "registers": regs,
            "max_abs_err_y": float((y - y_ref).abs().max()),
            "max_abs_err_h": float((h - h_ref).abs().max())}), flush=True)


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:2]])
