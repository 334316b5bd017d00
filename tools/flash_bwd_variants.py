"""Time variants of the flash backward kernel, and an older source of the
kernel against the shipped one.

    python3 tools/flash_bwd_variants.py [reps=10] [OLD.cu]

Builds variants of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention_bwd.cu`` into ``build/variants/`` (one library each, built
in parallel with the port's flags), and ``OLD.cu`` as it is when one is
given (an earlier ``flash_attention_bwd.cu`` with the same C entry, such
as the parent commit's, unpacked by ``git archive``), and times each,
beside the shipped source, at the eight cases of ``chip_smoke.py`` phase 16
(granite-8b's train and serve shapes, gemma-7b's hd 256 with and without a
soft-cap, gemma3-27b's local layers, seamless's cross-attention, ragged S
below and above T), in turns (shipped and the others, then the same in
reverse; median of ``reps`` CUDA-event timed calls of the entry, all its
launches). The variants, all of ``flash_bwd_hopper`` (hd 64, 128, 256):

* ``no_overlap``: the next tile is split after this tile's accumulating
  products have finished, not while they run (the call moved below the
  stage's release);
* ``bc64_minb1_hd64``: at hd 64 one CTA an SM with 64-row streamed tiles,
  not two with 32-row tiles.

Prints first the shared memory and route of the shipped kernels by head
width and the registers and spill bytes that ptxas reported for each
library's ``flash_bwd_hopper`` and ``flash_bwd_kernel`` instantiations,
then one line per case: its two bounds (``chip_smoke.bwd_bounds``: 5
products a live pair in 3×TF32, and in the arithmetic of the route that
serves the width), each source's ms per turn, its shares of both bounds and
whether its gradients are the shipped kernel's bit for bit, and the shipped
source's device ms by launch (D, dQ, dK/dV) from one profiled call. Every sum runs
in 16-deep k-steps in one order whatever the tile, so the variants give
the shipped bits; an older kernel does not. Needs the card; the variants
are diagnostics only.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402

sys.path.insert(0, str(ROOT))
from chip_smoke import bwd_bounds, bwd_cases, bwd_ops_bytes  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
OUT = ROOT / "build" / "variants"
BC = ("  static constexpr int BC = HD == 64 ? (BF ? 64 : 32) : (HD == 128 ? 64 "
      ": 16);")
MINB = "  static constexpr int MINB = HD == 64 ? 2 : 1;"
SPLIT = "      if (it + 1 < n_it) split_tile(it + 1);\n"
WAIT = "      wgmma_wait<0>();\n      pin(acc);\n"
READ = "      if (lane == 0) mbar_arrive(empty(s));   // this stage is read\n"
VARIANTS = {
    "no_overlap": [(SPLIT + WAIT, WAIT), (READ, READ + SPLIT)],
    "bc64_minb1_hd64": [
        (BC, "  static constexpr int BC = HD <= 128 ? 64 : 16;"),
        (MINB, "  static constexpr int MINB = 1;")],
}


def variant(name, edits, src=None):
    src = src or (CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"flash_bwd_variants: the source no longer has "
                             f"{old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"flash_attention_bwd_{name}.cu"
    path.write_text(src)
    heads = [CSRC / "split_tf32.cuh", CSRC / "bf16_mma.cuh",
             CSRC.parents[1] / "hopper.cuh"]
    for h in heads:
        shutil.copy(h, OUT / h.name)
    lib = build.load_library(f"flash_bwd_{name}",
                             [path, *(OUT / h.name for h in heads)])
    lib.flash_attention_bwd_f32.argtypes = \
        FK.library_bwd().flash_attention_bwd_f32.argtypes
    lib.flash_attention_bwd_f32.restype = ctypes.c_int
    return name, lib


def device_ms_by_kernel(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device ms of D's
    kernel and of the dQ and dK/dV launches ("not measured" if the
    profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"flash_bwd_\w+<\s*\d+,\s*(\d)", e.key)
        name = "dsum" if "flash_bwd_dsum" in e.key else (
            ("DQ", "DKV")[int(m[1])] if m else None)
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if name and t:
            out[name] = out.get(name, 0.0) + float(t) / 1e3
    return out or {"device_ms": "not measured"}


def timed(fn, reps: int) -> float:
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


def main(reps: int = 10, old: str = None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants: needs a CUDA device")
    from repro_torch.device import resolve_device
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    shipped = FK.library_bwd()
    print(json.dumps({"shipped_smem_bytes": {
        hd: shipped.flash_attention_bwd_smem_bytes(hd)
        for hd in FK.HEAD_WIDTHS}, "route": {
        hd: FK.bwd_route(hd) for hd in FK.HEAD_WIDTHS}}), flush=True)
    jobs = dict(VARIANTS)
    if old:
        jobs["old"] = []
    jobs["shipped"] = []           # built afresh: its ptxas lines
    libs = {}
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs.update(pool.map(
            lambda kv: variant(*kv, src=Path(old).read_text()
                               if kv[0] == "old" else None), jobs.items()))
    libs = {"shipped": libs.pop("shipped"), **libs}
    for name in libs:
        print(json.dumps({"ptxas_registers/spill_bytes": name,
                          **FK.bwd_resources(f"flash_bwd_{name}")}),
              flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, (B, S, T, H, K, hd), causal, window, cap in bwd_cases():
        gen = torch.Generator(dev).manual_seed(0)
        q, do = (torch.randn(B, S, H, hd, device=dev, generator=gen)
                 for _ in range(2))
        k, v = (torch.randn(B, T, K, hd, device=dev, generator=gen)
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=cap)
        out, lse = FK.flash_attention(q, k, v, return_lse=True, **kw)
        want = FK.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        row = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                grads = [torch.empty_like(t) for t in (q, k, v)]
                dsum = torch.empty(B, H, S, device=dev)

                def run(lib=libs[name], g=grads, d=dsum):
                    rc = lib.flash_attention_bwd_f32(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        *(t.data_ptr() for t in g), d.data_ptr(), B, S, T,
                        H, K, hd, int(causal), window or 0,
                        float(cap or 0.0), stream)
                    if rc:
                        raise SystemExit(f"launch failed ({rc})")

                ms = timed(run, reps)
                same = all(torch.equal(a, b) for a, b in zip(grads, want))
                row.setdefault(name, {"ms": [], "bitwise": same})["ms"].append(
                    ms)
                if name == "shipped" and "by_kernel_ms" not in row[name]:
                    row[name]["by_kernel_ms"] = device_ms_by_kernel(run)
        bounds = bwd_bounds(*bwd_ops_bytes(B, S, T, H, K, hd, causal, window),
                            FK.bwd_route(hd))
        for r in row.values():
            r["share_of_bound"] = [bounds["bound_ms"] / t for t in r["ms"]]
            r["share_of_route_bound"] = [bounds["route_bound_ms"] / t
                                         for t in r["ms"]]
        print(json.dumps({"case": label, "shape": [B, S, T, H, K, hd],
                          "causal": causal, "window": window,
                          "softcap": cap, **bounds, **row}),
              flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]), *sys.argv[2:3])
