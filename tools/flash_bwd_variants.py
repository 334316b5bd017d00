"""Time variants of the flash backward kernel's tile sizes, and an older
source of the kernel against the shipped one.

    python3 tools/flash_bwd_variants.py [reps=10] [OLD.cu]

Builds variants of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention_bwd.cu`` into ``build/variants/`` (one library each, built
in parallel with the port's flags), and ``OLD.cu`` as it is when one is
given (an earlier ``flash_attention_bwd.cu`` with the same C entry, such
as the parent commit's, unpacked by ``git archive``), and times each,
beside the shipped source, at the training and serving shapes of
``chip_smoke.py`` phase 16 (granite-8b's train and serve shapes, gemma-7b's
hd 256, seamless's cross-attention, gemma3-27b's local layers), in turns
(shipped and the others, then the same in reverse; median of ``reps``
CUDA-event timed calls of the entry, all its launches). The variants:

* ``bc32_hd128``: 32-column tiles at hd 128 (one CTA an SM: 140 KB of
  shared memory), not 16 (two);
* ``dc64_hd128``: at hd 128 each CTA accumulates 64 of the output columns
  (two CTAs a row block, each recomputing s and dP), not all 128;
* ``ring2_bc16_hd256``: at hd 256 a two-stage ring of 16-column tiles, not
  one stage of 32;
* ``kk_unroll2``, ``kk_unroll1``: the score products' k-step loop unrolled
  2 or 1 times, not 4 (fewer live fragments: the dK/dV kernel spills at
  hd 32, 64 and 256).

Prints first the registers and spill bytes that ptxas reported for each
library's ``flash_bwd_kernel`` instantiations, then one line per shape:
each source's ms per turn and whether its gradients are the shipped
kernel's bit for bit (the columns are summed in one order whatever the
tile, so the variants should be). Needs the card; the variants are
diagnostics only.
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

CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
OUT = ROOT / "build" / "variants"
BC = "  static constexpr int BC = HD <= 64 ? 64 : (HD == 128 ? 16 : 32);"
NST = "  static constexpr int NST = HD <= 128 ? 2 : 1;     // stages of the ring"
KK = "#pragma unroll 4\n    for (int kk = 0; kk < KK; ++kk) {"
DC = "  static constexpr int DC = HD <= 128 ? HD : 128;   // output columns per CTA"
VARIANTS = {
    "bc32_hd128": [(BC, "  static constexpr int BC = HD <= 64 ? 64 : 32;")],
    "dc64_hd128": [(DC, "  static constexpr int DC = HD <= 64 ? HD : "
                        "(HD == 128 ? 64 : 128);")],
    "kk_unroll2": [(KK, "#pragma unroll 2\n    for (int kk = 0; kk < KK; ++kk) {")],
    "kk_unroll1": [(KK, "#pragma unroll 1\n    for (int kk = 0; kk < KK; ++kk) {")],
    "ring2_bc16_hd256": [
        (BC, "  static constexpr int BC = HD <= 64 ? 64 : 16;"),
        (NST, "  static constexpr int NST = 2;")],
}
# (label, (B, S, T, H, K, hd), causal, window)
CASES = [("granite-train", (8, 256, 256, 32, 8, 128), True, None),
         ("granite-serve", (4, 2048, 2048, 32, 8, 128), True, None),
         ("gemma-7b-hd256", (4, 1024, 1024, 16, 16, 256), True, None),
         ("seamless-cross", (4, 700, 2048, 16, 16, 64), False, None),
         ("gemma3-local", (4, 2048, 2048, 32, 16, 128), True, 1024)]


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
    shutil.copy(CSRC / "split_tf32.cuh", OUT / "split_tf32.cuh")
    lib = build.load_library(f"flash_bwd_{name}",
                             [path, OUT / "split_tf32.cuh"])
    lib.flash_attention_bwd_f32.argtypes = \
        FK.library_bwd().flash_attention_bwd_f32.argtypes
    lib.flash_attention_bwd_f32.restype = ctypes.c_int
    return name, lib


def resources(name: str) -> dict:
    """{flash_bwd_kernel symbol: [registers, spill bytes]} from the build's
    ptxas lines (empty for a library found built)."""
    out, cur = {}, None
    for ln in build.BUILD_LOG.get(name, {}).get("ptxas", []):
        m = re.search(r"Compiling entry function '([^']*)'", ln)
        if m:
            cur = m.group(1) if "flash_bwd_kernel" in m.group(1) else None
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, [0, 0])[0] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(cur, [0, 0])[1] = int(m.group(1)) + int(m.group(2))
    return out


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
    jobs = dict(VARIANTS)
    if old:
        jobs["old"] = []
    libs = {"shipped": FK.library_bwd()}
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs.update(pool.map(
            lambda kv: variant(*kv, src=Path(old).read_text()
                               if kv[0] == "old" else None), jobs.items()))
    print(json.dumps({"ptxas_registers/spill_bytes": {
        name: resources("flash_attention_bwd" if name == "shipped"
                        else f"flash_bwd_{name}") for name in libs}}),
          flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, (B, S, T, H, K, hd), causal, window in CASES:
        gen = torch.Generator(dev).manual_seed(0)
        q, do = (torch.randn(B, S, H, hd, device=dev, generator=gen)
                 for _ in range(2))
        k, v = (torch.randn(B, T, K, hd, device=dev, generator=gen)
                for _ in range(2))
        out, lse = FK.flash_attention(q, k, v, causal=causal, window=window,
                                      return_lse=True)
        want = FK.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                      window=window)
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
                        H, K, hd, int(causal), window or 0, 0.0, stream)
                    if rc:
                        raise SystemExit(f"launch failed ({rc})")

                ms = timed(run, reps)
                same = all(torch.equal(a, b) for a, b in zip(grads, want))
                row.setdefault(name, {"ms": [], "bitwise": same})["ms"].append(
                    ms)
        print(json.dumps({"case": label, "shape": [B, S, T, H, K, hd],
                          "causal": causal, "window": window, **row}),
              flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]), *sys.argv[2:3])
