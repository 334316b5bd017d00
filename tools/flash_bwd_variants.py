"""Time variants of the flash backward kernel, and an older source of the
kernel against the shipped one.

    python3 tools/flash_bwd_variants.py [reps=10] [OLD.cu] [f32|bf16]

Builds variants of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention_bwd.cu`` into ``build/variants/`` (one library each, built
in parallel with the port's flags), and ``OLD.cu`` as it is when one is
given (an earlier ``flash_attention_bwd.cu`` with the same C entries, such
as the parent commit's, unpacked by ``git archive``), and times each,
beside the shipped source, at the eight cases of ``chip_smoke.py`` phase 16
(granite-8b's train and serve shapes, gemma-7b's hd 256 with and without a
soft-cap, gemma3-27b's local layers, seamless's cross-attention, ragged S
below and above T), in turns (shipped and the others, then the same in
reverse; ``chip_smoke.cuda_time_ms``: ``reps`` calls of the entry, all
its launches, back to back between two CUDA events after a head start).

``f32`` (the default) times the f32 entry, ``flash_attention_bwd_f32``,
with these variants of ``flash_bwd_hopper`` (hd 64, 128, 256):

* ``no_overlap``: the next tile is split after this tile's accumulating
  products have finished, not while they run (the call moved below the
  stage's release);
* ``bc64_minb1_hd64``: at hd 64 one CTA an SM with 64-row streamed tiles,
  not two with 32-row tiles.

Every sum runs in 16-deep k-steps in one order whatever the tile, so the
variants give the shipped bits; an older kernel gives them too where its
f32 kernel is the same arithmetic (each line says whether it does).

``bf16`` times the bf16 entry, ``flash_attention_bwd_bf16`` (the shipped
``flash_bwd_bf16_hopper`` at hd 64, 128, 256), with its ablations
(``BF16_VARIANTS``: without the dQ order, without dQ, without the
exponentials, without the warpgroups' barrier, each with wrong gradients,
saying what the part it drops costs; and the ticket order taking every
(b, kv head) group at once or one at a time, whatever the workspace),
against ``OLD.cu``'s,
beside bf16 ``scaled_dot_product_attention``'s backward (K and V repeated
to the query heads outside the timed call) in the same turns, and its
bound (``chip_smoke.bwd_bf16_bound``: 5 products in one bf16 pass, or
its bf16 bytes); each source's largest |difference| from the shipped
gradients, and whether the shipped kernel is bitwise the same twice. An
older bf16 kernel sums in another order, so it is not the shipped bits.

Prints first the shared memory and route of the shipped kernels by head
width and the registers and spill bytes that ptxas reported for each
library's backward kernels, then one line per case: its bounds, each
source's ms per turn and share of the bound, and each source's device ms
by launch (D, and dQ, dK/dV or the one main launch) from one profiled
call. Needs the card; the variants are diagnostics only.
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
from chip_smoke import (bwd_bf16_bound, bwd_bounds, bwd_cases,  # noqa: E402
                        bwd_ops_bytes, cuda_time_ms, sdpa_train_mask)

CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
OUT = ROOT / "build" / "variants"
BC = "  static constexpr int BC = HD == 64 ? 32 : (HD == 128 ? 64 : 16);"
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
# flash_bwd_bf16_hopper's ablations (bf16 mode): each drops one part of the
# work, so its gradients are wrong and only its time says what that part
# costs
ORDER = "    rank = khi - 1 - n;\n    count = khi - klo;\n"
EXP = "              pp[c] = fast_exp2(sc - ls[cl]);\n"
DQ_MMA = "      for (int kk = 0; kk < BN / 16; ++kk)\n        wg_ss<1, 1>(dqa,"
SYNC = "      if constexpr (!SH) consumers_sync();\n"
BF16_VARIANTS = {
    # every tile's dQ written by its own partial: no counters, no waits,
    # no workspace, no writer
    "no_dq_order": [(ORDER, "    rank = 0;\n    count = 1;\n")],
    # the same and no dQ product
    "no_dq": [(ORDER, "    rank = 0;\n    count = 1;\n"),
              (DQ_MMA, DQ_MMA.replace("kk < BN / 16", "kk < 0"))],
    # P without the exponential
    "no_exp": [(EXP, "              pp[c] = sc;\n")],
    # the warpgroups do not meet before dQ (its dS half the other's)
    "no_sync": [(SYNC, "")],
    # the ticket order key block by key block over all (b, kv head) groups
    # (right gradients; every group's dQ sums live at once)
    "n_major": [("constexpr long long L2_SUMS = 24ll << 20;",
                 "constexpr long long L2_SUMS = 1ll << 62;")],
    # one group at a time (right gradients)
    "group_major": [("constexpr long long L2_SUMS = 24ll << 20;",
                     "constexpr long long L2_SUMS = 0;")],
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
    for fn in ("flash_attention_bwd_f32", "flash_attention_bwd_bf16"):
        getattr(lib, fn).argtypes = getattr(FK.library_bwd(), fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return name, lib


def workspace_floats(lib, B, S, H, hd, bf16: bool) -> int:
    """The dsum workspace ``lib``'s entry takes: its own
    ``flash_attention_bwd_workspace`` where it has one, else D's B H S."""
    try:
        fn = lib.flash_attention_bwd_workspace
    except AttributeError:
        return B * H * S
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    return fn(B, S, H, hd, int(bf16))


def device_ms_by_kernel(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device ms of D's
    kernel and of the dQ and dK/dV launches or the one main launch
    ("not measured" if the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"flash_bwd_(?:hopper|kernel\w*)<\s*\d+,\s*(\d)", e.key)
        name = ("dsum" if "flash_bwd_dsum" in e.key else
                "main" if "flash_bwd_bf16_hopper" in e.key else
                ("DQ", "DKV")[int(m[1])] if m else None)
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if name and t:
            out[name] = out.get(name, 0.0) + float(t) / 1e3
    return out or {"device_ms": "not measured"}


def inputs(dev, B, S, T, H, K, hd, dtype):
    gen = torch.Generator(dev).manual_seed(0)
    q, do = (torch.randn(B, S, H, hd, device=dev, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, T, K, hd, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    return q, k, v, do


def sdpa_backward(dev, q, k, v, do, causal, window):
    """bf16 ``scaled_dot_product_attention``'s backward on the same values,
    K and V repeated to the query heads outside the timed call."""
    import torch.nn.functional as F
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
              .contiguous().requires_grad_(True) for t in (k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, **sdpa_train_mask(dev, S, T, causal, window))
    dt = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dt,
                                       retain_graph=True)


def main(reps: int = 10, old: str = None, mode: str = "f32") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants: needs a CUDA device")
    if mode not in ("f32", "bf16"):
        raise SystemExit(f"flash_bwd_variants: mode f32 or bf16, not {mode}")
    bf16 = mode == "bf16"
    from repro_torch.device import resolve_device
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    shipped = FK.library_bwd()
    smem = (shipped.flash_attention_bwd_bf16_smem_bytes if bf16
            else shipped.flash_attention_bwd_smem_bytes)
    print(json.dumps({"mode": mode, "shipped_smem_bytes": {
        hd: smem(hd) for hd in FK.HEAD_WIDTHS}, "route": {
        hd: FK.bwd_route(hd) for hd in FK.HEAD_WIDTHS}}), flush=True)
    jobs = dict(BF16_VARIANTS if bf16 else VARIANTS)
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
    dtype = torch.bfloat16 if bf16 else torch.float32
    for label, (B, S, T, H, K, hd), causal, window, cap in bwd_cases():
        q, k, v, do = inputs(dev, B, S, T, H, K, hd, dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        out, lse = FK.flash_attention(q, k, v, return_lse=True, **kw)
        want = FK.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        row = {}
        runs = {}
        for name, lib in libs.items():
            grads = [torch.empty_like(t) for t in (q, k, v)]
            dsum = torch.empty(workspace_floats(lib, B, S, H, hd, bf16),
                               device=dev)
            entry = (lib.flash_attention_bwd_bf16 if bf16
                     else lib.flash_attention_bwd_f32)

            def run(entry=entry, g=grads, d=dsum):
                rc = entry(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    *(t.data_ptr() for t in g), d.data_ptr(), B, S, T,
                    H, K, hd, int(causal), window or 0,
                    float(cap or 0.0), stream)
                if rc:
                    raise SystemExit(f"launch failed ({rc})")

            runs[name] = (run, grads)
        if bf16:                 # without the cap: SDPA takes none
            runs["sdpa"] = (sdpa_backward(dev, q, k, v, do, causal, window),
                            None)
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                run, grads = runs[name]
                ms = cuda_time_ms(run, reps)
                r = row.setdefault(name, {"ms": []})
                r["ms"].append(ms)
                if grads is None or "by_kernel_ms" in r:
                    continue
                r["bitwise"] = all(torch.equal(a, b)
                                   for a, b in zip(grads, want))
                r["max_abs_diff_from_shipped"] = max(
                    float((a.float() - b.float()).abs().max())
                    for a, b in zip(grads, want))
                r["by_kernel_ms"] = device_ms_by_kernel(run)
        ops, moved = bwd_ops_bytes(B, S, T, H, K, hd, causal, window,
                                   elem=2 if bf16 else 4)
        bounds = (bwd_bf16_bound(ops, moved) if bf16 else
                  bwd_bounds(ops, moved, FK.bwd_route(hd)))
        for r in row.values():
            r["share_of_bound"] = [bounds["bound_ms"] / t for t in r["ms"]]
            if not bf16:
                r["share_of_route_bound"] = [bounds["route_bound_ms"] / t
                                             for t in r["ms"]]
        if bf16:
            again = FK.flash_attention_bwd(q, k, v, out, do, lse, **kw)
            row["shipped"]["twice_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(again, want))
        print(json.dumps({"case": label, "shape": [B, S, T, H, K, hd],
                          "causal": causal, "window": window,
                          "softcap": cap, **bounds, **row}),
              flush=True)
        del q, k, v, do, out, lse, want, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]), *sys.argv[2:4])
