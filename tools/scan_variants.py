"""What bounds the two scan kernels: time variants of their sources.

    python3 tools/scan_variants.py [reps=20] [selective_scan|ssd_scan]
    python3 tools/scan_variants.py [reps=20] ssd_scan_bf16 [OLD.cu]
    python3 tools/scan_variants.py [reps=20] selective_scan_bf16 [OLD.cu]
    python3 tools/scan_variants.py [reps=20] selective_scan_bwd [OLD.cu]
    python3 tools/scan_variants.py [reps=20] ssd_scan_bwd [OLD.cu]
    python3 tools/scan_variants.py [reps=20] ssd_scan_bwd_bf16 [OLD.cu]

Builds variants of ``src/repro_torch/kernels/mamba_scan/csrc/
selective_scan.cu`` and ``src/repro_torch/kernels/ssd_scan/csrc/
ssd_scan.cu`` into ``build/variants/`` (one ``nvcc`` each, in parallel,
with the port's flags) and times each at its main-path shape on the CUDA
device, in turns (the shipped source and each variant, then the same in
reverse order; median of ``reps`` CUDA-event timed launches per turn); a
second argument names one kernel:

* the selective scan at the falcon-mamba-7b prefill shape (B 4, S 2048,
  dI 8192, N 16): ``expf`` (the accurate base-e exponential in place of
  one ``ex2.approx`` of dt·A·log2 e), ``lanes4``, ``lanes8``, ``lanes1``
  (4, 8 or 1 lanes a channel, in place of 2: four, two or sixteen states a
  lane), ``uncapped`` (registers not held to 128 by
  ``__launch_bounds__(128, 4)``, so fewer than 4 CTAs an SM if ptxas
  takes more);
* the SSD scan at the zamba2-1.2b prefill shape (B 4, S 2048, 64 heads,
  hp = N = 64): ``cvt_rna`` (big and small each rounded to TF32 by
  ``cvt.rna.tf32.f32``, as the kernel first did, in place of big cut by a
  mask and small passed as it is), ``every_block`` (every warp computes C·Bᵀ and M·u over
  all eight 8-step blocks of the chunk, masked, not only those at or below
  its diagonal), ``eight_warps`` (eight warps a CTA, two on each 16 rows of
  a chunk, each on half the columns, registers held to 128; in place of
  four, one on each 16 rows), ``single_tf32`` (one TF32 product in place of the
  three-product split: what the split costs; not accurate enough to ship),
  ``split_per_warp`` (the state kept in shared memory in f32 and split by
  every warp at each use, in place of once a chunk for the CTA),
  ``one_cta`` (shared memory asked for so that one CTA runs an SM, not
  two).

``ssd_scan_bf16`` times the bf16 entry's Hopper kernel (``ssd_bf16_hopper``,
N = hp = 64) at the zamba2-1.2b prefill shape and at batch 1 (64 CTAs for
132 SMs), in turns as above, beside OLD (an older ``ssd_scan.cu``, for
example the parent commit's: ``git show HEAD~1:src/repro_torch/kernels/
ssd_scan/csrc/ssd_scan.cu > build/parent/ssd_scan.cu``) and these variants:
``one_stage`` (a ring of one chunk stage: the next chunk's loads wait for
this one's release), ``three_pieces`` (each f32 operand in three bf16
pieces, not two), ``maxnreg200`` (``__maxnreg__(200)`` in place of the
shipped ``__launch_bounds__(NT, 2)``, under which ptxas stops at 168
registers and spills 8 bytes), and the diagnostics ``no_exp`` (M without its decay
exponentials: wrong results, what the exponentials cost), ``exp2f`` (those
exponentials by ``exp2f``, as the f32 entry takes them, in place of
``ex2.approx.ftz``), and what a chunk's steps cost, each left out (wrong
results): ``no_wu`` (w·u's pieces not written), ``no_m`` (M not formed:
zeros), ``no_state_pieces`` (the state's pieces not written for the next
chunk), ``no_y_store`` (y not stored). Each line also carries the
kernel's dynamic shared memory; a variant that does not build (ptxas of
CUDA 12.9 crashes on some edits of that kernel) is reported as such and
left out.

``selective_scan_bf16`` times the Mamba-1 scan's bf16 entry
(``selective_scan_bf16_hopper``) at the falcon-mamba-7b prefill shape, in
turns as above, beside the f32 entry of the shipped source on the same
values widened, OLD's bf16 entry (an older ``selective_scan.cu`` with the
same C entry, for example the parent commit's: ``git show
HEAD~1:src/repro_torch/kernels/mamba_scan/csrc/selective_scan.cu >
build/parent/selective_scan.cu``) and these variants, each an edit of the
bf16 kernel alone: ``stages3``, ``stages5`` (a ring of 3 or 5 tiles, not
4: copies 2 or 4 tiles ahead, not 3; B and C are widened one tile ahead,
so a ring of 2 is not built), ``tt32``, ``tt32_stages3`` (tiles of 32
steps, not 16, in a ring of 4 or 3), ``ctas3`` (registers held to 168,
not 128: 3 CTAs an SM by the cap, so the falcon grid's 512 CTAs need a
second wave), ``not_ahead`` (each step's operands
read from shared memory in the step, not one step ahead),
``cta_barrier`` (the CTA waits for all its partials before y's epilogue,
not each warp for its own), ``y16`` (y's epilogue by eight
channels a thread, one 16-byte store each, not four and 8 bytes), ``bc_at_use`` (B and C widened from
their bf16 copies in every step, two 16-bit ops a state, not read from
the tile widened once a tile), and the diagnostics ``no_exp``
(the exponential a constant, so dt·A goes too: wrong results, how far the
kernel is from its data movement alone), ``no_copies`` (no copies after the
prologue's), ``no_epilogue`` (y not formed or stored), ``no_barrier`` (no
CTA barrier a tile: the copies race), ``no_widen`` (bf16 values used
as their raw words, not shifted or masked: wrong results, what widening
costs) and ``poly_exp`` (every fourth state's exponential by a Cody–Waite
split and a degree-6 polynomial on the FMA pipe, flushed to 0 below
2^-126 as ``ex2.approx.ftz`` is: not bitwise the f32 entry, so not
shipped; held to the plain version as the shipped kernel is). The cp.async
ring is the only load route written (no TMA variant). Each line carries
the kernel's registers, spills, shared memory (dynamic, or for OLD
static) and CTAs an SM, its largest errors against the plain version and
whether they are within its tolerance (y within one bf16 rounding plus
2e-4 of the scale, h within 2e-4); the shipped line also whether it is
the f32 entry bit for bit. Then, with OLD, the f32 entry of the shipped
source and of OLD on the same f32 inputs, bitwise.

``selective_scan_bwd`` and ``ssd_scan_bwd`` time the scans' backward
kernels (``csrc/selective_scan_bwd.cu``, ``csrc/ssd_scan_bwd.cu``) at
chip_smoke.py phase 16b's three cases each (``scan_bwd_cases``: the train
shape, a ragged S with h0 and dh, the reduced widths), in turns as above,
beside OLD (an older source with the same C entry, for example the parent
commit's: ``git show HEAD~1:src/repro_torch/kernels/mamba_scan/csrc/
selective_scan_bwd.cu > build/parent/selective_scan_bwd.cu``) and variants
that isolate the design's choices. Selective: ``tb8`` (chunks of 8 steps
in place of 4: half the scratch, twice the factors held in registers),
``states_in_registers`` (the states entering a chunk's steps in registers
in place of shared memory), ``ctas2``, ``ctas3`` (registers held to
255 or 168 in place of 128: two or three CTAs an SM by the cap),
``stages2``, ``stages6`` (a ring of 2 or 6 chunk stages in place of 4:
loads 1 or 5 chunks ahead in place of 3). SSD: ``single_tf32`` (one TF32 product
in place of three: what the split costs; not accurate enough to ship),
``one_cta`` (shared memory asked for so that one CTA of the chunk kernel
runs an SM, not two), and the diagnostic ``states_only`` (the first
kernel alone, the chunks' states and adjoints: wrong results, what it
costs). Each line carries every kernel's registers and
spills, its shared memory and CTAs an SM (the occupancy calculator's where
the source exports it, else, for OLD, from registers and shared memory), and the
largest error of du and ddt against the plain version.

``ssd_scan_bwd_bf16`` times the bf16 entry's backward at (N, hp) = (64,
64), zamba2-1.2b's, at phase 16b's two cases there (the train shape, the
ragged S with h0 and dh), in turns: the shipped Hopper route
(``ssd_bwd_states_bf16_hopper``, ``ssd_bwd_chunks_bf16_hopper``), OLD's
bf16 entry and these variants: ``one_piece`` (one bf16 piece of each f32
operand and state, not two: what the second costs; not accurate enough to
ship), ``one_cta`` (shared memory asked for so that one chunk CTA runs an
SM, not two), ``no_overlap`` (each wgmma group waited for before the next
one's operands are formed: what the overlap of products buys),
``states_ns3`` (a ring of 3 chunk stages in the states kernel, not 2),
``unstaged`` (the states' pieces and du stored from the accumulators' layout,
4 bytes a lane, not staged in shared memory and stored as whole rows), and
the diagnostics (wrong results, what each part costs) ``states_only`` and
``chunks_only`` (one of the two kernels left out), ``no_scratch_store``,
``no_fx`` (F X's pieces not written), ``no_partials`` (dB's and dC's
partials not stored) and ``no_du_store``. Each line carries the kernels'
registers and spills, shared memory and CTAs an SM, and the largest
errors of du, ddt and dB against the plain version. Then, with OLD, the
f32 entry of the shipped source and of OLD on the same f32 inputs at the
same cases, every output compared bitwise: the shared source leaves the
f32 entry as it was.

Prints one JSON line per variant (its ms per turn, registers and spills,
and its largest error against the plain version), after the card line.
The variants are diagnostics only; the port ships the sources as they are.
Stops without a CUDA device.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import card_line, scan_inputs, ssd_inputs  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as MK  # noqa: E402
from repro_torch.kernels.mamba_scan import selective_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_ref  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
SCAN_SHAPE = (4, 2048, 8192, 16)        # B, S, dI, N
SSD_SHAPE = (4, 2048, 64, 64, 64)       # B, S, H, hp, N

SSD_SPLIT_STORE = """        uint32_t b0, s0, b1, s1;
        split(hacc[k][2 * r], b0, s0);
        split(hacc[k][2 * r + 1], b1, s1);
        *reinterpret_cast<uint2*>(Hb + at) = make_uint2(b0, b1);
        *reinterpret_cast<uint2*>(Hs + at) = make_uint2(s0, s1);"""
SSD_F32_STORE = """        *reinterpret_cast<float2*>(Hb + at) =
            make_float2(hacc[k][2 * r], hacc[k][2 * r + 1]);"""
SSD_SPLIT_READ = """        mma3(yacc[d], ab, as, Hb[hr + 8 * d], Hb[hr + US + 8 * d],
             Hs[hr + 8 * d], Hs[hr + US + 8 * d]);"""
SSD_WARP_READ = """      {
        uint32_t hb0, hs0, hb1, hs1;
        split(__uint_as_float(Hb[hr + 8 * d]), hb0, hs0);
        split(__uint_as_float(Hb[hr + US + 8 * d]), hb1, hs1);
        mma3(yacc[d], ab, as, hb0, hb1, hs0, hs1);
      }"""

SSD_TRUNC_SPLIT = """  big = __float_as_uint(x) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));"""
SSD_CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : "f"(rest));"""

SSD_BF16_M = ("m0 * fast_exp2(lt[r] - ls.x) * ds.x",
              "m1 * fast_exp2(lt[r] - ls.y) * ds.y")
SSD_BF16_VARIANTS = {
    "one_stage": [("constexpr int NS = 2;", "constexpr int NS = 1;")],
    "three_pieces": [("constexpr int NP = 2;", "constexpr int NP = 3;")],
    "no_exp": [(m, m.replace(m[m.index("fast_exp2"):m.index(" * ds")], "1.f"))
               for m in SSD_BF16_M],
    "exp2f": [(m, m.replace("fast_exp2(", "exp2f(")) for m in SSD_BF16_M],
    "maxnreg200": [("__launch_bounds__(hop::NT, 2)\nssd_bf16_hopper",
                    "__maxnreg__(200)\nssd_bf16_hopper")],
    "no_wu": [("    for (int k = 0; k < 4; ++k) {\n      const int q = "
               "threadIdx.x + 128 * k;",
               "    for (int k = 0; k < 0; ++k) {\n      const int q = "
               "threadIdx.x + 128 * k;")],
    "no_m": [("      if (n <= 2 * warp + 1) {", "      if (false) {")],
    "no_state_pieces": [("    store_pieces();      // for the next", "    // ")],
    "no_y_store": [("      if (c0 + t < S) {\n        uint16_t* out",
                    "      if (c0 + t < 0) {\n        uint16_t* out")],
}
SSD_BF16_BATCHES = (4, 1)


def widening_smem_bytes(N=64, hp=64, QC=64, NW=4):
    """Dynamic shared memory of the bf16 kernel that widens to f32 tiles
    (ssd_scan_kernel's Cfg<N, hp>: u, B in two stages, the state's two
    TF32 parts, dt, L and w, in f32), for an OLD source that does not
    export ``ssd_scan_bf16_smem_bytes``."""
    US, BS = hp + 4, N + 8
    return 4 * (2 * QC * US + 2 * QC * BS + 2 * N * US + 2 * QC + 2 * NW * QC)


VARIANTS = {
    "selective_scan": (MK.SOURCES[0], "selective_scan_kernelILi16E", {
        "expf": [("a[j] = A[row + j] * kLog2e;", "a[j] = A[row + j];"),
                 ("ex2(dtt * a[j])", "expf(dtt * a[j])")],
        "lanes4": [("SPT = N < 8 ? N : 8;", "SPT = 4;"),
                   ("constexpr int kMinCtas = 4;", "constexpr int kMinCtas = 8;")],
        "lanes8": [("SPT = N < 8 ? N : 8;", "SPT = 2;"),
                   ("constexpr int kMinCtas = 4;", "constexpr int kMinCtas = 8;")],
        "lanes1": [("SPT = N < 8 ? N : 8;", "SPT = N;"),
                   ("constexpr int kMinCtas = 4;", "constexpr int kMinCtas = 2;")],
        "uncapped": [("constexpr int kMinCtas = 4;",
                      "constexpr int kMinCtas = 1;")],
    }),
    "ssd_scan": (SK.SOURCES[0], "ILi64ELi64E", {
        "cvt_rna": [(SSD_TRUNC_SPLIT, SSD_CVT_SPLIT)],
        "every_block": [("if (j < nsb) {", "{")],
        "eight_warps": [("constexpr int NW = 4;", "constexpr int NW = 8;")],
        "single_tf32": [("  mma(d, as, bb0, bb1);\n  mma(d, ab, bs0, bs1);\n",
                         "")],
        "split_per_warp": [(SSD_SPLIT_STORE, SSD_F32_STORE),
                           (SSD_SPLIT_READ, SSD_WARP_READ)],
        "one_cta": [("const size_t smem = Cfg<N, HP>::bytes;",
                     "const size_t smem = 120 * 1024;   // one CTA an SM"),
                    ("__launch_bounds__(NT, 2)", "__launch_bounds__(NT, 1)")],
    }),
}

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(kernel, name, src, entry, edits, fn_name=None):
    text = open(src).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"scan_variants: {kernel} no longer has {old!r}")
        text = text.replace(old, new)
    cu = os.path.join(OUT, f"{kernel}_{name}.cu")
    so = os.path.join(OUT, f"{kernel}_{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so, cu],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {kernel} {name}:\n{proc.stdout}")
    lines = proc.stdout.splitlines()
    at = next(i for i, ln in enumerate(lines)
              if "Compiling entry" in ln and entry in ln)
    regs = [ln.strip() for ln in lines[at + 1:at + 4]
            if "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(so)
    fn = getattr(lib, fn_name or f"{kernel}_f32")
    fn.argtypes = [_P] * 9 + [_I] * (4 if kernel == "selective_scan"
                                     else 5) + [_P]
    fn.restype = _I
    fn.library = lib
    return fn, regs


def timed(run, reps):
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def ssd_bf16(reps: int, old: str = "") -> None:
    """The bf16 entry's Hopper kernel, its variants and OLD, in turns at
    the zamba2-1.2b prefill shape and at batch 1."""
    dev = torch.device("cuda")
    src = SK.SOURCES[0]
    # the hopper kernel's entry; OLD's bf16 instantiation at (64, 64)
    jobs = [("shipped", src, "ssd_bf16_hopper", [])] + [
        (name, src, "ssd_bf16_hopper", edits)
        for name, edits in SSD_BF16_VARIANTS.items()]
    if old:
        jobs.append(("old", old, "ssd_scan_kernelILi64ELi64E13__nv_bfloat16",
                     []))

    def build_or_report(job):
        # a variant that does not build is reported and left out (ptxas of
        # CUDA 12.9 crashes on some edits of this kernel); the shipped
        # source must build
        try:
            return build("ssd_scan_bf16", job[0], job[1], job[2], job[3],
                         "ssd_scan_bf16")
        except SystemExit as e:
            if job[0] == "shipped":
                raise
            return str(e)[-300:]

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(build_or_report, jobs))
    print(card_line(), flush=True)
    for job, b in zip(jobs, built):
        if isinstance(b, str):
            print(json.dumps({"kernel": "ssd_scan_bf16", "variant": job[0],
                              "build_failed": b}), flush=True)
    jobs, built = zip(*[(j, b) for j, b in zip(jobs, built)
                        if not isinstance(b, str)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, S, H, hp, N = SSD_SHAPE
    cases = {}
    for B in SSD_BF16_BATCHES:
        u, dt, A, Bm, Cm, D = ssd_inputs(B, S, H, hp, N, dev)
        args = [u.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), D]
        cases[B] = (args, ssd_scan_ref(*args, chunk=SK.KERNEL_CHUNK),
                    (torch.empty_like(args[0]),
                     torch.empty((B, H, N, hp), device=dev)))

    def runner(fn, B):
        args, _, outs = cases[B]

        def run():
            rc = fn(*(a.data_ptr() for a in args), None,
                    *(o.data_ptr() for o in outs), B, S, H, N, hp, stream)
            if rc != 0:
                raise SystemExit(f"scan_variants: launch failed ({rc})")
        return run

    names = [j[0] for j in jobs]
    ms = {(name, B): [] for name in names for B in SSD_BF16_BATCHES}
    for (name, _, _, _), (fn, _) in list(zip(jobs, built)) + list(
            zip(jobs, built))[::-1]:
        for B in SSD_BF16_BATCHES:
            ms[name, B].append(timed(runner(fn, B), reps))
    for (name, _, _, _), (fn, regs) in zip(jobs, built):
        smem = getattr(fn.library, "ssd_scan_bf16_smem_bytes", None)
        if smem is not None:
            smem.argtypes, smem.restype = [_I, _I], _I
        row = {"kernel": "ssd_scan_bf16", "variant": name,
               "shape": [None, S, H, hp, N], "ptxas": regs,
               "dynamic_smem_bytes": smem(N, hp) if smem else
               widening_smem_bytes(N, hp)}
        for B in SSD_BF16_BATCHES:
            args, (y_p, h_p), outs = cases[B]
            runner(fn, B)()
            torch.cuda.synchronize()
            row[f"ms_batch{B}"] = ms[name, B]
            row[f"max_abs_err_y_batch{B}"] = float(
                (outs[0].float() - y_p.float()).abs().max())
            row[f"max_abs_err_h_batch{B}"] = float(
                (outs[1] - h_p).abs().max())
        print(json.dumps(row), flush=True)


# the Mamba-1 scan's bf16 kernel: edits of the text after SEL_BF16_FROM
SEL_BF16_FROM = "namespace b16 {"
SEL_BF16_KERNEL = ("template <int N>\n__global__ void __launch_bounds__(NT, "
                   "kMinCtas)\nselective_scan_bf16_hopper")
SEL_BF16_STEP = "h[j] = fmaf(ex2(dtt * a[j]), h[j], du * bn[j]);"
# 2^x, x <= 0, on the FMA pipe: x = n + f with n = rint(x) (the 1.5·2^23
# trick), 2^f by its Taylor polynomial of degree 6 (|f| <= 1/2: relative
# error < 2^-22), 2^n added to the exponent; 0 below 2^-126 (ftz)
SEL_POLY_EXP = """__device__ __forceinline__ float exp2_poly(float x) {
  const float t = x + 12582912.f;
  const float n = t - 12582912.f;
  const float f = x - n;
  float p = 1.5403530393381610e-4f;
  p = fmaf(p, f, 1.3333558146428443e-3f);
  p = fmaf(p, f, 9.6181291076284772e-3f);
  p = fmaf(p, f, 5.5504108664821580e-2f);
  p = fmaf(p, f, 2.4022650695910071e-1f);
  p = fmaf(p, f, 6.9314718055994531e-1f);
  p = fmaf(p, f, 1.f);
  const int e = __float_as_int(t) - 0x4B400000;
  const float r = __int_as_float(__float_as_int(p) + (e << 23));
  return x < -126.f ? 0.f : r;
}

"""
SEL_BF16_BC = ("load<SPT>(&st.bf[r][g * SPT], bn);\n"
               "      load<SPT>(&st.cf[r][g * SPT], cn);")
SEL_BF16_AHEAD = "      if (r + 1 < TT) read_step(r + 1, nu, ndt, nb, nc);\n"
# y's epilogue by four channels a thread, 8-byte stores (shipped), or by
# eight, one 16-byte store each (``y16``)
SEL_BF16_Y4 = """    // y = (sum of a channel's L partials) + u D, rounded once to bf16, by
    // the warp whose lanes wrote the partials (so no CTA barrier): its CW
    // channels, four a lane at a time (8-byte stores where dI % 4 == 0)
    const int t0 = k * TT;
#pragma unroll
    for (int i = 0; i < TT * QW / 32; ++i) {
      const int e = lane + 32 * i, r = e / QW, col = cw + e % QW * 4;
      if (t0 + r >= S || d0 + col >= dI) continue;
      float uv[4], out[4];
      widen<4>(&st.u[r][col], uv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float p[L];
#pragma unroll
        for (int j = 0; j < L; ++j) p[j] = Ps[r * kPS + (col + q) * L + j];
#pragma unroll
        for (int o = 1; o < L; o <<= 1)
#pragma unroll
          for (int j = 0; j < L; j += 2 * o) p[j] += p[j + o];
        out[q] = p[0] + uv[q] * Ds[col + q];
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(out[0], out[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(out[2], out[3]);
      const uint32_t w[2] = {*reinterpret_cast<const uint32_t*>(&lo),
                             *reinterpret_cast<const uint32_t*>(&hi)};
      uint16_t* yr = y + ((size_t)b * S + t0 + r) * dI + d0 + col;
      if (vec4) {
        *reinterpret_cast<uint2*>(yr) = make_uint2(w[0], w[1]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (d0 + col + q < dI)
            yr[q] = (uint16_t)(q & 1 ? w[q / 2] >> 16 : w[q / 2] & 0xFFFFu);
      }
    }"""
SEL_BF16_Y8 = """    // y = (sum of a channel's L partials) + u D, rounded once to bf16, by
    // the warp whose lanes wrote the partials (so no CTA barrier): its CW
    // channels, eight a lane at a time (16-byte stores where dI % 8 == 0)
    const int t0 = k * TT;
#pragma unroll
    for (int i = 0; i < TT * QW / 64; ++i) {
      const int e = lane + 32 * i, r = e / (QW / 2), col = cw + e % (QW / 2) * 8;
      if (t0 + r >= S || d0 + col >= dI) continue;
      float uv[8], out[8];
      widen<8>(&st.u[r][col], uv);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float p[L];
#pragma unroll
        for (int j = 0; j < L; ++j) p[j] = Ps[r * kPS + (col + q) * L + j];
#pragma unroll
        for (int o = 1; o < L; o <<= 1)
#pragma unroll
          for (int j = 0; j < L; j += 2 * o) p[j] += p[j + o];
        out[q] = p[0] + uv[q] * Ds[col + q];
      }
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(out[2 * q], out[2 * q + 1]);
        w[q] = *reinterpret_cast<const uint32_t*>(&v);
      }
      uint16_t* yr = y + ((size_t)b * S + t0 + r) * dI + d0 + col;
      if (vec8) {
        *reinterpret_cast<uint4*>(yr) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (d0 + col + q < dI)
            yr[q] = (uint16_t)(q & 1 ? w[q / 2] >> 16 : w[q / 2] & 0xFFFFu);
      }
    }"""
SEL_BF16_VARIANTS = {
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "stages5": [("constexpr int kStages = 4;", "constexpr int kStages = 5;")],
    "tt32": [("constexpr int kTT = 16;", "constexpr int kTT = 32;")],
    "tt32_stages3": [("constexpr int kTT = 16;", "constexpr int kTT = 32;"),
                     ("constexpr int kStages = 4;",
                      "constexpr int kStages = 3;")],
    "ctas3": [(SEL_BF16_KERNEL, SEL_BF16_KERNEL.replace("kMinCtas", "3"))],
    "cta_barrier": [("    __syncwarp();                    // the warp's partials",
                     "    __syncthreads();                 // the warp's partials")],
    "not_ahead": [(SEL_BF16_AHEAD, ""),
                  ("      const float ut = nu, dtt = ndt;\n",
                   "      read_step(r, nu, ndt, nb, nc);\n"
                   "      const float ut = nu, dtt = ndt;\n")],
    "y16": [(SEL_BF16_Y4, SEL_BF16_Y8)],
    "bc_at_use": [(SEL_BF16_BC,
                   SEL_BF16_BC.replace("load", "widen")
                   .replace("st.bf", "st.b").replace("st.cf", "st.c"))],
    "no_exp": [(SEL_BF16_STEP, "h[j] = fmaf(0.5f, h[j], du * bn[j]);")],
    "no_copies": [("    load_tile(k + NS - 1, (k + NS - 1) % NS);\n", "")],
    "no_epilogue": [("    for (int i = 0; i < TT * QW / 32; ++i) {",
                     "    for (int i = 0; i < 0; ++i) {")],
    "no_barrier": [("    __syncthreads();                 // everyone's, and tile k's",
                    "    //                               everyone's, and tile k's")],
    "no_widen": [("out[2 * i] = __uint_as_float(w[i] << 16);",
                  "out[2 * i] = __uint_as_float(w[i]);"),
                 ("out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);",
                  "out[2 * i + 1] = __uint_as_float(w[i]);"),
                 ("return __uint_as_float((uint32_t)x << 16);",
                  "return __uint_as_float((uint32_t)x);")],
    "poly_exp": [(SEL_BF16_KERNEL, SEL_POLY_EXP + SEL_BF16_KERNEL),
                 (SEL_BF16_STEP, SEL_BF16_STEP.replace(
                     "ex2(dtt * a[j])", "(j % 4 == 3 ? exp2_poly(dtt * a[j])"
                     " : ex2(dtt * a[j]))"))],
}


def build_sel_bf16(name, src, edits):
    """A variant of the Mamba-1 scan's source, its edits applied to the
    bf16 kernel's text alone: (library with ``bf16`` and ``f32`` entries,
    ptxas lines)."""
    text = open(src).read()
    at = text.find(SEL_BF16_FROM) if edits else 0
    head, tail = text[:at], text[at:]
    for old, new in edits:
        if old not in tail:
            raise SystemExit(f"scan_variants: selective_scan_bf16 no longer "
                             f"has {old!r}")
        tail = tail.replace(old, new)
    cu = os.path.join(OUT, f"selective_scan_bf16_{name}.cu")
    so = os.path.join(OUT, f"selective_scan_bf16_{name}.so")
    with open(cu, "w") as f:
        f.write(head + tail)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so, cu],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on selective_scan_bf16 {name}:\n"
                         f"{proc.stdout}")
    lib = ctypes.CDLL(so)
    for entry in ("bf16", "f32"):
        fn = getattr(lib, f"selective_scan_{entry}")
        fn.argtypes, fn.restype = [_P] * 9 + [_I] * 4 + [_P], _I
        setattr(lib, entry, fn)
    return lib, proc.stdout


def ptxas_smem(stdout: str) -> dict:
    """{entry: static shared memory bytes} from nvcc -Xptxas -v output."""
    out, cur = {}, None
    for ln in stdout.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Used \d+ registers,.*?(\d+) bytes smem", ln)
        if m and cur:
            out[cur] = int(m.group(1))
    return out


def selective_bf16(reps: int, old: str = "") -> None:
    """The Mamba-1 scan's bf16 entry: the shipped kernel, its variants
    (``SEL_BF16_VARIANTS``) and OLD's bf16 entry, in turns at the
    falcon-mamba-7b prefill shape beside the shipped f32 entry on the same
    values widened; then, with OLD, both sources' f32 entries bitwise."""
    from chip_smoke import LM_RTOL, bf16_err, max_err
    dev = torch.device("cuda")
    src = MK.SOURCES[0]
    jobs = [("shipped", src, [])] + [
        (n, src, e) for n, e in SEL_BF16_VARIANTS.items()]
    if old:
        jobs.append(("old", old, []))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build_sel_bf16(*j), jobs))
    print(card_line(), flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    B, S, dI, N = SCAN_SHAPE
    wide = scan_inputs(*SCAN_SHAPE, dev)
    args = [t.bfloat16() if i in (0, 3, 4) else t
            for i, t in enumerate(wide)]
    # the plain version on the bf16 values; the f32 entry on them widened
    wide = [t.float() for t in args]
    y_p, h_p = selective_scan_ref(*args)
    f32 = dict(dtype=torch.float32, device=dev)

    def runner(entry, inputs):
        outs = (torch.empty_like(inputs[0]), torch.empty((B, dI, N), **f32))

        def run():
            rc = entry(*(a.data_ptr() for a in inputs), None,
                       *(o.data_ptr() for o in outs), B, S, dI, N, stream)
            if rc != 0:
                raise SystemExit(f"scan_variants: launch failed ({rc})")
        return run, outs

    timed_jobs = [(name, lib.bf16, args) for (name, _, _), (lib, _) in
                  zip(jobs, built)]
    timed_jobs.insert(1, ("f32_entry", built[0][0].f32, wide))
    ms = {name: [] for name, _, _ in timed_jobs}
    for name, entry, inputs in timed_jobs + timed_jobs[::-1]:
        ms[name].append(timed(runner(entry, inputs)[0], reps))
    run, (y32, h32) = runner(built[0][0].f32, wide)
    run()
    for (name, _, _), (lib, stdout) in zip(jobs, built):
        run, (y, h) = runner(lib.bf16, args)
        run()
        torch.cuda.synchronize()
        fn = ("selective_scan_kernelILi16E13__nv_bfloat16E" if name == "old"
              else "selective_scan_bf16_hopperILi16E")
        regs = {k: v for k, v in ptxas_entries(stdout).items() if fn in k}
        smem = getattr(lib, "selective_scan_bf16_smem_bytes", None)
        occ = getattr(lib, "selective_scan_bf16_ctas_per_sm", None)
        for f in (smem, occ):
            if f is not None:
                f.argtypes, f.restype = [_I], _I
        static = next((v for k, v in ptxas_smem(stdout).items() if fn in k),
                      0)
        e_y, _, ok_y = bf16_err(y, y_p, LM_RTOL)
        e_h, ok_h = max_err([h], [h_p], LM_RTOL)
        row = {"kernel": "selective_scan_bf16", "variant": name,
               "shape": list(SCAN_SHAPE), "ms": ms[name], "ptxas": regs,
               "dynamic_smem_bytes": smem(N) if smem else 0,
               "static_smem_bytes": static,
               "ctas_per_sm": occ(N) if occ else ctas_from_resources(
                   next(iter(regs.values()), [128])[0], static),
               "max_abs_err_y": e_y, "max_abs_err_h": e_h,
               "within_tol": ok_y and ok_h}
        if name == "shipped":
            row["bitwise_f32_entry"] = (torch.equal(h, h32) and
                                        torch.equal(y, y32.bfloat16()))
            row["f32_entry_ms"] = ms["f32_entry"]
        print(json.dumps(row), flush=True)
    if old:
        got = []
        for lib, _ in (built[0], built[-1]):
            run, outs = runner(lib.f32, wide)
            run()
            torch.cuda.synchronize()
            got.append(outs)
        print(json.dumps({
            "kernel": "selective_scan", "shape": list(SCAN_SHAPE),
            "f32_entry_bitwise_equal_to_old": all(
                torch.equal(a, b) for a, b in zip(*got))}), flush=True)


BWD_VARIANTS = {
    "selective_scan_bwd": (MK.BWD_SOURCES[0], {
        "tb8": [("constexpr int TB = 4;", "constexpr int TB = 8;")],
        # the shipped shared-memory buffer of a chunk's states replaced by
        # an array in registers (a text edit: the source keeps one way)
        "states_in_registers": [
            ("static constexpr int HS = (TB - 1) * SPT * NT;",
             "static constexpr int HS = 0;"),
            ("    float e[TB][SPT];\n",
             "    float e[TB][SPT];\n    float hreg[TB][SPT];\n"),
            ("      if (r > 0) store_state<SPT>(HSm + (r - 1) * SPT * NT, h);\n",
             "#pragma unroll\n"
             "      for (int j = 0; j < SPT; ++j) hreg[r][j] = h[j];\n"),
            ("      load_state<SPT>(r == 0 ? hk : HSm + (r - 1) * SPT * NT, "
             "hp);\n",
             "#pragma unroll\n"
             "      for (int j = 0; j < SPT; ++j) hp[j] = hreg[r][j];\n")],
        "ctas2": [("constexpr int kMinCtas = 4;",
                   "constexpr int kMinCtas = 2;")],
        "ctas3": [("constexpr int kMinCtas = 4;",
                   "constexpr int kMinCtas = 3;")],
        "stages2": [("constexpr int NS = 4;", "constexpr int NS = 2;")],
        "stages6": [("constexpr int NS = 4;", "constexpr int NS = 6;")],
    }),
    "ssd_scan_bwd": (SK.BWD_SOURCES[0], {
        "single_tf32": [("      mma(acc[i], a.small, bb0, bb1);\n"
                         "      mma(acc[i], a.big, bs0, bs1);\n", "")],
        "one_cta": [("const size_t smem2 = sizeof(float) * "
                     "ChunkCfg<N, HP>::kFloats;",
                     "const size_t smem2 = 120 * 1024;   // one CTA an SM")],
        "states_only": [("  ssd_bwd_chunks<N, HP><<<dim3(T, H, B), NT, smem2, "
                         "stream>>>(\n      u, dt, A, Bm, Cm, D, dy, scratch, "
                         "du, ddt, dAp, dBp, dCp, dDp, S, H);\n", "")],
    }),
}


def ptxas_entries(stdout: str) -> dict:
    """{demangled-ish entry: [registers, spill bytes]} from nvcc -Xptxas -v
    output."""
    out, cur = {}, None
    for ln in stdout.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out.setdefault(cur, [0, 0])[0] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur:
            out.setdefault(cur, [0, 0])[1] = int(m.group(1)) + int(m.group(2))
    return out


def build_bwd(kernel, name, src, edits):
    """A variant of a backward source built into a library of its own:
    (ctypes library, {entry: [registers, spills]})."""
    text = open(src).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"scan_variants: {kernel} no longer has {old!r}")
        text = text.replace(old, new)
    cu = os.path.join(OUT, f"{kernel}_{name}.cu")
    so = os.path.join(OUT, f"{kernel}_{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so, cu],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {kernel} {name}:\n{proc.stdout}")
    lib = ctypes.CDLL(so)
    lib.entry = getattr(lib, f"{kernel}_f32")
    lib.entry.argtypes = [_P] * 17 + [_I] * (4 if kernel ==
                                             "selective_scan_bwd" else 5) + [_P]
    lib.entry.restype = _I
    # the sizes and resources each source exports (an older one not all)
    for fn, nargs in (("selective_scan_bwd_groups", 2),
                      ("selective_scan_bwd_chunk", 0),
                      ("selective_scan_bwd_smem_bytes", 1),
                      ("selective_scan_bwd_ctas_per_sm", 1),
                      ("ssd_scan_bwd_chunk", 0),
                      ("ssd_scan_bwd_smem_bytes", 2),
                      ("ssd_scan_bwd_kernel_smem_bytes", 3),
                      ("ssd_scan_bwd_ctas_per_sm", 3)):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [_I] * nargs
            getattr(lib, fn).restype = _I
    return lib, ptxas_entries(proc.stdout)


# the bf16 entry's backward at (N, hp) = (64, 64): the Hopper route's
# variants (edits of csrc/ssd_scan_bwd.cu)
SSD_BWD_HOPPER_LAUNCH_STATES = (
    "  ssd_bwd_states_bf16_hopper<<<dim3(H, B, 2), hop::NT, hop::st_bytes, "
    "stream>>>(\n      tu, tdy, tb, tc, dt, A, h0, dh, dh0, (uint16_t*)scratch,"
    " S, H);\n")
SSD_BWD_HOPPER_LAUNCH_CHUNKS = (
    "  ssd_bwd_chunks_bf16_hopper<<<dim3(T, H, B), hop::NT, hop::c_bytes, "
    "stream>>>(\n")
# the states' pieces and du stored through shared memory, whole rows 16
# bytes a lane (shipped), or straight from the accumulator's layout, 4
# bytes a lane (``unstaged``)
SSD_BWD_STAGED_STATE = """      __syncwarp();
      uint16_t* dst = scratch + ((((size_t)adj * gridDim.y + b) * H + hh) * T +
                                 chunk_of(i)) * NP * 64 * 64;
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * warp + (lane >> 3) + 4 * e, blk = lane & 7;
          *reinterpret_cast<uint4*>(dst + k * 64 * 64 + row * 64 + 8 * blk) =
              *reinterpret_cast<const uint4*>(fx_g + k * TILE + sw128(row, blk));
        }
      __syncwarp();"""
SSD_BWD_UNSTAGED_STATE = """      __syncwarp();
      uint16_t* dst = scratch + ((((size_t)adj * gridDim.y + b) * H + hh) * T +
                                 chunk_of(i)) * NP * 64 * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t p[NP];
          pieces(st[4 * j + 2 * r], st[4 * j + 2 * r + 1], p);
#pragma unroll
          for (int k = 0; k < NP; ++k)
            *reinterpret_cast<uint32_t*>(dst + k * 64 * 64 + (n0 + 8 * r) * 64
                                         + 8 * j + 2 * t4) = p[k];
        }"""
SSD_BWD_STAGED_DU = """  __syncwarp();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int s = 16 * warp + (lane >> 3) + 4 * e, blk = lane & 7;
    if (t0 + s < S)
      *reinterpret_cast<uint4*>(du + (((size_t)b * S + t0 + s) * H + hh) * 64 +
                                8 * blk) =
          *reinterpret_cast<const uint4*>(Ug + sw128(s, blk));
  }"""
SSD_BWD_UNSTAGED_DU = """#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + 8 * r;
    if (t0 + s >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t at = sw128(s, j) + 4 * t4;
      *reinterpret_cast<uint32_t*>(du + (((size_t)b * S + t0 + s) * H + hh) *
                                   64 + 8 * j + 2 * t4) =
          *reinterpret_cast<const uint32_t*>(Ug + at);
    }
  }"""
SSD_BWD_BF16_VARIANTS = {
    "one_piece": [("constexpr int NP = 2;                    // bf16 pieces",
                   "constexpr int NP = 1;                    // bf16 pieces")],
    "one_cta": [("  ssd_bwd_chunks_bf16_hopper<<<dim3(T, H, B), hop::NT, "
                 "hop::c_bytes,", "  ssd_bwd_chunks_bf16_hopper<<<dim3(T, H, "
                 "B), hop::NT, 120 * 1024,"),
                ("                             (int)hop::c_bytes);",
                 "                             120 * 1024);")],
    "no_overlap": [("  wgmma_wait<1>();\n", "  wgmma_wait<0>();\n")],
    "states_only": [(SSD_BWD_HOPPER_LAUNCH_CHUNKS,
                     "  if (false) " + SSD_BWD_HOPPER_LAUNCH_CHUNKS.lstrip())],
    "chunks_only": [(SSD_BWD_HOPPER_LAUNCH_STATES,
                     "  if (false)\n" + SSD_BWD_HOPPER_LAUNCH_STATES)],
    "states_ns3": [("constexpr int NS = 2;\nconstexpr uint32_t st_stage",
                    "constexpr int NS = 3;\nconstexpr uint32_t st_stage")],
    "unstaged": [(SSD_BWD_STAGED_STATE, SSD_BWD_UNSTAGED_STATE),
                 (SSD_BWD_STAGED_DU, SSD_BWD_UNSTAGED_DU)],
    "no_scratch_store": [(
        "          *reinterpret_cast<uint4*>(dst + k * 64 * 64",
        "          if (false) *reinterpret_cast<uint4*>(dst + k * 64 * 64")],
    "no_fx": [("        *reinterpret_cast<uint4*>(fx_g + j * TILE + 16 * q) =",
               "        if (false) *reinterpret_cast<uint4*>(fx_g + j * TILE "
               "+ 16 * q) =")],
    "no_partials": [(
        "      *reinterpret_cast<float2*>(dBp + (bh * S + t0 + s) * 64",
        "      if (false) *reinterpret_cast<float2*>(dBp + (bh * S + t0 + s) "
        "* 64"), (
        "      *reinterpret_cast<float2*>(dCp + (bh * S + t0 + t) * 64",
        "      if (false) *reinterpret_cast<float2*>(dCp + (bh * S + t0 + t) "
        "* 64")],
    "no_du_store": [("    if (t0 + s < S)\n      *reinterpret_cast<uint4*>(du",
                     "    if (false)\n      *reinterpret_cast<uint4*>(du")],
}


def ctas_from_resources(regs: int, smem: int, threads: int = 128) -> int:
    """CTAs an SM on an H100 from a kernel's registers a thread and dynamic
    shared memory, for a source that does not export its occupancy (65,536 registers in 256-register units a warp, 228 KB
    of shared memory with 1 KB reserved a CTA, 2,048 threads, 32 CTAs)."""
    warps = threads // 32
    per_warp = -(-max(regs, 1) * 32 // 256) * 256
    by_regs = 65536 // (per_warp * warps)
    by_smem = (228 * 1024) // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def bwd(kernel: str, reps: int, old: str = "") -> None:
    """A scan's backward kernel, its variants and OLD, in turns at phase
    16b's cases."""
    from chip_smoke import scan_bwd_cases
    from repro_torch.kernels.mamba_scan import selective_scan_bwd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref
    dev = torch.device("cuda")
    src, variants = BWD_VARIANTS[kernel]
    jobs = [("shipped", src, [])] + [(n, src, e) for n, e in variants.items()]
    if old:
        jobs.append(("old", old, []))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build_bwd(kernel, *j), jobs))
    print(card_line(), flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    selective = kernel == "selective_scan_bwd"
    cases = []
    for label, shape, extra in scan_bwd_cases()[kernel]:
        g = torch.Generator(dev).manual_seed(len(label))
        if selective:
            B, S, dI, N = shape
            args = scan_inputs(B, S, dI, N, dev, seed=S)
            h_shape = (B, dI, N)
            want = None
        else:
            B, S, H, hp, N = shape
            args = ssd_inputs(B, S, H, hp, N, dev, seed=S)
            h_shape = (B, H, N, hp)
        dy = torch.randn(args[0].shape, device=dev, generator=g)
        h0 = torch.randn(h_shape, device=dev, generator=g) if extra else None
        dh = torch.randn(h_shape, device=dev, generator=g) if extra else None
        if selective:
            want = selective_scan_bwd_ref(*args, dy, h0=h0, dh=dh)
        else:
            want = ssd_scan_bwd_ref(*args, dy, chunk=SK.KERNEL_CHUNK, h0=h0,
                                    dh=dh)
        cases.append((label, shape, args, dy, h0, dh, want))

    def runner(lib, case):
        """The raw C entry on the case, outputs allocated for the library
        (its chunk; the larger of the old and new partial layouts)."""
        _, shape, args, dy, h0, dh, _ = case
        f32 = dict(dtype=torch.float32, device=dev)
        if selective:
            B, S, dI, N = shape
            G = lib.selective_scan_bwd_groups(dI, N)
            chunks = -(-S // lib.selective_scan_bwd_chunk())
            outs = [torch.empty_like(args[0]), torch.empty_like(args[0]),
                    torch.empty((B, dI, N), **f32),
                    torch.empty((B, G, S, N), **f32),
                    torch.empty((B, G, S, N), **f32),
                    torch.empty((B, dI), **f32),
                    None if h0 is None else torch.empty((B, dI, N), **f32),
                    torch.empty((B, chunks, dI, N), **f32)]
            dims = (B, S, dI, N)
        else:
            B, S, H, hp, N = shape
            T = -(-S // lib.ssd_scan_bwd_chunk())
            outs = [torch.empty_like(args[0]), torch.empty_like(args[1]),
                    torch.empty((B, H, T), **f32),
                    torch.empty((B, H, S, N), **f32),
                    torch.empty((B, H, S, N), **f32),
                    torch.empty((B, H, T), **f32),
                    None if h0 is None else torch.empty((B, H, N, hp), **f32),
                    torch.empty((2, B, H, T, N, hp), **f32)]
            dims = (B, S, H, N, hp)
        ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731

        def run():
            rc = lib.entry(*(ptr(t) for t in (*args, h0, dy, dh, *outs)),
                           *dims, stream)
            if rc != 0:
                raise SystemExit(f"scan_variants: launch failed ({rc})")
        return run, outs

    names = [j[0] for j in jobs]
    ms = {(n, c[0]): [] for n in names for c in cases}
    order = list(zip(names, built))
    for name, (lib, _) in order + order[::-1]:
        for case in cases:
            run, _ = runner(lib, case)
            ms[name, case[0]].append(timed(run, reps))
    for name, (lib, regs) in order:
        row = {"kernel": kernel, "variant": name, "ptxas": regs}
        occ = getattr(lib, "selective_scan_bwd_ctas_per_sm" if selective
                      else "ssd_scan_bwd_ctas_per_sm", None)
        for case in cases:
            label, shape = case[0], case[1]
            N = shape[3] if selective else shape[4]
            hp = None if selective else shape[3]
            run, outs = runner(lib, case)
            run()
            torch.cuda.synchronize()
            want = case[6]
            if selective:
                sm_bytes = lib.selective_scan_bwd_smem_bytes(N)
            elif hasattr(lib, "ssd_scan_bwd_kernel_smem_bytes"):
                sm_bytes = lib.ssd_scan_bwd_kernel_smem_bytes(N, hp, 1)
            else:                        # a one-kernel source (OLD)
                sm_bytes = lib.ssd_scan_bwd_smem_bytes(N, hp)
            entry = {"ms": ms[name, label], "shape": list(shape),
                     "smem_bytes": sm_bytes,
                     "max_abs_err_du": float((outs[0] - want[0]).abs().max()),
                     "max_abs_err_ddt": float((outs[1] - want[1]).abs().max())}
            if occ is not None:
                entry["ctas_per_sm"] = occ(N) if selective else {
                    "states": occ(N, hp, 0), "chunks": occ(N, hp, 1)}
            else:
                # a source without the export (OLD): from the registers and
                # shared memory of its kernel at this (N, hp)
                tag = f"ILi{N}E" if selective else f"ILi{N}ELi{hp}E"
                entry["ctas_per_sm_from_resources"] = {
                    k: ctas_from_resources(r[0], sm_bytes)
                    for k, r in regs.items() if tag in k}
            row[label] = entry
        print(json.dumps(row), flush=True)


def bwd_bf16(reps: int, old: str = "") -> None:
    """The bf16 entry's backward at (N, hp) = (64, 64): the shipped Hopper
    route, its variants (``SSD_BWD_BF16_VARIANTS``) and OLD's bf16 entry
    (an older ``ssd_scan_bwd.cu``), in turns at phase 16b's two (64, 64)
    cases; then the f32 entry of the shipped source and of OLD on the same
    f32 inputs, output for output, bitwise."""
    from chip_smoke import scan_bwd_cases
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref
    dev = torch.device("cuda")
    src = SK.BWD_SOURCES[0]
    jobs = [("shipped", src, [])] + [
        (n, src, e) for n, e in SSD_BWD_BF16_VARIANTS.items()]
    if old:
        jobs.append(("old", old, []))

    def make(job):
        try:
            lib, regs = build_bwd("ssd_scan_bwd", *job)
        except SystemExit as e:           # ptxas of CUDA 12.9 may crash
            return None, str(e)[-400:]
        lib.bf16 = lib.ssd_scan_bwd_bf16
        lib.bf16.argtypes = lib.entry.argtypes
        lib.bf16.restype = _I
        return lib, regs
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(make, jobs))
    print(card_line(), flush=True)
    for (name, _, _), (lib, info) in zip(jobs, built):
        if lib is None:
            print(json.dumps({"kernel": "ssd_scan_bwd_bf16", "variant": name,
                              "built": False, "nvcc": info}), flush=True)
    order = [(j[0], lib, regs) for j, (lib, regs) in zip(jobs, built)
             if lib is not None]
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = dict(dtype=torch.float32, device=dev)
    cases = []
    for label, shape, extra in scan_bwd_cases()["ssd_scan_bwd_bf16"]:
        B, S, H, hp, N = shape
        if (N, hp) != (64, 64):
            continue
        g = torch.Generator(dev).manual_seed(len(label))
        wide = ssd_inputs(B, S, H, hp, N, dev, seed=S)
        dyw = torch.randn(wide[0].shape, device=dev, generator=g)
        h0 = torch.randn((B, H, N, hp), device=dev, generator=g) \
            if extra else None
        dh = torch.randn((B, H, N, hp), device=dev, generator=g) \
            if extra else None
        args = list(wide)
        for i in (0, 3, 4):
            args[i] = args[i].bfloat16()
        dy = dyw.bfloat16()
        want = ssd_scan_bwd_ref(*args, dy, chunk=SK.KERNEL_CHUNK, h0=h0,
                                dh=dh)
        cases.append((label, shape, args, dy, h0, dh, want, wide, dyw))

    def runner(entry, case, bf16=True):
        _, (B, S, H, hp, N), args, dy, h0, dh, _, wide, dyw = case
        if not bf16:
            args, dy = wide, dyw
        T = -(-S // 64)
        outs = [torch.empty_like(args[0]), torch.empty_like(args[1]),
                torch.empty((B, H, T), **f32),
                torch.empty((B, H, S, N), **f32),
                torch.empty((B, H, S, N), **f32),
                torch.empty((B, H, T), **f32),
                None if h0 is None else torch.empty((B, H, N, hp), **f32),
                torch.empty((2, B, H, T, N, hp), **f32)]
        ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731

        def run():
            rc = entry(*(ptr(t) for t in (*args, h0, dy, dh, *outs)),
                       B, S, H, N, hp, stream)
            if rc != 0:
                raise SystemExit(f"scan_variants: launch failed ({rc})")
        return run, outs

    ms = {(n, c[0]): [] for n, _, _ in order for c in cases}
    for name, lib, _ in order + order[::-1]:
        for case in cases:
            ms[name, case[0]].append(timed(runner(lib.bf16, case)[0], reps))
    for name, lib, regs in order:
        row = {"kernel": "ssd_scan_bwd_bf16", "variant": name,
               "ptxas": regs}
        smem = getattr(lib, "ssd_scan_bwd_bf16_kernel_smem_bytes", None)
        occ = getattr(lib, "ssd_scan_bwd_bf16_ctas_per_sm", None)
        for fn in (smem, occ):
            if fn is not None:
                fn.argtypes, fn.restype = [_I] * 3, _I
        for case in cases:
            run, outs = runner(lib.bf16, case)
            run()
            torch.cuda.synchronize()
            want = case[6]
            dB = outs[3].sum(1)
            row[case[0]] = {
                "ms": ms[name, case[0]], "shape": list(case[1]),
                "smem_bytes": None if smem is None else
                [smem(64, 64, 0), smem(64, 64, 1)],
                "ctas_per_sm": None if occ is None else
                [occ(64, 64, 0), occ(64, 64, 1)],
                "max_abs_err_du": float((outs[0].float()
                                         - want[0].float()).abs().max()),
                "max_abs_err_ddt": float((outs[1] - want[1]).abs().max()),
                "max_abs_err_dB": float((dB - want[3].float()).abs().max())}
        print(json.dumps(row), flush=True)
    # the f32 entry: the shipped source against OLD, bitwise
    libs = dict((n, lib) for n, lib, _ in order)
    if "old" in libs:
        for case in cases:
            got = []
            for name in ("shipped", "old"):
                run, outs = runner(libs[name].entry, case, bf16=False)
                run()
                torch.cuda.synchronize()
                got.append([o for o in outs[:7] if o is not None])
            print(json.dumps({
                "kernel": "ssd_scan_bwd", "case": case[0],
                "f32_entry_bitwise_equal_to_old": all(
                    torch.equal(a, b) for a, b in zip(*got))}), flush=True)


def main(reps: int = 20, only: str = "", old: str = "") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants: needs a CUDA device")
    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    if only == "ssd_scan_bf16":
        ssd_bf16(reps, old)
        return
    if only == "selective_scan_bf16":
        selective_bf16(reps, old)
        return
    if only == "ssd_scan_bwd_bf16":
        bwd_bf16(reps, old)
        return
    if only in BWD_VARIANTS:
        bwd(only, reps, old)
        return
    kernels = [k for k in VARIANTS if not only or k == only]
    jobs = [(kernel, name, *VARIANTS[kernel][:2], edits)
            for kernel in kernels
            for name, edits in [("shipped", [])] + list(
                VARIANTS[kernel][2].items())]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    print(card_line(), flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for kernel in kernels:
        if kernel == "selective_scan":
            B, S, dI, N = SCAN_SHAPE
            args = scan_inputs(*SCAN_SHAPE, dev)
            want = selective_scan_ref(*args)
            outs = (torch.empty_like(args[0]),
                    torch.empty((B, dI, N), device=dev))
            dims, shape = (B, S, dI, N), list(SCAN_SHAPE)
        else:
            B, S, H, hp, N = SSD_SHAPE
            args = ssd_inputs(*SSD_SHAPE, dev)
            want = ssd_scan_ref(*args, chunk=SK.KERNEL_CHUNK)
            outs = (torch.empty_like(args[0]),
                    torch.empty((B, H, N, hp), device=dev))
            dims, shape = (B, S, H, N, hp), list(SSD_SHAPE)
        mine = [(j[1], fn, regs) for j, (fn, regs) in zip(jobs, built)
                if j[0] == kernel]

        def runner(fn):
            def run():
                rc = fn(*(a.data_ptr() for a in args), None,
                        *(o.data_ptr() for o in outs), *dims, stream)
                if rc != 0:
                    raise SystemExit(f"scan_variants: launch failed ({rc})")
            return run

        ms = {name: [] for name, _, _ in mine}
        for name, fn, _ in mine + mine[::-1]:
            ms[name].append(timed(runner(fn), reps))
        for name, fn, regs in mine:
            runner(fn)()
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": kernel, "variant": name, "shape": shape,
                "ms": ms[name], "ptxas": regs,
                "max_abs_err_y": float((outs[0] - want[0]).abs().max()),
                "max_abs_err_h": float((outs[1] - want[1]).abs().max())}),
                flush=True)
        del args, want, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:2]], *sys.argv[2:4])
