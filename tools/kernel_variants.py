"""What bounds flash_attention and the pair kernels: time variants of their sources.

    python3 tools/kernel_variants.py [reps=10] [kernel ...]

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
  not held to 64, so seven CTAs an SM, not eight);
* density at the same pair list through its fused entry (cell arrays, ci,
  cj, shift): ``shared`` (the warp's marked elements spread over its lanes,
  32 at a time, each one's terms handed back to its slot's lane, not each
  lane computing its own slot's), ``shared_lanes2`` and ``shared_lanes4``
  (the same, with two or four lanes sharing a slot's cutoff pass),
  ``two_a_step`` (each lane's marked elements two at a time, so their
  dependent chains overlap), ``pairs2`` and ``pairs8`` (two or eight pairs
  a CTA, not four), ``every_element`` (every live partner marked and
  computed).

Prints one JSON line per variant (its ms per turn, registers, its largest
difference from the shipped kernel's output and whether it is the shipped
output bit for bit), after the card line.

The bf16 attention entry (``flash_attention_bf16``) is timed against an
older ``flash_attention.cu`` given on the command line, e.g. the parent's
(``git show HEAD~1:src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu > build/parent/flash_attention.cu``):

    python3 tools/kernel_variants.py 20 flash_attention_bf16 OLD.cu

at the five bf16 serve shapes of ``chip_smoke.py`` phase 13 (zamba2 hd 64,
granite-8b 32/8 hd 128, gemma-7b hd 256, gemma3-27b's local layers,
qwen1.5-32b at B = 1), in turns with the shipped source, OLD, the shipped
source's overlap steps undone one at a time (``no_overlap``: P V of tile j
before the scores of tile j + 1; ``one_stage``: that and rings of one slot,
so the next tile's K loads only once this tile's scores are formed and
its V only once P V is done), tuning variants (``stages3``: three slots
at hd 128; ``bk64``: tiles of 64 keys at hd 64 and 128, four slots;
``regs232``: 40 registers for the producer, 232 for the consumers;
``exp2f``: the accurate ``exp2f`` in place of ``ex2.approx.ftz``), a
diagnostic that computes no exponential (``no_exp``: wrong output, what
the exponentials cost), one without the softmax of tiles after the first
(``no_softmax``: P is the raw scores; what the products, loads and
barriers alone take) and bf16 ``scaled_dot_product_attention`` on the
same tensors. One JSON line per
shape and source: ms per turn, the share of the bound, registers, spill
bytes and dynamic shared memory of the instantiation that ran, whether the
output is within the bf16 tolerance of the plain version (one bf16
rounding plus 2e-3 of the scale) and whether it is the shipped output bit
for bit. OLD without ``flash_attention_bf16_smem_bytes`` (the source before the
Hopper kernel) gets its shared memory from its own ``bf16::Cfg`` formula.

The variants are diagnostics only; the port ships the sources as they are.
Naming kernels (``flash_attention``, ``force_pair``, ``density_pair``,
``flash_attention_bf16``) times only theirs. Stops without a CUDA device.
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

from chip_smoke import (BF16_FLASH_RTOL, bf16_err, bf16_flash_bound,  # noqa: E402
                        bf16_flash_cases, card_line, flash_bf16_resources,
                        qkv_inputs, sedov_setup)
from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
KDIR = os.path.join(ROOT, "src", "repro_torch", "kernels")
FLASH = os.path.join(KDIR, "flash_attention", "csrc", "flash_attention.cu")
PAIR = os.path.join(KDIR, "sph_pair", "csrc", "sph_pair.cu")


def shared_edits(lanes: int):
    """The density's element phase shared out: ``lanes`` lanes (1, 2 or 4)
    split a slot's cutoff pass, and the warp computes its marked elements
    32 at a time, one a lane, whatever slot they belong to; each element's
    terms go back through shared memory to its slot's lane, which adds
    them in ascending order (the same bits)."""
    scratch = ("  float* scratch = reinterpret_cast<float*>(dsm) + "
               "(size_t)warp * 2 * dside_floats(C);\n"
               "  const DSide I = dside_at(scratch, C);\n"
               "  const DSide J = dside_at(scratch + dside_floats(C), C);\n")
    loop = ("  for (int t0 = 0; t0 < 2 * C; t0 += 32) {\n"
            "    const int t = t0 + lane;\n")
    elements = (
        "    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // rho, drho, nngb\n"
        "    const int nmax = __reduce_max_sync(0xffffffffu, n);\n"
        "    for (int b0 = 0; b0 < nmax; b0 += 32) {\n"
        "      unsigned hit = 0;\n"
        "      const int m = min(32, n - b0);\n"
        "      for (int k = 0; k < m; ++k)\n"
        "        if (r2_to(x, Q, b0 + k) + kEps < reach) hit |= 1u << k;\n"
        "      for (; hit; hit &= hit - 1)\n"
        "        add3(sum, density_terms<KERNEL>(x, h, sw, sd, Q, b0 + __ffs((int)hit) - 1));\n"
        "    }\n"
        "    if (t < 2 * C) {\n")
    smem = "sizeof(float) * 2 * (size_t)dside_floats(args.C), stream);"
    kernel = ("template <int KERNEL>\n__global__ void __launch_bounds__(32 * "
              "kDensityWarps) density_pair_kernel")
    share = """\
constexpr int kShareFloats = 3 * 4 * 32 + 2 * 32;
struct Share {   // each lane's slot, (h, sigmas, side), terms, marks, offsets
  float4 *own, *hs, *terms;
  unsigned* hit;
  int* off;
};
__device__ __forceinline__ Share share_at(float* base) {
  Share s;
  s.own = reinterpret_cast<float4*>(base);
  s.hs = s.own + 32;
  s.terms = s.hs + 32;
  s.hit = reinterpret_cast<unsigned*>(s.terms + 32);
  s.off = reinterpret_cast<int*>(s.hit + 32);
  return s;
}

"""
    shared_elements = f"""\
    S.own[lane] = x;
    S.hs[lane] = make_float4(h, sw, sd, row ? 1.0f : 0.0f);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int nmax = __reduce_max_sync(0xffffffffu, n);
    for (int b0 = 0; b0 < nmax; b0 += 32) {{
      unsigned hit = 0;
      const int m = min(32, n - b0);
      for (int k = sub; k < m; k += {lanes})
        if (r2_to(x, Q, b0 + k) + kEps < reach) hit |= 1u << k;
      for (int o = 1; o < {lanes}; o <<= 1) hit |= __shfl_xor_sync(0xffffffffu, hit, o);
      const int cnt = sub == 0 ? __popc(hit) : 0;
      int end = cnt;
      for (int o = 1; o < 32; o <<= 1) {{
        const int v = __shfl_up_sync(0xffffffffu, end, o);
        if (lane >= o) end += v;
      }}
      const int off = end - cnt;
      const int total = __shfl_sync(0xffffffffu, end, 31);
      if (total == 0) continue;
      S.hit[lane] = hit;
      S.off[lane] = off;
      __syncwarp();
      for (int e0 = 0; e0 < total; e0 += 32) {{
        const int e = e0 + lane;
        if (e < total) {{
          int o = 0;
          for (int step = 16; step; step >>= 1)
            if (S.off[o + step] <= e) o += step;
          unsigned mk = S.hit[o];
          for (int j = e - S.off[o]; j; --j) mk &= mk - 1;
          const float4 hs = S.hs[o];
          S.terms[lane] = density_terms<KERNEL>(S.own[o], hs.x, hs.y, hs.z,
                                                hs.w != 0.0f ? J : I,
                                                b0 + __ffs((int)mk) - 1);
        }}
        __syncwarp();
        for (int q = max(off, e0); q < min(end, e0 + 32); ++q) add3(sum, S.terms[q - e0]);
        __syncwarp();
      }}
    }}
    if (t < 2 * C && sub == 0) {{
"""
    return [
        (kernel, share + kernel),
        (scratch,
         "  float* scratch = reinterpret_cast<float*>(dsm) + "
         "(size_t)warp * (kShareFloats + 2 * dside_floats(C));\n"
         "  const Share S = share_at(scratch);\n"
         "  const DSide I = dside_at(scratch + kShareFloats, C);\n"
         "  const DSide J = dside_at(scratch + kShareFloats + dside_floats(C), C);\n"),
        (loop, f"  const int sub = lane % {lanes};\n"
               f"  for (int t0 = 0; t0 < 2 * C; t0 += 32 / {lanes}) {{\n"
               f"    const int t = t0 + lane / {lanes};\n"),
        (elements, shared_elements),
        (smem, "sizeof(float) * (kShareFloats + 2 * (size_t)dside_floats(args.C)), "
               "stream);"),
    ]


VARIANTS = {
    "flash_attention": (FLASH, {
        # (old, new, n): the pattern is in both kernels (hd <= 128, 256)
        "expf": [("else return x * scale2;", "else return x * scale;"),
                 ("alpha = exp2f(m[r] - m_new);",
                  "alpha = expf(m[r] - m_new);", 2),
                 ("const float p = exp2f(s[n][2 * r + c] - m_new);",
                  "const float p = expf(s[n][2 * r + c] - m_new);", 2)],
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
    "density_pair": (PAIR, {
        "shared": shared_edits(1),
        "shared_lanes2": shared_edits(2),
        "shared_lanes4": shared_edits(4),
        "two_a_step": [(
            "      for (; hit; hit &= hit - 1)\n"
            "        add3(sum, density_terms<KERNEL>(x, h, sw, sd, Q, b0 + __ffs((int)hit) - 1));",
            "      while (hit) {\n"
            "        const int b = b0 + __ffs((int)hit) - 1;\n"
            "        hit &= hit - 1;\n"
            "        const int c = hit ? b0 + __ffs((int)hit) - 1 : -1;\n"
            "        hit &= hit - 1;\n"
            "        const float4 tb = density_terms<KERNEL>(x, h, sw, sd, Q, b);\n"
            "        add3(sum, tb);\n"
            "        if (c >= 0) add3(sum, density_terms<KERNEL>(x, h, sw, sd, Q, c));\n"
            "      }")],
        "pairs2": [("constexpr int kDensityWarps = 4;",
                    "constexpr int kDensityWarps = 2;")],
        "pairs8": [("constexpr int kDensityWarps = 4;",
                    "constexpr int kDensityWarps = 8;")],
        "every_element": [
            ("if (r2_to(x, Q, b0 + k) + kEps < reach) hit |= 1u << k;",
             "hit |= 1u << k;")],
    }),
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(name, src, edits):
    text = open(src).read()
    for old, new, *times in edits:
        n = times[0] if times else 1
        if text.count(old) != n:
            raise RuntimeError(f"{name}: pattern not {n} times in the "
                               f"source: {old!r}")
        text = text.replace(old, new)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib{name}.so")
    # the variant lies in OUT: its source's own headers (split_tf32.cuh,
    # bf16_mma.cuh) are found beside the source it was made from
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS,
                           f"-I{os.path.dirname(os.path.abspath(src))}",
                           f"-I{os.path.dirname(FLASH)}", "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    regs = [ln.split("Used ")[1].split(",")[0]
            for ln in lines if "Used" in ln and "registers" in ln]
    return name, lib, regs, lines


def takes_lse(name, entry):
    """Whether the variant ``name``'s source gives C entry ``entry`` the
    nullable ``float* lse`` before its stream (an older source may not)."""
    text = open(os.path.join(OUT, f"{name}.cu")).read()
    return re.search(rf"int {entry}\([^)]*float\* lse", text) is not None


def flash_caller(lib):
    lib.flash_attention_f32.argtypes = [_P] * 4 + [_I] * 8 + [_F, _P, _P]
    B, S, H, hd = 4, 2048, 32, 64
    q, k, v = qkv_inputs(B, S, S, H, H, hd, "cuda")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.flash_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), B, S, S, H, H, hd, 1, 0,
                                     0.0, None, stream)
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


def density_caller(lib, cells, pairs):
    lib.sph_density_pair.argtypes = [_P] * 17 + [_I] * 4 + [_P]
    cell_in = [cells.pos, cells.h, cells.mass, cells.mask]
    (ncells, C), P = cells.mask.shape, pairs.ci.shape[0]
    outs = [torch.empty((P, C), dtype=torch.float32, device="cuda")
            for _ in range(6)]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.sph_density_pair(
            *(t.data_ptr() for t in cell_in + cell_in),
            pairs.ci.data_ptr(), pairs.cj.data_ptr(), pairs.shift.data_ptr(),
            *(t.data_ptr() for t in outs), P, C, ncells, 0, stream)
        assert rc == 0, rc
        return outs
    return run


BF16_VARIANTS = {
    "no_overlap": [("constexpr bool kOverlap = true;",
                    "constexpr bool kOverlap = false;")],
    "one_stage": [("constexpr bool kOverlap = true;",
                   "constexpr bool kOverlap = false;"),
                  ("static constexpr int NS = HD <= 64 ? 4 : 2;",
                   "static constexpr int NS = 1;")],
    "stages3": [("static constexpr int NS = HD <= 64 ? 4 : 2;",
                 "static constexpr int NS = HD <= 64 ? 4 : (HD <= 128 ? 3 : 2);")],
    "bk64": [("static constexpr int BK = HD <= 128 ? 128 : 64;",
              "static constexpr int BK = 64;"),
             ("static constexpr int NS = HD <= 64 ? 4 : 2;",
              "static constexpr int NS = HD <= 128 ? 4 : 2;")],
    "no_softmax": [("          softmax(kt);               // while P V runs\n",
                    "")],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x;")],
    "regs232": [("PRODUCER_REGS = 24, CONSUMER_REGS = 240;",
                 "PRODUCER_REGS = 40, CONSUMER_REGS = 232;")],
    "exp2f": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
               "y = exp2f(x);")],
}


def old_bf16_smem(hd):
    """The pre-Hopper source's bf16::Cfg<hd>::bytes: two stages of K and V
    and Q, rows of hd + 8 bf16, 64 query rows, 64 keys a tile (32 at hd
    256)."""
    bk, rs = (64 if hd <= 128 else 32), hd + 8
    return 2 * (2 * (2 * bk * rs) + 64 * rs)


def bf16_ab(built, reps):
    """The shipped bf16 attention entry against OLD and the variants at the
    five bf16 serve shapes, in turns, beside bf16 SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_ref
    libs = {}
    for name, path, _, lines in built:
        lib = ctypes.CDLL(path)
        lse = takes_lse(name, "flash_attention_bf16")
        lib.flash_attention_bf16.argtypes = ([_P] * 4 + [_I] * 8 + [_F]
                                             + [_P] * (2 if lse else 1))
        lib.flash_attention_bf16.restype = _I
        libs[name] = (lib, lines, lse)
    shapes = [(label, shape, window)
              for label, shape, window, cap in bf16_flash_cases()
              if cap is None and label not in ("ragged-gqa-window",
                                                "offset-queries")]
    stream = torch.cuda.current_stream().cuda_stream
    for label, (B, S, T, H, K, hd), window in shapes:
        q, k, v = (t.bfloat16() for t in qkv_inputs(B, S, T, H, K, hd, "cuda"))
        want = flash_attention_ref(q, k, v, window=window)
        runs, outs = {}, {}
        for name, (lib, _, lse) in libs.items():
            o = torch.empty_like(q)

            def run(lib=lib, o=o, lse=lse):
                rc = lib.flash_attention_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, S, T, H, K, hd, 1, window or 0, 0.0,
                    *((None,) if lse else ()), stream)
                assert rc == 0, rc
            runs[name], outs[name] = run, o
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        if window is None:
            mask = dict(is_causal=True)
        else:
            qpos = torch.arange(S, device="cuda")[:, None] + (T - S)
            kpos = torch.arange(T, device="cuda")[None, :]
            mask = dict(attn_mask=(kpos <= qpos) & (kpos > qpos - window))
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                              **mask)
        turns = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                turns[n].append(time_ms(runs[n], reps))
        bound = bf16_flash_bound(B, S, T, H, K, hd, window)
        for name, (lib, lines, _) in (list(libs.items())
                                      + [("sdpa", (None, [], False))]):
            row = {"shape": label, "dims": [B, S, T, H, K, hd],
                   "window": window, "source": name, "ms": turns[name],
                   "bound_ms": bound["bound_ms"],
                   "share_of_bound": bound["bound_ms"] / min(turns[name])}
            if lib is not None:
                runs[name]()
                torch.cuda.synchronize()
                err, excess, ok = bf16_err(outs[name], want, BF16_FLASH_RTOL)
                try:
                    fn = lib.flash_attention_bf16_smem_bytes
                    fn.argtypes, fn.restype = [_I], _I
                    smem, smem_from = fn(hd), "library"
                except AttributeError:
                    smem, smem_from = old_bf16_smem(hd), "bf16::Cfg formula"
                res = flash_bf16_resources(lines, hd)
                # what ptxas said of the wgmma sequences (a serialization
                # would show here)
                row["ptxas_notes"] = [
                    ln.split("info    :")[-1].strip()[:160] for ln in lines
                    if ("wgmma" in ln or "warpgroup" in ln)
                    and f"ILi{hd}ELb0E" in ln]
                row.update(res, dynamic_smem_bytes=smem,
                           smem_from=smem_from, max_abs_err=err,
                           excess_over_one_rounding=excess,
                           within_bf16_tolerance=ok,
                           bitwise_shipped=torch.equal(
                               outs[name], outs["bf16_shipped"]))
            print(json.dumps(row), flush=True)
        del q, k, v, qt, kt, vt, want, runs, outs
        torch.cuda.empty_cache()


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


def main(reps: int = 10, *args: str) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    old = next((os.path.abspath(a) for a in args if a.endswith(".cu")), None)
    kernels = [a for a in args if not a.endswith(".cu")]
    chosen = {k: v for k, v in VARIANTS.items() if not kernels or k in kernels}
    jobs = [(f"{kern}_{v}", src, edits)
            for kern, (src, vs) in chosen.items()
            for v, edits in [("shipped", [])] + list(vs.items())]
    if "flash_attention_bf16" in kernels:
        jobs += [(f"bf16_{v}", FLASH, edits)
                 for v, edits in [("shipped", [])] + list(BF16_VARIANTS.items())]
        if old:
            jobs.append(("bf16_old", old, []))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    print(card_line(), flush=True)
    if "flash_attention_bf16" in kernels:
        bf16_ab([b for b in built if b[0].startswith("bf16_")], reps)
    if not chosen:
        return 0
    from repro_torch.kernels.sph_pair import ops
    spec, cells, pairs, thermo = sedov_setup("cuda")
    force_in = ops.force_inputs(cells, pairs, *thermo)
    for kern in chosen:
        mine = [(n, lib, regs) for n, lib, regs, _ in built
                if n.startswith(kern)]
        runs = {}
        for n, lib, _ in mine:
            cl = ctypes.CDLL(lib)
            runs[n] = (flash_caller(cl) if kern == "flash_attention"
                       else force_caller(cl, force_in) if kern == "force_pair"
                       else density_caller(cl, cells, pairs))
        ref = [t.clone() for t in runs[f"{kern}_shipped"]()]
        turns = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                turns[n].append(time_ms(runs[n], reps))
        for n, _, regs in mine:
            got = runs[n]()
            diff = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            same = all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                       for g, r in zip(got, ref))
            print(json.dumps({"variant": n, "ms": turns[n], "registers": regs,
                              "max_abs_diff_vs_shipped": diff,
                              "bitwise_shipped": same}), flush=True)
        del runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) if a.isdigit() else a for a in sys.argv[1:])))
