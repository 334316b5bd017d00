// Fused SSD (Mamba-2) scan for NVIDIA Hopper (sm_90a), products on the
// tensor cores at f32 accuracy: an f32 entry and a bf16 entry (below).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:ssd_scan
// (body _ssd_kernel): the scalar-decay-per-head SSM
//     h_t = exp(dt_t A_h) h_{t-1} + dt_t B_t (x) u_t,   y_t = C_t h_t + D_h u_t
// in the chunked matmul form. The TPU kernel holds one (batch, head) strip
// in VMEM and carries the (N, hp) state across chunks with lax.scan; here
// one CTA of NW = 4 warps owns one (batch, head) and walks the chunks in
// order: the loop over chunks takes the place of the lax.scan. Per chunk
// of QC = 64 steps (steps past S load as zeros, and zero dt makes them
// inert, so the ragged last chunk needs no padding in device memory):
//   1. u (QC, hp), B (QC, N) and dt (QC) of the next chunk are copied into
//      shared memory with cp.async (16-byte pieces; dt, strided by H, in
//      4-byte ones) while this chunk is computed (two buffers); each warp
//      loads its own rows of C straight into registers;
//   2. L = cumsum(dt A log2 e), a warp scan (__shfl_up_sync), each warp
//      its own copy, with w_s = exp(L_QC - L_s) dt_s;
//   3. each warp owns 16 rows t: S = C B^T on the 8-step blocks at or
//      below the diagonal, masked and scaled in registers into
//      M[t][s] = S exp(L_t - L_s) dt_s (s <= t, else 0);
//   4. y = M u + (exp(L_t) C) h + D u, stored from registers;
//   5. h = exp(L_QC) h + (B w)^T u, on 16 x 8 tiles of the state that each
//      warp keeps in registers in f32 across chunks; after the chunk the
//      state is split into TF32 big and small parts once, for the whole
//      CTA, into shared memory, where step 4 of the next chunk reads it.
// The chunk is 64, not the model's 128: the working set (106.5 KB at
// N = hp = 64) keeps two CTAs an SM, so B*H = 256 CTAs fill the 132 SMs in
// one wave. The result is chunk-invariant up to rounding. (NW = 8, two
// warps on each 16 rows, each on half the columns, is slower: the variants
// in tools/scan_variants.py.)
//
// Products: mma.sync m16n8k8 in TF32, each split into three (flash
// attention's scheme): every operand x is big + small, each product
// accumulates small*big + big*small + big*big in f32, which keeps the
// error near 1e-6 of the result's scale (2e-4 is the plain version's
// tolerance). The k index of every 8-wide step runs over (2t, 2t + 1)
// pairs, so a thread's S accumulator (rows g, g + 8; steps 2t, 2t + 1 of a
// block) is already its A fragment of M u, and B's fragment of C B^T is
// one 8-byte load. Row strides of hp + 4 (u, the split state) and N + 8
// (B) floats keep rows 16-byte aligned for cp.async and the fragment loads
// free of bank conflicts (the update's A fragment of B, read down a column,
// is the one two-way conflict). No atomics: run to run bitwise.
//
// Bound on the H100 SXM at its 700 W limit (495 TFLOP/s TF32 on the tensor
// cores, 67 TFLOP/s f32 outside them, 3.35 TB/s HBM): at the zamba2-1.2b
// prefill shape (B 4, S 2048, H 64, hp = N = 64) the function needs 9.42
// GFLOP (the least count of the chunked form over chunk lengths) and moves
// 0.28 GB: at f32 accuracy on the tensor cores 3 x 9.42 GFLOP / 495
// TFLOP/s = 0.057 ms, so the bytes bound it, 0.083 ms (the f32 FMA figure
// is 0.141 ms). The first version of this kernel (every product as fmaf
// from shared memory) took ~1.0-1.1 ms there; this one ~0.4 ms (H100 80GB
// HBM3, 700 W; PERF.md, chip_smoke.py). What bounds it
// (tools/scan_variants.py): issuing the instructions of the three-product
// split (with one TF32 product it takes ~0.26 ms; with both parts rounded
// by cvt.rna.tf32.f32, several instructions each on this card, ~0.63 ms),
// 8 warps an SM with little room between dependent instructions; not the
// bytes, the tensor cores or the causal imbalance between warps. Two CTAs
// an SM beat one (one wave of the 256 CTAs, not two).
//
// bf16 entry (ssd_scan_bf16): u, B, C and y in bf16; dt, A, D, h0 and the
// final state in f32; the function is the f32 entry's (the TPU kernel
// upcasts everything): f32 arithmetic from the bf16 inputs, y rounded to
// bf16 once. It has two routes, by (N, hp).
//
// (N, hp) = (64, 64), zamba2-1.2b's: ssd_bf16_hopper, designed for this
// card. Its bound at zamba2's prefill shape is the bf16 bytes, 0.0426 ms;
// what holds a kernel back from it is each CTA's chain of dependent chunks
// and the instructions each chunk issues, so the design keeps the bf16
// operands as they are and spends tensor-core passes, not instructions:
// - One CTA of 160 threads per (head, batch): a producer warp and one
//   consumer warpgroup. Chunks of QC = 64 steps stream through a ring of
//   NS = 2 stages: the producer's lane 0 loads u (4-D tensor map (hp, H, S,
//   B)), B and C ((N, 1, S, B)) of a chunk as 64 x 64 bf16 TMA boxes with
//   the 128-byte swizzle (rows past S read as zeros), its lanes load dt
//   (strided by H: not a TMA box) with zeros past S, so those steps are
//   inert; a full mbarrier (two arrivals and the boxes' bytes) and an
//   empty one (the consumers' four warps) a stage. Nothing is widened.
// - A bf16 value times a bf16 value is exact in f32, so C B^T is one
//   wgmma m64n64k16 pass (both K-major, from the ring). An f32 operand x is
//   taken as NP = 2 bf16 pieces, x1 = bf16(x), x2 = bf16(x - x1) (within
//   2^-16 of x), each product of a piece with a bf16 value exact: y and h
//   stay within 2e-5 of their scale of a float64 oracle, one piece lands
//   above 2e-4 (tests/test_torch_lm_kernels.py, split_bf16_ssd). TF32 would
//   want both operands K-major; u lands MN-major.
// - Per chunk (L = cumsum(dt A log2 e), each warp its own copy, w_s =
//   2^(L_QC - L_s) dt_s): S = C B^T; y = C h over the state's pieces (h
//   MN-major in shared memory, p contiguous); M[t][s] = S 2^(L_t - L_s)
//   dt_s for s <= t (ex2.approx.ftz), else 0, rounded in place into its
//   pieces as the register A operand (a wgmma accumulator's two 8-column
//   blocks are one k-step's A fragment); y = 2^(L_t) y + M u (u MN-major as
//   it lands); y + D u rounded to bf16 once and stored from registers,
//   rows past S nowhere. The state h (N x hp, f32) lives in the warpgroup's
//   wgmma accumulator for the whole sequence: h = 2^(L_QC) h + B^T (w u),
//   B^T the MN-major A operand read from B's tile as it lands, w u in
//   pieces written beside u (the same swizzled places); after the update h
//   is written as its pieces for the next chunk's C h. 7 passes of a 64^3
//   product a chunk; 85,536 bytes of shared memory and 168 registers a
//   thread, two CTAs an SM.
// - Overlap: C B^T and C h are issued before L, w u and M are formed, the
//   state update beside M u; the other CTA on the SM fills the tensor
//   cores while this one's chain completes (waiting on each group as soon
//   as it is issued measured within the spread). No atomics: run to run
//   bitwise. The producer's waits trap after ~10 s of clock: it waits for
//   each stage to be freed and, at the end, for the last stages' loads, so
//   a load that never lands, or a stage not freed while chunks remain to
//   load, ends the launch with an error and does not hang the card. The
//   consumers' waits are untimed: ptxas of CUDA 12.9 fails with a
//   segmentation fault on this kernel when they carry the clock test.
// Times on the H100 (PERF.md, chip_smoke.py phase 13,
// tools/scan_variants.py ssd_scan_bf16 with its one-stage, three-piece and
// register-cap variants).
//
// The other eight (N, hp) (reduced configurations only) keep the first
// bf16 kernel, ssd_scan_kernel<N, HP, bf16_t>: u and B read in 16-byte
// pieces and widened into the f32 kernel's shared-memory tiles (plain
// loads, not cp.async), C's fragments widened as they are loaded, then the
// f32 entry's arithmetic. A 64-column box and the 128-byte swizzle do not
// fit 16 or 32 bf16 columns.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int QC = 64;       // internal chunk length
constexpr int NR = QC / 16;  // 16-row blocks of a chunk
constexpr int NW = 4;        // warps per CTA
constexpr int NH = NW / NR;  // warps on each row block, each on hp / NH columns
constexpr int NT = 32 * NW;
constexpr float kLog2e = 1.4426950408889634f;

template <int N, int HP>
struct Cfg {
  static constexpr int US = HP + 4;   // row stride of u and the split state
  static constexpr int BS = N + 8;    // row stride of B
  static constexpr int u_off = 0;                   // [2][QC][US]
  static constexpr int b_off = u_off + 2 * QC * US; // [2][QC][BS]
  static constexpr int hb_off = b_off + 2 * QC * BS;// [N][US] state, big
  static constexpr int hs_off = hb_off + N * US;    // [N][US] state, small
  static constexpr int dt_off = hs_off + N * US;    // [2][QC]
  static constexpr int l_off = dt_off + 2 * QC;     // [NW][QC] L, log2 units
  static constexpr int w_off = l_off + NW * QC;     // [NW][QC] w
  static constexpr size_t bytes = sizeof(float) * (w_off + NW * QC);
  static constexpr int PB = HP / 8;        // 8-column blocks of u, y, h
  static constexpr int PBW = PB / NH;      // of them a warp's rows of y
  static_assert(PBW * NH == PB, "hp must split over a row block's warps");
  // the state's 16 x 8 tiles, TPW a warp, all in one 16-row block
  static constexpr int TILES = (N / 16) * PB;
  static constexpr int TPW = TILES >= NW ? TILES / NW : 1;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = big + small for a split TF32 product: big is x with its low 13 bits
// cleared (its TF32 part), small = x - big, exact in f32. The tensor cores
// read a TF32 operand's top 19 bits only, so small enters its products cut
// to TF32 too: what is lost lies below 2^-20 of x. Two operations; a
// rounded split (cvt.rna.tf32.f32 twice, several operations each on this
// card) makes the kernel ~1.6x slower (tools/scan_variants.py).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at f32 accuracy: the two cross terms, then big * big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

// A fragment (rows g, g + 8; k over (2t, 2t + 1)) from four values
__device__ __forceinline__ void a_fragment(float x0, float x1, float x2, float x3,
                                           uint32_t (&fb)[4], uint32_t (&fs)[4]) {
  split(x0, fb[0], fs[0]);
  split(x1, fb[1], fs[1]);
  split(x2, fb[2], fs[2]);
  split(x3, fb[3], fs[3]);
}

// the element type of u, B, C and y: float, or bf16 read as 16-bit words
using bf16_t = __nv_bfloat16;

// two neighbouring values of a row as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16_t* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 8 bf16 from global memory (16 bytes; zeros if !valid) widened into 8
// f32 in shared memory
__device__ __forceinline__ void widen8(float* dst, const bf16_t* src, bool valid) {
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (valid) x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

template <int N, int HP, typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hout, int S, int H) {
  constexpr bool F32 = sizeof(T) == sizeof(float);
  using CF = Cfg<N, HP>;
  constexpr int US = CF::US, BS = CF::BS, PB = CF::PB, PBW = CF::PBW;
  constexpr int TPW = CF::TPW;
  constexpr int KN = N / 8;     // k-steps over the state
  constexpr int SB = QC / 8;    // 8-step blocks of a chunk
  extern __shared__ __align__(16) float sm[];
  uint32_t* Hb = reinterpret_cast<uint32_t*>(sm + CF::hb_off);
  uint32_t* Hs = reinterpret_cast<uint32_t*>(sm + CF::hs_off);
  float* Lw = sm + CF::l_off + (threadIdx.x >> 5) * QC;   // this warp's
  float* Ww = sm + CF::w_off + (threadIdx.x >> 5) * QC;

  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this warp's rows tr, tr + 8 of a chunk and its columns of y
  const int tr = 16 * (warp % NR) + g, pw = (warp / NR) * PBW;
  const int nsb = 2 * (warp % NR) + 2;   // blocks with s <= its last row
  const float a2 = A[hh] * kLog2e, dd = D[hh];

  const size_t row = (size_t)H * HP;   // stride of one step in u and y
  const T* ub = u + (size_t)b * S * row + (size_t)hh * HP;
  T* yb = y + (size_t)b * S * row + (size_t)hh * HP;
  const T* bb = Bm + (size_t)b * S * N;
  const T* cb = Cm + (size_t)b * S * N;
  const float* db = dt + (size_t)b * S * H + hh;

  // the state: this warp's tiles, rows 16 nb + (g, g + 8), columns
  // 8 (pd0 + k) + (2t, 2t + 1), in f32 registers across chunks
  const int tile0 = warp * TPW;
  const bool owns = tile0 < CF::TILES;
  const int nb = owns ? tile0 / PB : 0, pd0 = owns ? tile0 % PB : 0;
  const size_t state_off = ((size_t)b * H + hh) * N * HP;
  float hacc[TPW][4];
#pragma unroll
  for (int k = 0; k < TPW; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 16 * nb + g + 8 * (c >> 1), p = 8 * (pd0 + k) + 2 * t4 + (c & 1);
      hacc[k][c] = owns && h0 != nullptr ? h0[state_off + (size_t)n * HP + p] : 0.f;
    }
  // the state, split once for the CTA, where every warp's C h reads it
  auto store_split = [&]() {
    if (!owns) return;
#pragma unroll
    for (int k = 0; k < TPW; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (16 * nb + g + 8 * r) * US + 8 * (pd0 + k) + 2 * t4;
        uint32_t b0, s0, b1, s1;
        split(hacc[k][2 * r], b0, s0);
        split(hacc[k][2 * r + 1], b1, s1);
        *reinterpret_cast<uint2*>(Hb + at) = make_uint2(b0, b1);
        *reinterpret_cast<uint2*>(Hs + at) = make_uint2(s0, s1);
      }
  };
  store_split();

  auto load_chunk = [&](int ck, int buf) {
    const int c0 = ck * QC;
    float* Us = sm + CF::u_off + buf * QC * US;
    float* Bs = sm + CF::b_off + buf * QC * BS;
    if constexpr (F32) {
      for (int i = tid; i < QC * HP / 4; i += NT) {
        const int t = i / (HP / 4), p = (i % (HP / 4)) * 4;
        const bool in = c0 + t < S;
        cp_async16(Us + t * US + p, ub + (in ? (size_t)(c0 + t) * row + p : 0), in);
      }
      for (int i = tid; i < QC * N / 4; i += NT) {
        const int t = i / (N / 4), n = (i % (N / 4)) * 4;
        const bool in = c0 + t < S;
        cp_async16(Bs + t * BS + n, bb + (in ? (size_t)(c0 + t) * N + n : 0), in);
      }
    } else {
      for (int i = tid; i < QC * HP / 8; i += NT) {
        const int t = i / (HP / 8), p = (i % (HP / 8)) * 8;
        const bool in = c0 + t < S;
        widen8(Us + t * US + p, ub + (in ? (size_t)(c0 + t) * row + p : 0), in);
      }
      for (int i = tid; i < QC * N / 8; i += NT) {
        const int t = i / (N / 8), n = (i % (N / 8)) * 8;
        const bool in = c0 + t < S;
        widen8(Bs + t * BS + n, bb + (in ? (size_t)(c0 + t) * N + n : 0), in);
      }
    }
    for (int t = tid; t < QC; t += NT) {
      const bool in = c0 + t < S;
      cp_async4(sm + CF::dt_off + buf * QC + t,
                db + (in ? (size_t)(c0 + t) * H : 0), in);
    }
    cp_async_commit();
  };
  // this warp's rows (tr, tr + 8) of C as A fragments, from memory
  auto load_c = [&](int c0, float (&cf)[KN][4]) {
    const int r0 = c0 + tr, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      float2 x0 = make_float2(0.f, 0.f), x1 = x0;
      if (r0 < S) x0 = load2(cb + (size_t)r0 * N + 8 * kk + 2 * t4);
      if (r1 < S) x1 = load2(cb + (size_t)r1 * N + 8 * kk + 2 * t4);
      cf[kk][0] = x0.x;
      cf[kk][1] = x1.x;
      cf[kk][2] = x0.y;
      cf[kk][3] = x1.y;
    }
  };

  const int nchunks = (S + QC - 1) / QC;
  load_chunk(0, 0);
  for (int ck = 0; ck < nchunks; ++ck) {
    const int c0 = ck * QC, buf = ck & 1;
    float cf[KN][4];
    load_c(c0, cf);        // in flight across the barrier
    cp_async_wait_all();   // this thread's copies of chunk ck
    __syncthreads();       // everyone's; the split state; chunk ck - 1 read
    if (ck + 1 < nchunks) load_chunk(ck + 1, buf ^ 1);
    const float* Uc = sm + CF::u_off + buf * QC * US;
    const float* Bc = sm + CF::b_off + buf * QC * BS;
    const float* dtc = sm + CF::dt_off + buf * QC;

    // 2. L (log2 units) over the chunk, two steps a lane, and w
    float dq;
    {
      const float2 dv = *reinterpret_cast<const float2*>(dtc + 2 * lane);
      const float x0 = dv.x * a2, x1 = dv.y * a2;
      float incl = x0 + x1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float l0 = excl + x0, l1 = l0 + x1;
      const float lend = __shfl_sync(0xffffffffu, l1, 31);
      *reinterpret_cast<float2*>(Lw + 2 * lane) = make_float2(l0, l1);
      *reinterpret_cast<float2*>(Ww + 2 * lane) =
          make_float2(exp2f(lend - l0) * dv.x, exp2f(lend - l1) * dv.y);
      dq = exp2f(lend);
    }
    __syncwarp();

    // 3. S = C B^T on the blocks at or below the diagonal, then M in place
    float sacc[SB][4];
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t ab[4], as[4];
      a_fragment(cf[kk][0], cf[kk][1], cf[kk][2], cf[kk][3], ab, as);
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        if (j < nsb) {
          const float2 bv = *reinterpret_cast<const float2*>(
              Bc + (8 * j + g) * BS + 8 * kk + 2 * t4);
          uint32_t bb0, bs0, bb1, bs1;
          split(bv.x, bb0, bs0);
          split(bv.y, bb1, bs1);
          mma3(sacc[j], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    }
    const float lt0 = Lw[tr], lt1 = Lw[tr + 8];
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      if (j < nsb) {
        const int s0 = 8 * j + 2 * t4;
        const float2 ls = *reinterpret_cast<const float2*>(Lw + s0);
        const float2 ds = *reinterpret_cast<const float2*>(dtc + s0);
        sacc[j][0] = s0 <= tr ? sacc[j][0] * exp2f(lt0 - ls.x) * ds.x : 0.f;
        sacc[j][1] = s0 + 1 <= tr ? sacc[j][1] * exp2f(lt0 - ls.y) * ds.y : 0.f;
        sacc[j][2] = s0 <= tr + 8 ? sacc[j][2] * exp2f(lt1 - ls.x) * ds.x : 0.f;
        sacc[j][3] = s0 + 1 <= tr + 8 ? sacc[j][3] * exp2f(lt1 - ls.y) * ds.y : 0.f;
      }
    }

    // 4. y = M u + (exp(L_t) C) h + D u on the warp's columns
    float yacc[PBW][4];
#pragma unroll
    for (int d = 0; d < PBW; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c) yacc[d][c] = 0.f;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      if (j < nsb) {
        // M's A fragment: its accumulator as it stands (k t <-> s 2t,
        // k t + 4 <-> s 2t + 1)
        uint32_t pb[4], ps[4];
        a_fragment(sacc[j][0], sacc[j][2], sacc[j][1], sacc[j][3], pb, ps);
        const float* urow = Uc + (8 * j + 2 * t4) * US + 8 * pw + g;
#pragma unroll
        for (int d = 0; d < PBW; ++d) {
          uint32_t bb0, bs0, bb1, bs1;
          split(urow[8 * d], bb0, bs0);
          split(urow[US + 8 * d], bb1, bs1);
          mma3(yacc[d], pb, ps, bb0, bb1, bs0, bs1);
        }
      }
    }
    load_c(c0, cf);        // again: the first copy is not kept live
    const float e0 = exp2f(lt0), e1 = exp2f(lt1);
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t ab[4], as[4];
      a_fragment(cf[kk][0] * e0, cf[kk][1] * e1, cf[kk][2] * e0,
                 cf[kk][3] * e1, ab, as);
      const int hr = (8 * kk + 2 * t4) * US + 8 * pw + g;
#pragma unroll
      for (int d = 0; d < PBW; ++d)
        mma3(yacc[d], ab, as, Hb[hr + 8 * d], Hb[hr + US + 8 * d],
             Hs[hr + 8 * d], Hs[hr + US + 8 * d]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = tr + 8 * r;
      if (c0 + t < S) {
        T* yrow = yb + (size_t)(c0 + t) * row + 8 * pw + 2 * t4;
        const float* urow = Uc + t * US + 8 * pw + 2 * t4;
#pragma unroll
        for (int d = 0; d < PBW; ++d) {
          const float2 uv = *reinterpret_cast<const float2*>(urow + 8 * d);
          store2(yrow + 8 * d, yacc[d][2 * r] + uv.x * dd,
                 yacc[d][2 * r + 1] + uv.y * dd);
        }
      }
    }

    // 5. h = exp(L_QC) h + (B w)^T u on this warp's tiles
    if (owns) {
#pragma unroll
      for (int k = 0; k < TPW; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) hacc[k][c] *= dq;
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const int s0 = 8 * j + 2 * t4;
        const float2 wv = *reinterpret_cast<const float2*>(Ww + s0);
        const float* b0r = Bc + s0 * BS + 16 * nb + g;
        const float* b1r = b0r + BS;
        uint32_t ab[4], as[4];
        a_fragment(b0r[0] * wv.x, b0r[8] * wv.x, b1r[0] * wv.y, b1r[8] * wv.y,
                   ab, as);
        const float* urow = Uc + s0 * US + g;
#pragma unroll
        for (int k = 0; k < TPW; ++k) {
          const int d = pd0 + k;
          uint32_t bb0, bs0, bb1, bs1;
          split(urow[8 * d], bb0, bs0);
          split(urow[US + 8 * d], bb1, bs1);
          mma3(hacc[k], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    }
    __syncthreads();   // every warp has read the split state and chunk ck
    store_split();
  }
  if (owns) {
#pragma unroll
    for (int k = 0; k < TPW; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 16 * nb + g + 8 * (c >> 1), p = 8 * (pd0 + k) + 2 * t4 + (c & 1);
        hout[state_off + (size_t)n * HP + p] = hacc[k][c];
      }
  }
}

template <int N, int HP, typename T>
cudaError_t launch(const T* u, const float* dt, const float* A,
                   const T* Bm, const T* Cm, const float* D,
                   const float* h0, T* y, float* hout, int B, int S,
                   int H, cudaStream_t stream) {
  const size_t smem = Cfg<N, HP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<N, HP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  ssd_scan_kernel<N, HP, T><<<dim3(H, B), NT, smem, stream>>>(
      u, dt, A, Bm, Cm, D, h0, y, hout, S, H);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 at N = hp = 64: Hopper
// ssd_bf16_hopper: the bf16 entry at (N, hp) = (64, 64), zamba2-1.2b's
// (the header comment says how and why).
namespace hop {
constexpr int QC = 64;                   // steps a chunk
constexpr int NS = 2;                    // chunk stages of the ring
constexpr int NP = 2;                    // bf16 pieces of an f32 operand
constexpr int NT = 160;                  // consumer warpgroup + producer warp
constexpr uint32_t TILE = QC * 64 * 2;   // one 64 x 64 bf16 tile, 8 KB
constexpr uint32_t STAGE = 3 * TILE;     // u, B, C of a chunk
constexpr uint32_t h_off = NS * STAGE;            // [NP] the state's pieces
constexpr uint32_t wu_off = h_off + NP * TILE;    // [NP] w u's pieces
constexpr uint32_t dt_off = wu_off + NP * TILE;   // [NS][QC] f32
constexpr uint32_t lw_off = dt_off + NS * QC * 4; // [4 warps][2][QC] L, w
constexpr uint32_t bar_off = lw_off + 4 * 2 * QC * 4;
constexpr int nbar = 2 * NS;                      // full, empty of each stage
// + 1,024: the base is rounded up to the swizzle's 1,024-byte atom
constexpr size_t bytes = bar_off + 8 * nbar + 1024;
static_assert(2 * (bytes + 1024) <= 233472, "two CTAs an SM");
}  // namespace hop

// mbarrier arrivals, TMA loads, wgmma descriptors and groups, and the
// tensor-map lookup are hopper.cuh's, shared with flash_attention.cu; the
// waits and the wgmma forms (transpose flags as template arguments) are
// this kernel's.

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// the same, trapping after ~10 s: only the producer warp's waits are timed
// (ptxas of CUDA 12.9 fails with a segmentation fault on this kernel when
// the consumers' waits carry the clock test, inlined or not); what they
// cover is in the header comment
__device__ __forceinline__ void mbar_wait_timed(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (!mbar_try(bar, parity)) {
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// shared-memory writes of this thread made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumer warpgroup's 128 threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

#define SSD_ACC32                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])
#define SSD_D32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"

// D (64 x 64, f32) {=, +=} A B, A (64 x 16) and B (16 x 64) bf16 in shared
// memory; TA, TB: 0 K-major, 1 MN-major (the transpose forms)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SSD_ACC32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) += A B, A bf16 in registers (a wgmma accumulator's
// layout, two 8-column blocks a k-step), B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SSD_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
#undef SSD_ACC32
#undef SSD_D32

// two f32 rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xFFFF0000u);
}

// (lo, hi) as NP bf16 pairs whose sum is (lo, hi) to within 2^-8NP: piece k
// rounds what the pieces before it leave
__device__ __forceinline__ void pieces(float lo, float hi,
                                       uint32_t (&p)[hop::NP]) {
#pragma unroll
  for (int k = 0; k < hop::NP; ++k) {
    p[k] = pack_bf16(lo, hi);
    lo -= bf16_lo(p[k]);
    hi -= bf16_hi(p[k]);
  }
}

// 2^x on the SFU: ex2.approx.ftz, within 2 ulp (exp2f's own bound); a
// result under 2^-126 flushes to 0, far below what M's products can carry
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte column block `blk` of row `row` in a 64 x 64 bf16
// tile stored with the 128-byte swizzle (a TMA box, a wgmma operand)
__device__ __forceinline__ uint32_t sw128(int row, int blk) {
  return row * 128 + ((blk ^ (row & 7)) << 4);
}

// two CTAs of five warps an SM: ptxas keeps 168 registers a thread (8
// bytes spilled), not 65,536 / 320: the register file is split among the
// SM's four sub-partitions and ten warps put three on one of them (3 x 32
// x 168 <= 16,384). A cap of 200 in its place (tools/scan_variants.py
// maxnreg200) was no faster in one call of three, and under it the
// variants that took 174-196 registers ran one CTA an SM: at zamba2's
// batch 4 they took 1.75-2.0 x their batch-1 time, the 168-register builds
// 1.2 x.
__global__ void __launch_bounds__(hop::NT, 2)
ssd_bf16_hopper(const __grid_constant__ CUtensorMap tu,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc,
                const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ D, const float* __restrict__ h0,
                uint16_t* __restrict__ y, float* __restrict__ hout, int S,
                int H) {
  constexpr int QC = hop::QC, NS = hop::NS, NP = hop::NP;
  constexpr uint32_t TILE = hop::TILE, STAGE = hop::STAGE;
  extern __shared__ __align__(1024) uint8_t ssd_smem[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(ssd_smem) + 1023u) & ~1023u;
  uint8_t* gbase =
      ssd_smem + (base - (uint32_t)__cvta_generic_to_shared(ssd_smem));
  // stage s: u, B, C tiles; then the state's and w u's pieces, dt, L and w,
  // the mbarriers
  auto u_s = [&](int s) { return base + s * STAGE; };
  auto full = [&](int s) { return base + hop::bar_off + 8 * s; };
  auto empty = [&](int s) { return base + hop::bar_off + 8 * (NS + s); };
  float* dts = reinterpret_cast<float*>(gbase + hop::dt_off);

  const int hh = blockIdx.x, b = blockIdx.y;
  const int nchunks = (S + QC - 1) / QC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 2);     // expect_tx with the tiles, then dt
      mbar_init(empty(s), 4);    // the consumers' four warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ------------------------------------------------------------ producer
    // chunk i into stage i % NS once the consumers have freed it: u, B and
    // C by TMA (rows past S read as zeros), dt by the warp's lanes (zeros
    // past S, so those steps are inert)
    const float* db = dt + (size_t)b * S * H + hh;
    for (int i = 0; i < nchunks; ++i) {
      const int s = i % NS, c0 = i * QC;
      mbar_wait_timed(empty(s), ((i / NS) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), STAGE);
        tma_load4(u_s(s), &tu, 0, hh, c0, b, full(s));
        tma_load4(u_s(s) + TILE, &tb, 0, 0, c0, b, full(s));
        tma_load4(u_s(s) + 2 * TILE, &tc, 0, 0, c0, b, full(s));
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        dts[s * QC + t] = c0 + t < S ? db[(size_t)(c0 + t) * H] : 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full(s));
    }
    // the last stages' loads have landed (a load that never completes
    // traps here, not in the consumers' untimed waits)
    for (int i = max(nchunks - NS, 0); i < nchunks; ++i)
      mbar_wait_timed(full(i % NS), (i / NS) & 1);
    return;
  }

  // -------------------------------------------------------------- consumers
  const int g = lane >> 2, t4 = lane & 3;
  const int tr0 = 16 * warp + g;           // this thread's rows tr0, tr0 + 8
  const float a2 = A[hh] * kLog2e, dd = D[hh];
  float* Lw = reinterpret_cast<float*>(gbase + hop::lw_off) + warp * 2 * QC;
  float* Ww = Lw + QC;
  const uint32_t hp_s = base + hop::h_off, wu_s = base + hop::wu_off;
  uint8_t* hp_g = gbase + hop::h_off;
  uint8_t* wu_g = gbase + hop::wu_off;

  // the state in the wgmma accumulator's layout: element 4n + 2r + c is
  // row 16 warp + g + 8r, column 8n + 2 t4 + c
  const size_t state_off = ((size_t)b * H + hh) * 64 * 64;
  float hacc[32];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 v = make_float2(0.f, 0.f);
      if (h0 != nullptr)
        v = *reinterpret_cast<const float2*>(
            h0 + state_off + (size_t)(tr0 + 8 * r) * 64 + 8 * n + 2 * t4);
      hacc[4 * n + 2 * r] = v.x;
      hacc[4 * n + 2 * r + 1] = v.y;
    }
  // the state's pieces, where the next chunk's C h reads them
  auto store_pieces = [&]() {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t p[NP];
        pieces(hacc[4 * n + 2 * r], hacc[4 * n + 2 * r + 1], p);
        const uint32_t at = sw128(tr0 + 8 * r, n) + 4 * t4;
#pragma unroll
        for (int k = 0; k < NP; ++k)
          *reinterpret_cast<uint32_t*>(hp_g + k * TILE + at) = p[k];
      }
    fence_async_shared();
  };
  store_pieces();

  float sacc[32], yacc[32];
  uint32_t pa[NP][4][4];   // M's pieces: k-step j's A fragments
  for (int ck = 0; ck < nchunks; ++ck) {
    const int s = ck % NS, c0 = ck * QC;
    const uint32_t us = u_s(s), bs = us + TILE, cs = us + 2 * TILE;
    const uint8_t* ug = gbase + s * STAGE;
    const float* dtc = dts + s * QC;
    mbar_wait(full(s), (ck / NS) & 1);
    consumers_sync();    // every warp's pieces of the state are written

    // S = C B^T (both K-major), then C h over the state's pieces (h
    // MN-major: p contiguous)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(sacc, sw128_desc(cs, 16, 1024) + 2 * kk,
                     sw128_desc(bs, 16, 1024) + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 1>(yacc, sw128_desc(cs, 16, 1024) + 2 * kk,
                       sw128_desc(hp_s + k * TILE, 64 * 128, 1024) + 128 * kk,
                       k + kk > 0);
    wgmma_commit();

    // L (log2 units) over the chunk, two steps a lane, and w; each warp its
    // own copy
    float dq;
    {
      const float2 dv = *reinterpret_cast<const float2*>(dtc + 2 * lane);
      const float x0 = dv.x * a2, x1 = dv.y * a2;
      float incl = x0 + x1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float l0 = excl + x0, l1 = l0 + x1;
      const float lend = __shfl_sync(0xffffffffu, l1, 31);
      *reinterpret_cast<float2*>(Lw + 2 * lane) = make_float2(l0, l1);
      *reinterpret_cast<float2*>(Ww + 2 * lane) =
          make_float2(exp2f(lend - l0) * dv.x, exp2f(lend - l1) * dv.y);
      dq = exp2f(lend);
    }
    __syncwarp();

    // w u in pieces, at the same swizzled places as u: 16 bytes of one row a
    // thread, four times
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = threadIdx.x + 128 * k;
      const float w = Ww[q >> 3];
      const uint4 x = *reinterpret_cast<const uint4*>(ug + 16 * q);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      uint32_t out[NP][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t p[NP];
        pieces(bf16_lo(xs[e]) * w, bf16_hi(xs[e]) * w, p);
#pragma unroll
        for (int j = 0; j < NP; ++j) out[j][e] = p[j];
      }
#pragma unroll
      for (int j = 0; j < NP; ++j)
        *reinterpret_cast<uint4*>(wu_g + j * TILE + 16 * q) =
            make_uint4(out[j][0], out[j][1], out[j][2], out[j][3]);
    }
    fence_async_shared();

    // M[t][s] = S exp2(L_t - L_s) dt_s for s <= t, else 0, in pieces; a
    // warp's rows reach column blocks n <= 2 warp + 1 only
    wgmma_wait<1>();
    pin(sacc);
    const float lt[2] = {Lw[tr0], Lw[tr0 + 8]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n <= 2 * warp + 1) {
        const int s0 = 8 * n + 2 * t4;
        const float2 ls = *reinterpret_cast<const float2*>(Lw + s0);
        const float2 ds = *reinterpret_cast<const float2*>(dtc + s0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = tr0 + 8 * r;
          float& m0 = sacc[4 * n + 2 * r];
          float& m1 = sacc[4 * n + 2 * r + 1];
          m0 = s0 <= t ? m0 * fast_exp2(lt[r] - ls.x) * ds.x : 0.f;
          m1 = s0 + 1 <= t ? m1 * fast_exp2(lt[r] - ls.y) * ds.y : 0.f;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) sacc[4 * n + c] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t p[NP];
        pieces(sacc[8 * j + 2 * c], sacc[8 * j + 2 * c + 1], p);
#pragma unroll
        for (int k = 0; k < NP; ++k) pa[k][j][c] = p[k];
      }
    wgmma_wait<0>();
    pin(yacc);
    consumers_sync();    // w u's pieces are written; C h has read the state's

    // h = exp2(L_QC) h + B^T (w u) (B^T MN-major from B's tile, w u in
    // pieces); y = exp2(L_t) (C h) + M u (M in pieces from registers)
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] *= dq;
    const float e[2] = {exp2f(lt[0]), exp2f(lt[1])};
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] *= e[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_ss<1, 1>(hacc, sw128_desc(bs, 64 * 128, 1024) + 128 * j,
                       sw128_desc(wu_s + k * TILE, 64 * 128, 1024) + 128 * j,
                       1);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(yacc, pa[k][j], sw128_desc(us, 64 * 128, 1024) + 128 * j,
                 1);
    wgmma_commit();

    wgmma_wait<1>();
    pin(hacc);
    store_pieces();      // for the next chunk's C h

    wgmma_wait<0>();
    pin(yacc);
#pragma unroll
    for (int k = 0; k < NP; ++k) pin(pa[k]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = tr0 + 8 * r;
      if (c0 + t < S) {
        uint16_t* out = y + (((size_t)b * S + c0 + t) * H + hh) * 64 + 2 * t4;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const uint32_t uv =
              *reinterpret_cast<const uint32_t*>(ug + sw128(t, n) + 4 * t4);
          *reinterpret_cast<uint32_t*>(out + 8 * n) =
              pack_bf16(yacc[4 * n + 2 * r] + bf16_lo(uv) * dd,
                        yacc[4 * n + 2 * r + 1] + bf16_hi(uv) * dd);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(hout + state_off +
                                 (size_t)(tr0 + 8 * r) * 64 + 8 * n + 2 * t4) =
          make_float2(hacc[4 * n + 2 * r], hacc[4 * n + 2 * r + 1]);
}

// x (B, R, NH, 64) bf16, contiguous: dims (64, NH, R, B) innermost first,
// boxes of 64 columns x 64 rows of one head, 128-byte swizzle; what lies
// past R reads as zeros. B and C (B, S, N) are mapped with NH = 1.
bool tensor_map(CUtensorMap* map, const void* x, int NH, int R, int B) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)NH, (cuuint64_t)R,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {128ull, 128ull * NH, 128ull * NH * R};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)hop::QC, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_hopper(const void* u, const float* dt, const float* A,
                          const void* Bm, const void* Cm, const float* D,
                          const float* h0, void* y, float* hout, int B, int S,
                          int H, cudaStream_t stream) {
  CUtensorMap tu, tb, tc;
  if (!tensor_map(&tu, u, H, S, B) || !tensor_map(&tb, Bm, 1, S, B) ||
      !tensor_map(&tc, Cm, 1, S, B))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bf16_hopper, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)hop::bytes);
  if (e != cudaSuccess) return e;
  ssd_bf16_hopper<<<dim3(H, B), hop::NT, hop::bytes, stream>>>(
      tu, tb, tc, dt, A, D, h0, (uint16_t*)y, hout, S, H);
  return cudaGetLastError();
}

}  // namespace

#define SSD_CASES(X) \
  X(16, 16) X(16, 32) X(16, 64) X(32, 16) X(32, 32) X(32, 64) \
  X(64, 16) X(64, 32) X(64, 64)
// the bf16 entry's pairs on the mma.sync kernel: (64, 64) is ssd_bf16_hopper's
#define SSD_BF16_CASES(X) \
  X(16, 16) X(16, 32) X(16, 64) X(32, 16) X(32, 32) X(32, 64) \
  X(64, 16) X(64, 32)

extern "C" {

// 1 if the kernel is built for this (N, hp), else 0.
int ssd_scan_supported(int N, int HP) {
#define SSD_HAS(n, p) if (N == n && HP == p) return 1;
  SSD_CASES(SSD_HAS)
#undef SSD_HAS
  return 0;
}

// Internal chunk length of the kernel.
int ssd_scan_chunk() { return QC; }

// u (B,S,H,HP), dt (B,S,H), A/D (H), Bm/Cm (B,S,N), h0 (B,H,N,HP) or null;
// y (B,S,H,HP), hout (B,H,N,HP). All float32, contiguous, on the device;
// u, Bm, Cm and y 16-byte aligned. Returns a cudaError_t (0 on success).
int ssd_scan_f32(const float* u, const float* dt, const float* A,
                 const float* Bm, const float* Cm, const float* D,
                 const float* h0, float* y, float* hout, int B, int S, int H,
                 int N, int HP, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SSD_RUN(n, p)                                                     \
  if (N == n && HP == p)                                                  \
    return (int)launch<n, p>(u, dt, A, Bm, Cm, D, h0, y, hout, B, S, H, st);
  SSD_CASES(SSD_RUN)
#undef SSD_RUN
  return (int)cudaErrorInvalidValue;
}

// The bf16 entry: u (B,S,H,HP), Bm/Cm (B,S,N) and y (B,S,H,HP) bf16 (2
// bytes each), everything else as ssd_scan_f32 (f32); u, Bm, Cm and y
// 16-byte aligned.
int ssd_scan_bf16(const void* u, const float* dt, const float* A,
                  const void* Bm, const void* Cm, const float* D,
                  const float* h0, void* y, float* hout, int B, int S, int H,
                  int N, int HP, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16_t* ub = (const bf16_t*)u;
  const bf16_t* bb = (const bf16_t*)Bm;
  const bf16_t* cb = (const bf16_t*)Cm;
  bf16_t* yb = (bf16_t*)y;
  if (N == 64 && HP == 64)
    return (int)launch_hopper(u, dt, A, Bm, Cm, D, h0, y, hout, B, S, H, st);
#define SSD_RUN(n, p)                                                     \
  if (N == n && HP == p)                                                  \
    return (int)launch<n, p>(ub, dt, A, bb, cb, D, h0, yb, hout, B, S, H, st);
  SSD_BF16_CASES(SSD_RUN)
#undef SSD_RUN
  return (int)cudaErrorInvalidValue;
}

// 1 if the bf16 entry takes (N, hp) through ssd_bf16_hopper, 0 if through
// the mma.sync kernel (or not at all).
int ssd_scan_bf16_hopper(int N, int HP) { return N == 64 && HP == 64; }

// Dynamic shared memory (bytes) of the bf16 entry's kernel at (N, hp), 0
// for a pair the library is not built for.
int ssd_scan_bf16_smem_bytes(int N, int HP) {
  if (N == 64 && HP == 64) return (int)hop::bytes;
#define SSD_SMEM(n, p) if (N == n && HP == p) return (int)Cfg<n, p>::bytes;
  SSD_BF16_CASES(SSD_SMEM)
#undef SSD_SMEM
  return 0;
}

}  // extern "C"
