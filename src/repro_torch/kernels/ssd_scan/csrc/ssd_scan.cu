// Fused SSD (Mamba-2) scan for NVIDIA Hopper (sm_90a), float32 in and out,
// products on the tensor cores at f32 accuracy.
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
// final state in f32. The kernel is the same template: u and B are read
// from global memory in 16-byte pieces (8 values) and widened into the
// same f32 shared-memory tiles (plain loads, not cp.async: the widening
// sits between), C's fragments are widened as they are loaded, and y is
// rounded to bf16 once as it is stored. From the tiles on it computes in
// f32 exactly as the f32 entry does (the TPU kernel upcasts everything),
// so only the inputs' rounding and y's differ. A bf16 value is exact in
// TF32, so the split's small part of u, B and C is zero; the products are
// kept as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

}  // namespace

#define SSD_CASES(X) \
  X(16, 16) X(16, 32) X(16, 64) X(32, 16) X(32, 32) X(32, 64) \
  X(64, 16) X(64, 32) X(64, 64)

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
#define SSD_RUN(n, p)                                                     \
  if (N == n && HP == p)                                                  \
    return (int)launch<n, p>(ub, dt, A, bb, cb, D, h0, yb, hout, B, S, H, st);
  SSD_CASES(SSD_RUN)
#undef SSD_RUN
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
