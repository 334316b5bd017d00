// Flash attention (online softmax) for NVIDIA Hopper (sm_90a), float32 in and
// out, products on the tensor cores at f32 accuracy.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention (body
// _flash_kernel): q (B,S,H,hd), k/v (B,T,K,hd) -> o (B,S,H,hd) with causal
// and sliding-window masks and GQA (H = K*G; query head h reads KV head
// h / G, with no copy of K or V). One CTA owns one (q-block of 64 rows,
// head, batch); its four warps own 16 query rows each (the FlashAttention-2
// layout). K and V tiles stream through a double-buffered shared-memory ring
// filled with 16-byte cp.async, so the next tile loads while this one is
// computed. Each warp keeps its rows' online-softmax state (running max m,
// normaliser l, output accumulator) in registers, reduced over the 4 threads
// of a quad, so the (S x T) score matrix never exists. As in the TPU kernel,
// row 0 of q-block iq sits at key position q0 = 64 iq + (T - S), and KV
// tiles that the causal or window mask kills entirely are skipped (the lo/hi
// range); a ragged last q-block or KV tile is masked (rows past S are not
// stored, keys past T are zero-filled and masked), so any S and T work. The
// scale is applied after the dot product, together with log2(e): the
// softmax runs in base 2 (exp2f, one SFU operation, in place of expf). A
// row with no live key gives zeros (the running max starts at -inf and p
// stays 0 until a live key comes). Registers are held to 168 a thread, so
// three CTAs (12 warps) share an SM.
//
// Products: S = Q K^T and O += P V run as mma.sync m16n8k8 in TF32, each
// split into three: every operand x is big = cvt.rna.tf32(x) plus small =
// cvt.rna.tf32(x - big), and each product accumulates small*big + big*small
// + big*big in f32. TF32 alone keeps 10 mantissa bits (~5e-4 relative error
// a rounded operand); the split keeps f32-level accuracy. The fragments are
// laid out so that no data moves between threads: within each 8-wide k-step
// the k index runs over (2t, 2t+1) pairs, so a thread's S accumulator (rows
// g, g+8; keys 2t, 2t+1) is already its A fragment for P V, and K's B
// fragment is one 8-byte shared load. Row strides of hd + 8 (Q, K) and
// hd + 4 (V) floats keep rows 16-byte aligned for cp.async and the fragment
// loads free of bank conflicts. No atomics: run to run bitwise.
//
// Bound on the H100 SXM at its 700 W limit (495 TFLOP/s TF32 on the tensor
// cores, 67 TFLOP/s f32 outside them, 3.35 TB/s HBM): at the zamba2-1.2b
// prefill shape (B 4, S = T = 2048, H = K = 32, hd 64, causal) the function
// does 68.75 GFLOP over the unmasked half of QK^T and PV; at f32 accuracy on
// the tensor cores that is 3 x 68.75 GFLOP / 495 TFLOP/s = 0.417 ms (the f32
// FMA figure, which bound the first version of this kernel, is 1.03 ms), and
// the bytes 0.27 GB take 0.08 ms. What bounds it as built: issuing the
// three products' mma.sync (with one TF32 product in place of three it
// takes under half the time, tools/kernel_variants.py), then the splits
// (each warp splits the K and V fragments it reads) and the causal
// imbalance between q-blocks (the longest are launched first). wgmma, and
// one split of each tile shared by the CTA, are the next steps. Times on
// the H100: PERF.md and chip_smoke.py.
//
// Soft-capping (the reference's _sdpa softcap, gemma-2 style): with a cap c
// > 0 each scaled score x becomes c * tanh(x / c) before the mask and the
// base-2 rescale. It is a template flag, so the kernels without a cap are
// the code they were before the cap came in; tanhf (not tanh.approx) keeps
// the kernel within 2e-4 of the plain version.
//
// Head width 256 (gemma-7b) has a kernel of its own, flash_kernel_wide. At
// hd 256 one warp's 16 x 256 output accumulator alone is 128 registers a
// thread, so the hd <= 128 layout would spill. The wide kernel runs 8 warps
// as 4 pairs; both warps of a pair own the same 16 query rows. For each
// 32-key tile, warp `half` of the pair forms S for keys 16 half .. 16 half
// + 15 over the full hd (no product is done twice), the pair exchanges its
// row maxima through shared memory (a named barrier of 64 threads) so both
// use one running max, then each publishes its P fragments, and each warp
// accumulates O for all 32 keys over its own half of the output columns
// (128 of them: 64 accumulator registers). Each warp keeps the normaliser
// of its own keys; the two are summed once at the end. Q (64 x 264 floats)
// and two K/V stages (32 keys each) take 210 KB of shared memory: one CTA
// of 8 warps an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int NW = 4;    // warps per CTA, 16 query rows each
constexpr int NT = 32 * NW;

template <int HD>
struct Cfg {
  static constexpr int BK = HD <= 64 ? 64 : 32;   // keys per streamed tile
  static constexpr int KS = HD + 8;               // Q and K row stride (floats)
  static constexpr int VS = HD + 4;               // V row stride
  // Q's split fragments live in registers up to hd 64; at hd 128 they would
  // take 128 registers a thread, so Q stays in shared memory and is split at
  // each use
  static constexpr bool QREG = HD <= 64;
  static constexpr int v_off = BK * KS;           // a stage: K [BK][KS], V [BK][VS]
  static constexpr int stage = BK * (KS + VS);
  // Q [BQ][KS]: in stage 1 while its fragments are read into registers
  static constexpr int q_off = QREG ? stage : 2 * stage;
  static constexpr size_t bytes =
      sizeof(float) * (QREG ? 2 * stage : 2 * stage + BQ * KS);
  static_assert(!QREG || BQ * KS <= stage, "Q must fit in one stage");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (+ what lies below small's 11 bits)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
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

// A fragment of Q's 16 x 8 block at k-step kk for rows (g, g + 8) of `qrow`
// (row g's first float): the k index runs over (2t, 2t + 1)
__device__ __forceinline__ void q_fragment(const float* qrow, int ld, uint32_t (&fb)[4],
                                           uint32_t (&fs)[4]) {
  const float2 r0 = *reinterpret_cast<const float2*>(qrow);
  const float2 r8 = *reinterpret_cast<const float2*>(qrow + 8 * ld);
  split(r0.x, fb[0], fs[0]);
  split(r8.x, fb[1], fs[1]);
  split(r0.y, fb[2], fs[2]);
  split(r8.y, fb[3], fs[3]);
}

// a scaled score in base 2: x * scale * log2(e), soft-capped first if CAP
template <bool CAP>
__device__ __forceinline__ float score2(float x, float scale2, float scale,
                                        float cap) {
  if constexpr (CAP) return cap * tanhf(x * scale / cap) * 1.44269504f;
  else return x * scale2;
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(NT, 3)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S,
             int T, int H, int K, int causal, int window, float scale,
             float cap) {
  using CF = Cfg<HD>;
  constexpr int BK = CF::BK, KS = CF::KS, VS = CF::VS;
  constexpr int KK = HD / 8;   // k-steps of Q K^T
  constexpr int NK = BK / 8;   // 8-key blocks of a tile (k-steps of P V)
  constexpr int ND = HD / 8;   // 8-column blocks of the output
  constexpr int CH = HD / 4;   // 16-byte chunks of a row
  extern __shared__ __align__(16) float sm[];

  const int iq = gridDim.y - 1 - blockIdx.y;   // the longest causal rows first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * 1.44269504f;   // the softmax runs in base 2
  const int q_first = iq * BQ;          // first query row of the block
  const int q0 = q_first + (T - S);     // its key position

  // the streamed KV range: tiles the mask kills entirely are skipped
  const int nk = (T + BK - 1) / BK;
  int hi = nk;
  if (causal) {
    const int last = q0 + BQ - 1;
    hi = last < 0 ? 0 : min(nk, last / BK + 1);
  }
  int lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  const size_t kv_row = (size_t)K * HD;   // stride of one key in k and v
  const float* kb = k + (size_t)b * T * kv_row + (size_t)kh * HD;
  const float* vb = v + (size_t)b * T * kv_row + (size_t)kh * HD;
  auto load_tile = [&](int kt, int st) {
    float* Ks = sm + st * CF::stage;
    float* Vs = Ks + CF::v_off;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 4, t = kt * BK + r;
      const bool in = t < T;
      const size_t off = (size_t)(in ? t : 0) * kv_row + c;
      cp_async16(Ks + r * KS + c, kb + off, in);
      cp_async16(Vs + r * VS + c, vb + off, in);
    }
    cp_async_commit();
  };
  if (lo < hi) load_tile(lo, 0);

  float* Qs = sm + CF::q_off;
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4, row = q_first + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S)
      x = *reinterpret_cast<const float4*>(
          q + (((size_t)b * S + row) * H + h) * HD + c);
    *reinterpret_cast<float4*>(Qs + r * KS + c) = x;
  }
  __syncthreads();
  const float* qrow = Qs + (warp * 16 + g) * KS + 2 * t4;
  uint32_t qb[CF::QREG ? KK : 1][4], qs[CF::QREG ? KK : 1][4];
  if constexpr (CF::QREG) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) q_fragment(qrow + kk * 8, KS, qb[kk], qs[kk]);
    __syncthreads();   // stage 1 is free for the first prefetch
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  const int qa = q0 + warp * 16 + g;    // key position of row g (row g + 8: qa + 8)

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt + 1 < hi) {
      load_tile(kt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = sm + st * CF::stage;
    const float* Vs = Ks + CF::v_off;
    const int k_first = kt * BK;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (CF::QREG) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ab[c] = qb[kk][c];
          as[c] = qs[kk][c];
        }
      } else {
        q_fragment(qrow + kk * 8, KS, ab, as);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(
            Ks + (n * 8 + g) * KS + kk * 8 + 2 * t4);
        uint32_t bb0, bs0, bb1, bs1;
        split(kv.x, bb0, bs0);
        split(kv.y, bb1, bs1);
        mma3(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }

    // online softmax; s[n] holds rows (g, g + 8) x keys (2t, 2t + 1) of block n
    const bool unmasked = k_first + BK <= T &&
                          (!causal || k_first + BK - 1 <= q0) &&
                          (window <= 0 || k_first > q0 + BQ - 1 - window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qa + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = score2<CAP>(s[n][2 * r + c], scale2, scale, cap);
          if (!unmasked) {
            const int kpos = k_first + n * 8 + 2 * t4 + c;
            const bool ok = kpos < T && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            x = ok ? x : -INFINITY;
          }
          s[n][2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float alpha = 1.f, psum = 0.f;
      if (m_new != -INFINITY) {   // else no live key yet: p = 0
        alpha = exp2f(m[r] - m_new);
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s[n][2 * r + c] - m_new);
            s[n][2 * r + c] = p;
            psum += p;
          }
      } else {
#pragma unroll
        for (int n = 0; n < NK; ++n) s[n][2 * r] = s[n][2 * r + 1] = 0.f;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[r] = fmaf(l[r], alpha, psum);
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P's A fragment of key block n is s[n] as it stands (k index
    // t <-> key 2t, t + 4 <-> key 2t + 1), V's B fragment is read to match
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t pb[4], ps[4];
      split(s[n][0], pb[0], ps[0]);
      split(s[n][2], pb[1], ps[1]);
      split(s[n][1], pb[2], ps[2]);
      split(s[n][3], pb[3], ps[3]);
      const float* vrow = Vs + (n * 8 + 2 * t4) * VS + g;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t bb0, bs0, bb1, bs1;
        split(vrow[d * 8], bb0, bs0);
        split(vrow[VS + d * 8], bb1, bs1);
        mma3(acc[d], pb, ps, bb0, bb1, bs0, bs1);
      }
    }
    __syncthreads();   // this stage is read: the next prefetch may refill it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_first + warp * 16 + g + 8 * r;
    if (row < S) {
      const float den = fmaxf(l[r], 1e-30f);
      float* out = o + (((size_t)b * S + row) * H + h) * HD + 2 * t4;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<float2*>(out + d * 8) =
            make_float2(acc[d][2 * r] / den, acc[d][2 * r + 1] / den);
    }
  }
}

template <int HD, bool CAP>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int T, int H, int K, int causal, int window,
                   float cap, cudaStream_t stream) {
  const size_t smem = Cfg<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)HD);
  flash_kernel<HD, CAP><<<dim3(H * B, (S + BQ - 1) / BQ), NT, smem, stream>>>(
      q, k, v, o, S, T, H, K, causal, window, scale, cap);
  return cudaGetLastError();
}

// ------------------------------------------------------------- hd 256
namespace wide {
constexpr int HD = 256;
constexpr int NW = 8;                 // 4 pairs of warps, 16 query rows a pair
constexpr int NT = 32 * NW;
constexpr int BK = 32;                // keys per streamed tile, 16 per warp of a pair
constexpr int KS = HD + 8;            // Q and K row stride (floats)
constexpr int VS = HD + 4;            // V row stride
constexpr int v_off = BK * KS;
constexpr int stage = BK * (KS + VS);
constexpr int q_off = 2 * stage;      // Q [BQ][KS]
constexpr int x_off = q_off + BQ * KS;  // row maxima, then sums [NW][16]
constexpr int p_off = x_off + NW * 16;  // P fragments [NW][2][4][32]
constexpr size_t bytes = sizeof(float) * (p_off + NW * 2 * 4 * 32);
}  // namespace wide

// the two warps of pair `id` (barrier 1 + id: 0 is __syncthreads')
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id + 1) : "memory");
}

template <bool CAP>
__global__ void __launch_bounds__(wide::NT, 1)
flash_kernel_wide(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S,
                  int T, int H, int K, int causal, int window, float scale,
                  float cap) {
  constexpr int HD = wide::HD, BK = wide::BK, KS = wide::KS, VS = wide::VS;
  constexpr int NT = wide::NT;
  constexpr int KK = HD / 8;        // k-steps of Q K^T
  constexpr int NKH = BK / 16;      // 8-key blocks of a warp's half of a tile
  constexpr int NK = BK / 8;        // 8-key blocks of a tile (k-steps of P V)
  constexpr int NDH = HD / 16;      // 8-column blocks of a warp's half of the output
  constexpr int CH = HD / 4;        // 16-byte chunks of a row
  extern __shared__ __align__(16) float sm[];

  const int iq = gridDim.y - 1 - blockIdx.y;   // the longest causal rows first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pair = warp >> 1, half = warp & 1, mate = warp ^ 1;
  const float scale2 = scale * 1.44269504f;
  const int q_first = iq * BQ;
  const int q0 = q_first + (T - S);

  const int nk = (T + BK - 1) / BK;
  int hi = nk;
  if (causal) {
    const int last = q0 + BQ - 1;
    hi = last < 0 ? 0 : min(nk, last / BK + 1);
  }
  int lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  const size_t kv_row = (size_t)K * HD;
  const float* kb = k + (size_t)b * T * kv_row + (size_t)kh * HD;
  const float* vb = v + (size_t)b * T * kv_row + (size_t)kh * HD;
  auto load_tile = [&](int kt, int st) {
    float* Ks = sm + st * wide::stage;
    float* Vs = Ks + wide::v_off;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 4, t = kt * BK + r;
      const bool in = t < T;
      const size_t off = (size_t)(in ? t : 0) * kv_row + c;
      cp_async16(Ks + r * KS + c, kb + off, in);
      cp_async16(Vs + r * VS + c, vb + off, in);
    }
    cp_async_commit();
  };
  if (lo < hi) load_tile(lo, 0);

  float* Qs = sm + wide::q_off;
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4, row = q_first + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S)
      x = *reinterpret_cast<const float4*>(
          q + (((size_t)b * S + row) * H + h) * HD + c);
    *reinterpret_cast<float4*>(Qs + r * KS + c) = x;
  }
  __syncthreads();
  const float* qrow = Qs + (pair * 16 + g) * KS + 2 * t4;
  float* xs = sm + wide::x_off;
  float* ps = sm + wide::p_off;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NDH][4];
#pragma unroll
  for (int n = 0; n < NDH; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  const int qa = q0 + pair * 16 + g;

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt + 1 < hi) {
      load_tile(kt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = sm + st * wide::stage;
    const float* Vs = Ks + wide::v_off;
    const int k_first = kt * BK;
    const int k_mine = k_first + 16 * half;   // this warp's 16 keys

    float s[NKH][4];
#pragma unroll
    for (int n = 0; n < NKH; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t ab[4], as[4];
      q_fragment(qrow + kk * 8, KS, ab, as);
#pragma unroll
      for (int n = 0; n < NKH; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(
            Ks + (16 * half + n * 8 + g) * KS + kk * 8 + 2 * t4);
        uint32_t bb0, bs0, bb1, bs1;
        split(kv.x, bb0, bs0);
        split(kv.y, bb1, bs1);
        mma3(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }

    const bool unmasked = k_first + BK <= T &&
                          (!causal || k_first + BK - 1 <= q0) &&
                          (window <= 0 || k_first > q0 + BQ - 1 - window);
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qa + 8 * r;
      mx[r] = -INFINITY;
#pragma unroll
      for (int n = 0; n < NKH; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = score2<CAP>(s[n][2 * r + c], scale2, scale, cap);
          if (!unmasked) {
            const int kpos = k_mine + n * 8 + 2 * t4 + c;
            const bool ok = kpos < T && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            x = ok ? x : -INFINITY;
          }
          s[n][2 * r + c] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t4 == 0) xs[warp * 16 + g + 8 * r] = mx[r];
    }
    pair_sync(pair);   // the mate's row maxima are in
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], fmaxf(mx[r], xs[mate * 16 + g + 8 * r]));
      float alpha = 1.f, psum = 0.f;
      if (m_new != -INFINITY) {
        alpha = exp2f(m[r] - m_new);
#pragma unroll
        for (int n = 0; n < NKH; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s[n][2 * r + c] - m_new);
            s[n][2 * r + c] = p;
            psum += p;
          }
      } else {
#pragma unroll
        for (int n = 0; n < NKH; ++n) s[n][2 * r] = s[n][2 * r + 1] = 0.f;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[r] = fmaf(l[r], alpha, psum);   // over this warp's keys only
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NDH; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    // publish P in fragment order: the mate's lane holds the same rows
#pragma unroll
    for (int n = 0; n < NKH; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) ps[((warp * NKH + n) * 4 + c) * 32 + lane] = s[n][c];
    pair_sync(pair);   // the mate's P is in

    // O[:, 128 half ..] += P V over all 32 keys of the tile
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float* pj = ps + (((2 * pair + j / NKH) * NKH + j % NKH) * 4) * 32 + lane;
      uint32_t pb[4], pq[4];
      split(pj[0], pb[0], pq[0]);
      split(pj[64], pb[1], pq[1]);
      split(pj[32], pb[2], pq[2]);
      split(pj[96], pb[3], pq[3]);
      const float* vrow = Vs + (j * 8 + 2 * t4) * VS + 128 * half + g;
#pragma unroll
      for (int d = 0; d < NDH; ++d) {
        uint32_t bb0, bs0, bb1, bs1;
        split(vrow[d * 8], bb0, bs0);
        split(vrow[VS + d * 8], bb1, bs1);
        mma3(acc[d], pb, pq, bb0, bb1, bs0, bs1);
      }
    }
    __syncthreads();   // this wide::stage, xs and ps are read
  }

  // the normaliser over all keys: this warp's and its mate's
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (t4 == 0) xs[warp * 16 + g + 8 * r] = l[r];
  pair_sync(pair);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_first + pair * 16 + g + 8 * r;
    if (row < S) {
      const float den = fmaxf(l[r] + xs[mate * 16 + g + 8 * r], 1e-30f);
      float* out = o + (((size_t)b * S + row) * H + h) * HD + 128 * half + 2 * t4;
#pragma unroll
      for (int d = 0; d < NDH; ++d)
        *reinterpret_cast<float2*>(out + d * 8) =
            make_float2(acc[d][2 * r] / den, acc[d][2 * r + 1] / den);
    }
  }
}

template <bool CAP>
cudaError_t launch_wide(const float* q, const float* k, const float* v, float* o,
                        int B, int S, int T, int H, int K, int causal,
                        int window, float cap, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel_wide<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)wide::bytes);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)wide::HD);
  flash_kernel_wide<CAP><<<dim3(H * B, (S + BQ - 1) / BQ), wide::NT,
                           wide::bytes, stream>>>(
      q, k, v, o, S, T, H, K, causal, window, scale, cap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(const float* q, const float* k, const float* v, float* o,
                     int B, int S, int T, int H, int K, int causal, int window,
                     float cap, cudaStream_t st) {
  if (cap > 0.f) return launch<HD, true>(q, k, v, o, B, S, T, H, K, causal, window, cap, st);
  return launch<HD, false>(q, k, v, o, B, S, T, H, K, causal, window, cap, st);
}

// ------------------------------------------------------------- bf16
// The bf16 entry (flash_attention_bf16): q, k, v and o in bf16. It replaces
// the same TPU kernel (src/repro/kernels/flash_attention/kernel.py:
// flash_attention, body _flash_kernel) at the reference's default dtype:
// Q K^T of bf16 operands accumulated in f32 (the TPU kernel's jnp.dot(...,
// preferred_element_type=float32); a bf16 x bf16 product is exact in f32,
// so one product, no split), the scale, the optional soft-cap, a base-2
// online softmax in f32, P rounded to bf16 before P V (its
// p.astype(v.dtype)) with the normaliser summed from the unrounded P (its
// l), the output divided by max(l, 1e-30) and rounded to bf16 once.
//
// Bound on the H100 SXM (700 W): at the dense models' prefill shapes (B 4,
// S = T = 2048, causal) its products on the tensor cores, 989 TFLOP/s dense
// bf16: 0.139 ms at granite-8b's 32/8 heads of 128 and at gemma-7b's 16 of
// 256, against 0.05 ms for its bf16 bytes (K and V are read again by every
// q-block, from the 50 MB L2). What holds a kernel back from that is the
// softmax between the two products: per score a max, an fmaf, an
// exponential (16 a clock an SM), a sum and half a bf16 pack, plus the
// rescale of O, on one warp per SM sub-partition while the tensor cores
// wait for P. So the design is the one that keeps the tensor cores fed
// (FlashAttention-3's), flash_bf16_hopper below, at hd 64, 128 and 256:
//
// - One CTA of 384 threads per 128 query rows of one (head, batch), the
//   Pallas kernel's block_q, in three warpgroups. Warpgroup 0 is the
//   producer: one thread issues every load as a TMA copy
//   (cp.async.bulk.tensor, 4-D tensor maps over q (hd, H, S, B) and k, v
//   (hd, K, T, B), built on the host in the C entry), and the warpgroup
//   gives its registers up (setmaxnreg.dec to 24). Warpgroups 1 and 2 are
//   consumers of 64 query rows each and take them (setmaxnreg.inc to 240):
//   128 x 24 + 256 x 240 registers fit the SM's 65,536.
// - Tiles of BK keys (128 at hd 64 and 128, the Pallas kernel's block_k, so
//   P is rounded against the reference's own running maxima wherever T is
//   a multiple of 128; 64 at hd 256) stream through two rings of NS slots,
//   one for K and one for V (4 at hd 64, 2 at 128 and 256), in 128-byte-
//   swizzled boxes of 64 columns. Each slot has a full mbarrier, armed with
//   expect_tx of the tile's bytes, and an empty one that the consumers'
//   eight warps arrive at: K once a tile's scores are formed, V once its
//   P V is done, so the producer refills K while P V still reads V. Q is
//   loaded once a CTA. TMA fills keys past T and rows past S with zeros
//   (the mask still kills those keys), so any S and T work.
// - S = Q K^T by wgmma m64n{BK}k16 with both operands in shared memory
//   (K-major descriptors: 8-row groups 1,024 bytes apart, a 16-column
//   k-step 32 bytes into the swizzled row, a box BQ or BK x 128 bytes on).
// - The softmax on the accumulator in registers: a thread holds rows g and
//   g + 8 of its warp's 16; maxima and sums in four chains a row, then over
//   the 4 threads of a quad; each exponent one fmaf (x * f - m * f, f the
//   base-2 scale) and one ex2.approx.ftz (a result under 2^-126 flushes to
//   0, far below what a bf16 P or a row's f32 sum holds). The mask is a
//   separate loop, taken only on tiles the `unmasked` test does not clear:
//   one loop with the test inside compiles to predicated instructions
//   that cost their issue slots on every tile. A row whose maximum is
//   still -inf takes m * f = 0, so its p and alpha are 0, not NaN (rows
//   and tiles with no live key).
// - O += P V by wgmma m64n{hd}k16 with A = P from registers: wgmma's
//   accumulator of two neighbouring 8-key blocks is, element for element,
//   the register A fragment of one 16-key k-step, so P is rounded to bf16
//   in place (cvt.rn.bf16x2.f32) and never touches shared memory. V is B
//   as it lands (hd along N: MN-major, the transpose-B form; 8-key groups
//   1,024 bytes apart, the next 64 columns a box, BK x 128 bytes, on).
// - Overlap: the producer keeps the next tiles in flight while the
//   consumers compute, and within a consumer the scores of tile j + 1 are
//   issued before P V of tile j, so the scores' maxima of j + 1 are taken
//   while the tensor cores do P V of j (kOverlap; the order of the
//   operations on O is unchanged, so both forms give the same bits). The
//   two consumers interleave on their own: turns at the tensor cores on
//   named barriers (FlashAttention-3's ping-pong), a second register
//   buffer for P and the exponentials moved ahead of the wait for P V
//   each measured within the run-to-run spread, and are not used.
// - The longest causal q-blocks go first; rows past S are never written
//   (4-byte stores under the row check; one division a row, then
//   products). No atomics: run to run bitwise. A barrier wait that has
//   not completed after ~10 s of clock traps, so a fault ends the launch
//   with an error and does not hang the card.
//
// Head widths 16 and 32 (reduced configurations only) keep the first bf16
// kernel, flash_kernel_bf16 (mma.sync): each warp owns 16 query rows over
// the full head width, K and V tiles of 64 keys through a double-buffered
// cp.async ring, P rounded in registers and V's B fragments by
// ldmatrix.x4.trans. A 64-column box and the 128-byte swizzle do not fit
// those widths. Times: PERF.md, chip_smoke.py phase 13 and
// tools/kernel_variants.py.
namespace bf16 {
template <int HD>   // 16 or 32
struct Cfg {
  static_assert(HD <= 32, "hd 64, 128 and 256 take flash_bf16_hopper");
  static constexpr int BK = 64;                   // keys per streamed tile
  static constexpr int RS = HD + 8;               // row stride of Q, K, V (bf16)
  static constexpr int MINB = 4;                  // CTAs an SM
  static constexpr int stage = 2 * BK * RS;       // K [BK][RS], then V [BK][RS]
  static constexpr int q_off = 2 * stage;         // Q [BQ][RS]
  static constexpr size_t bytes = sizeof(uint16_t) * (2 * stage + BQ * RS);
};
}  // namespace bf16

__device__ __forceinline__ void cp_async16b(uint16_t* dst, const uint16_t* src,
                                            bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 rounded to bf16, lo in the low half (the lower k or column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: lanes 8m .. 8m + 7 give the row
// addresses of matrix m; each thread gets (rows 2t, 2t + 1; column g) of each
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const uint16_t* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(NT, bf16::Cfg<HD>::MINB)
flash_kernel_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                  int S, int T, int H, int K, int causal, int window,
                  float scale, float cap) {
  using CF = bf16::Cfg<HD>;
  constexpr int BK = CF::BK, RS = CF::RS;
  constexpr int KK = HD / 16;   // k-steps of Q K^T
  constexpr int NK = BK / 8;    // 8-key blocks of a tile
  constexpr int ND = HD / 8;    // 8-column blocks of the output
  constexpr int CH = HD / 8;    // 16-byte chunks of a row
  extern __shared__ __align__(16) uint16_t smb[];

  const int iq = gridDim.y - 1 - blockIdx.y;   // the longest causal rows first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * 1.44269504f;
  const int q_first = iq * BQ;
  const int q0 = q_first + (T - S);

  const int nk = (T + BK - 1) / BK;
  int hi = nk;
  if (causal) {
    const int last = q0 + BQ - 1;
    hi = last < 0 ? 0 : min(nk, last / BK + 1);
  }
  int lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  const size_t kv_row = (size_t)K * HD;
  const uint16_t* kb = k + (size_t)b * T * kv_row + (size_t)kh * HD;
  const uint16_t* vb = v + (size_t)b * T * kv_row + (size_t)kh * HD;
  auto load_tile = [&](int kt, int st) {
    uint16_t* Ks = smb + st * CF::stage;
    uint16_t* Vs = Ks + BK * RS;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8, t = kt * BK + r;
      const bool in = t < T;
      const size_t off = (size_t)(in ? t : 0) * kv_row + c;
      cp_async16b(Ks + r * RS + c, kb + off, in);
      cp_async16b(Vs + r * RS + c, vb + off, in);
    }
    cp_async_commit();
  };
  if (lo < hi) load_tile(lo, 0);

  uint16_t* Qs = smb + CF::q_off;
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, row = q_first + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      x = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * S + row) * H + h) * HD + c);
    *reinterpret_cast<uint4*>(Qs + r * RS + c) = x;
  }
  __syncthreads();
  // A fragment of Q at k-step kk: rows (g, g + 8) x columns 16 kk + (2t,
  // 2t + 1), then the same 8 columns on
  const uint16_t* qrow = Qs + (warp * 16 + g) * RS + 2 * t4;
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    const uint16_t* p = qrow + kk * 16;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * RS);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * RS + 8);
  };
  uint32_t qf[KK][4];   // Q's A fragments stay in registers
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) q_frag(kk, qf[kk]);
  // this lane's row address for V's ldmatrix: key (l & 7) + 8 ((l >> 3) & 1)
  // of a 16-key step, columns 8 (l >> 4) of a 16-column pair
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  const int qa = q0 + warp * 16 + g;

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt + 1 < hi) {
      load_tile(kt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* Ks = smb + st * CF::stage;
    const uint16_t* Vs = Ks + BK * RS;
    const int k_first = kt * BK;

    // S = Q K^T: K's B fragment (k over 2t, 2t + 1 and 8 on; key g) is two
    // 4-byte loads of key g's row
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const uint16_t* kp = Ks + (n * 8 + g) * RS + kk * 16 + 2 * t4;
        mma_bf16(s[n], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // online softmax in f32, as the f32 kernel
    const bool unmasked = k_first + BK <= T &&
                          (!causal || k_first + BK - 1 <= q0) &&
                          (window <= 0 || k_first > q0 + BQ - 1 - window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qa + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = score2<CAP>(s[n][2 * r + c], scale2, scale, cap);
          if (!unmasked) {
            const int kpos = k_first + n * 8 + 2 * t4 + c;
            const bool ok = kpos < T && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            x = ok ? x : -INFINITY;
          }
          s[n][2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float alpha = 1.f, psum = 0.f;
      if (m_new != -INFINITY) {
        alpha = exp2f(m[r] - m_new);
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s[n][2 * r + c] - m_new);
            s[n][2 * r + c] = p;
            psum += p;
          }
      } else {
#pragma unroll
        for (int n = 0; n < NK; ++n) s[n][2 * r] = s[n][2 * r + 1] = 0.f;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[r] = fmaf(l[r], alpha, psum);
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V over 16-key steps: P's A fragment is key blocks 2j and
    // 2j + 1 of s, rounded to bf16
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const uint16_t* vrow = Vs + j * 16 * RS + v_lane;
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vrow + dp * 16);
        mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();   // this stage is read: the next prefetch may refill it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_first + warp * 16 + g + 8 * r;
    if (row < S) {
      const float den = fmaxf(l[r], 1e-30f);
      uint16_t* out = o + (((size_t)b * S + row) * H + h) * HD + 2 * t4;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<uint32_t*>(out + d * 8) =
            pack_bf16(acc[d][2 * r] / den, acc[d][2 * r + 1] / den);
    }
  }
}

template <int HD, bool CAP>
cudaError_t launch_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                        uint16_t* o, int B, int S, int T, int H, int K,
                        int causal, int window, float cap, cudaStream_t stream) {
  const size_t smem = bf16::Cfg<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel_bf16<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)HD);
  flash_kernel_bf16<HD, CAP><<<dim3(H * B, (S + BQ - 1) / BQ), NT, smem, stream>>>(
      q, k, v, o, S, T, H, K, causal, window, scale, cap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                          uint16_t* o, int B, int S, int T, int H, int K,
                          int causal, int window, float cap, cudaStream_t st) {
  if (cap > 0.f)
    return launch_bf16<HD, true>(q, k, v, o, B, S, T, H, K, causal, window, cap, st);
  return launch_bf16<HD, false>(q, k, v, o, B, S, T, H, K, causal, window, cap, st);
}


// ------------------------------------------- bf16 at hd 64, 128, 256: Hopper
namespace hop {
constexpr int BQ = 128;                  // query rows a CTA
constexpr int NT = 384;                  // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// issue tile j + 1's scores before tile j's P V (see the header comment)
constexpr bool kOverlap = true;
template <int HD>
struct Cfg {
  static constexpr int BK = HD <= 128 ? 128 : 64;   // keys a tile
  static constexpr int NS = HD <= 64 ? 4 : 2;       // slots of the K and V rings
  static constexpr int NB = HD / 64;                // 64-column boxes a row
  static constexpr uint32_t q_bytes = BQ * HD * 2;
  static constexpr uint32_t kv_bytes = BK * HD * 2; // K (or V) of one tile
  static constexpr uint32_t stage_bytes = 2 * kv_bytes;
  static constexpr uint32_t bar_off = q_bytes + NS * stage_bytes;
  // Q full; K full, V full, K empty, V empty of each stage
  static constexpr int nbar = 1 + 4 * NS;
  // + 1,024: the base is rounded up to the swizzle's 1,024-byte atom
  static constexpr size_t bytes = bar_off + 8 * nbar + 1024;
  static_assert(bytes <= 232448, "over the 227 KB a CTA may use");
};
}  // namespace hop

// wait until the phase of parity `parity` has completed; trap after ~10 s
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// D (64 x N, f32) {=, +=} A B, A and B bf16 in shared memory, both K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D (64 x N, f32) {=, +=} A B, A bf16 in registers, B bf16 in shared memory,
// MN-major (the transpose-B form)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// 2^x on the SFU: ex2.approx.ftz, within 2 ulp; a result under 2^-126
// flushes to 0, far below what a bf16 P or a row's f32 sum can hold
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(hop::NT, 1)
flash_bf16_hopper(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  uint16_t* __restrict__ o, int S, int T, int H, int K,
                  int causal, int window, float scale, float cap) {
  using CF = hop::Cfg<HD>;
  constexpr int BQ = hop::BQ, BK = CF::BK, NS = CF::NS, NB = CF::NB;
  extern __shared__ __align__(1024) uint8_t hop_smem[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(hop_smem) + 1023u) & ~1023u;
  // Q: NB boxes [BQ][64]; stage s: K NB boxes [BK][64], then V the same;
  // then the mbarriers: Q full; K full, V full, K empty, V empty of each
  // stage (K and V are separate rings: a consumer frees K of tile j once its
  // scores are formed, V once P V is done)
  const uint32_t q_s = base, kv_s = base + CF::q_bytes;
  const uint32_t q_full = base + CF::bar_off;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + NS + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * NS + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * NS + s); };

  const int iq = gridDim.y - 1 - blockIdx.y;   // the longest causal rows first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / K);
  const int q_first = iq * BQ;
  const int q0 = q_first + (T - S);

  const int nk = (T + BK - 1) / BK;
  int hi = nk;
  if (causal) {
    const int last = q0 + BQ - 1;
    hi = last < 0 ? 0 : min(nk, last / BK + 1);
  }
  int lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);   // the consumers' eight warps
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ----------------------------------------------------------- producer
    setmaxnreg_dec<hop::PRODUCER_REGS>();
    if (threadIdx.x == 0 && lo < hi) {
      mbar_expect_tx(q_full, CF::q_bytes);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load4(q_s + c * BQ * 128, &tq, 64 * c, h, q_first, b, q_full);
      // K or V (`v`) of the i-th tile into its ring's slot i % NS, once the
      // consumers have freed the slot's previous tile (round 0: at once)
      auto load = [&](int i, bool v) {
        const int s = i % NS;
        mbar_wait(v ? v_empty(s) : k_empty(s), ((i / NS) & 1) ^ 1);
        const uint32_t full = v ? v_full(s) : k_full(s);
        const uint32_t dst = kv_s + s * CF::stage_bytes + (v ? CF::kv_bytes : 0);
        mbar_expect_tx(full, CF::kv_bytes);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load4(dst + c * BK * 128, v ? &tv : &tk, 64 * c, kh,
                    (lo + i) * BK, b, full);
      };
      // K of tile i before V of tile i - 1: the order the consumers use them
      load(0, false);
      for (int i = 1; i < hi - lo; ++i) {
        load(i, false);
        load(i - 1, true);
      }
      load(hi - lo - 1, true);
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<hop::CONSUMER_REGS>();
    const int cw = wg - 1;                    // rows 64 cw .. 64 cw + 63
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale2 = scale * 1.44269504f;
    const int qw = q0 + 64 * cw;              // key position of row 0
    const int qa = qw + 16 * warp + g;        // of this thread's row g
    // this warpgroup's 64 rows of each Q box
    const uint64_t dq = sw128_desc(q_s + cw * 64 * 128, 16, 1024);

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];   // P in bf16, P V's A operand

    // S = Q K^T of stage s, issued and committed
    auto issue_qk = [&](int s) {
      const uint64_t dk = sw128_desc(kv_s + s * CF::stage_bytes, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BK>(sc, dq + (((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4),
                     dk + (((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4),
                     kk > 0);
      wgmma_commit();
    };
    // O += P V of stage s, issued and committed
    auto issue_pv = [&](int s) {
      const uint64_t dv = sw128_desc(kv_s + s * CF::stage_bytes + CF::kv_bytes,
                                     BK * 128, 1024);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs<HD>(acc, pa[j], dv + ((j * 16 * 128) >> 4), 1);
      wgmma_commit();
    };
    // the online softmax of tile kt's scores in sc: sc becomes P (f32), m
    // and l move on, alpha is O's rescale. m is kept in the units of sc
    // (raw scores; capped base-2 ones with a cap) and each exponent is one
    // fmaf, x * f - m * f, f the base-2 scale (1 with a cap). Straight-line
    // code over both rows, the maxima and sums in four chains a row: a
    // row whose maximum is still -inf takes m * f = 0, so its p and alpha
    // are 0, not NaN.
    const float f = CAP ? 1.f : scale2;
    auto softmax = [&](int kt) {
      const int k_first = kt * BK;
      const bool unmasked = k_first + BK <= T &&
                            (!causal || k_first + BK - 1 <= qw) &&
                            (window <= 0 || k_first > qw + 63 - window);
      float mx[2][4], ps[2][4], mf[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) mx[r][j] = -INFINITY, ps[r][j] = 0.f;
      // two loops, not one with a test inside: a test inside is compiled
      // to predicated instructions that take their issue slots on every
      // tile, masked or not
      if (unmasked) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float x = sc[4 * n + 2 * r + c];
              if constexpr (CAP) x = score2<CAP>(x, scale2, scale, cap);
              sc[4 * n + 2 * r + c] = x;
              mx[r][n & 3] = fmaxf(mx[r][n & 3], x);
            }
      } else {
        // row r's live keys: kmin[r] <= kpos <= kmax[r]
        int kmin[2], kmax[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qpos = qa + 8 * r;
          kmax[r] = causal ? min(T - 1, qpos) : T - 1;
          kmin[r] = window > 0 ? qpos - window + 1 : 0;
        }
        const int k0 = k_first + 2 * t4;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float x = sc[4 * n + 2 * r + c];
              if constexpr (CAP) x = score2<CAP>(x, scale2, scale, cap);
              const int kpos = k0 + n * 8 + c;
              x = (kpos >= kmin[r] && kpos <= kmax[r]) ? x : -INFINITY;
              sc[4 * n + 2 * r + c] = x;
              mx[r][n & 3] = fmaxf(mx[r][n & 3], x);
            }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float m_new = fmaxf(m[r], v);
        mf[r] = m_new == -INFINITY ? 0.f : m_new * f;
        alpha[r] = fast_exp2(m[r] * f - mf[r]);
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = fast_exp2(fmaf(sc[4 * n + 2 * r + c], f, -mf[r]));
            sc[4 * n + 2 * r + c] = p;
            ps[r][n & 3] += p;
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = (ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        l[r] = fmaf(l[r], alpha[r], v);
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[4 * n + c] *= alpha[c >> 1];
    };
    // P rounded to bf16: key blocks 2j and 2j + 1 are k-step j's A fragment
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pa[j][c] = pack_bf16(sc[8 * j + 2 * c], sc[8 * j + 2 * c + 1]);
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    if (lo < hi) {
      mbar_wait(q_full, 0);
      if constexpr (hop::kOverlap) {
        int s = 0;
        uint32_t ph = 0;
        mbar_wait(k_full(0), 0);
        wgmma_fence();
        issue_qk(0);
        wgmma_wait<0>();
        pin(sc);
        release(k_empty(0));
        softmax(lo);
        pack_p();
        for (int kt = lo + 1; kt < hi; ++kt) {
          const int i = kt - lo, sn = i % NS;
          const uint32_t phn = (i / NS) & 1;
          mbar_wait(k_full(sn), phn);
          mbar_wait(v_full(s), ph);
          wgmma_fence();
          issue_qk(sn);              // tile kt's scores ...
          issue_pv(s);               // ... then tile kt - 1's P V
          wgmma_wait<1>();
          pin(sc);
          release(k_empty(sn));
          softmax(kt);               // while P V runs
          wgmma_wait<0>();
          pin(acc);
          pin(pa);
          release(v_empty(s));
          rescale();
          pack_p();
          s = sn;
          ph = phn;
        }
        mbar_wait(v_full(s), ph);
        wgmma_fence();
        issue_pv(s);
        wgmma_wait<0>();
        pin(acc);
        pin(pa);
        release(v_empty(s));
      } else {
        for (int kt = lo; kt < hi; ++kt) {
          const int i = kt - lo, s = i % NS;
          const uint32_t ph = (i / NS) & 1;
          mbar_wait(k_full(s), ph);
          wgmma_fence();
          issue_qk(s);
          wgmma_wait<0>();
          pin(sc);
          release(k_empty(s));
          softmax(kt);
          rescale();
          pack_p();
          mbar_wait(v_full(s), ph);
          wgmma_fence();
          issue_pv(s);
          wgmma_wait<0>();
          pin(acc);
          pin(pa);
          release(v_empty(s));
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q_first + 64 * cw + 16 * warp + g + 8 * r;
      if (row < S) {
        // one division a row, then products (within an ulp of dividing
        // each value, before the bf16 rounding)
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        uint16_t* out = o + (((size_t)b * S + row) * H + h) * HD + 2 * t4;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d)
          *reinterpret_cast<uint32_t*>(out + d * 8) =
              pack_bf16(acc[4 * d + 2 * r] * inv, acc[4 * d + 2 * r + 1] * inv);
      }
    }
  }
}

// x (B, R, NH, HD) bf16, contiguous: dims (HD, NH, R, B) innermost first,
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzle; what lies
// past R reads as zeros
bool tensor_map(CUtensorMap* map, const void* x, int HD, int NH, int R, int B,
                int rows) {
  if (R == 0) {   // no key: the kernel loads nothing
    memset(map, 0, sizeof(*map));
    return true;
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)NH,
                              (cuuint64_t)R, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * HD, 2ull * HD * NH,
                                 2ull * HD * NH * R};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool CAP>
cudaError_t launch_hopper(const uint16_t* q, const uint16_t* k,
                          const uint16_t* v, uint16_t* o, int B, int S, int T,
                          int H, int K, int causal, int window, float cap,
                          cudaStream_t stream) {
  using CF = hop::Cfg<HD>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, HD, H, S, B, hop::BQ) ||
      !tensor_map(&tk, k, HD, K, T, B, CF::BK) ||
      !tensor_map(&tv, v, HD, K, T, B, CF::BK))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_hopper<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)CF::bytes);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)HD);
  flash_bf16_hopper<HD, CAP>
      <<<dim3(H * B, (S + hop::BQ - 1) / hop::BQ), hop::NT, CF::bytes,
         stream>>>(tq, tk, tv, o, S, T, H, K, causal, window, scale, cap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_hopper(const uint16_t* q, const uint16_t* k,
                            const uint16_t* v, uint16_t* o, int B, int S,
                            int T, int H, int K, int causal, int window,
                            float cap, cudaStream_t st) {
  if (cap > 0.f)
    return launch_hopper<HD, true>(q, k, v, o, B, S, T, H, K, causal, window, cap, st);
  return launch_hopper<HD, false>(q, k, v, o, B, S, T, H, K, causal, window, cap, st);
}

}  // namespace

extern "C" {

// 1 if the kernel is built for this head width, else 0.
int flash_attention_supported(int HD) {
  return HD == 16 || HD == 32 || HD == 64 || HD == 128 || HD == 256;
}

// q (B,S,H,HD), k/v (B,T,K,HD), o (B,S,H,HD); float32, contiguous, 16-byte
// aligned, on the device; H a multiple of K; window <= 0 means no window;
// softcap <= 0 means no soft-cap. Returns a cudaError_t (0 on success).
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, int B, int S, int T, int H, int K, int HD,
                        int causal, int window, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (HD) {
    case 16: return (int)dispatch<16>(q, k, v, o, B, S, T, H, K, causal, window, softcap, st);
    case 32: return (int)dispatch<32>(q, k, v, o, B, S, T, H, K, causal, window, softcap, st);
    case 64: return (int)dispatch<64>(q, k, v, o, B, S, T, H, K, causal, window, softcap, st);
    case 128: return (int)dispatch<128>(q, k, v, o, B, S, T, H, K, causal, window, softcap, st);
    case 256:
      if (softcap > 0.f)
        return (int)launch_wide<true>(q, k, v, o, B, S, T, H, K, causal, window, softcap, st);
      return (int)launch_wide<false>(q, k, v, o, B, S, T, H, K, causal, window, softcap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 entry: q, k, v, o bf16 (2 bytes each), otherwise as
// flash_attention_f32, at the same head widths: hd 64, 128 and 256 through
// flash_bf16_hopper, hd 16 and 32 through flash_kernel_bf16.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int T, int H, int K, int HD,
                         int causal, int window, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint16_t* qb = (const uint16_t*)q;
  const uint16_t* kb = (const uint16_t*)k;
  const uint16_t* vb = (const uint16_t*)v;
  uint16_t* ob = (uint16_t*)o;
  switch (HD) {
    case 16: return (int)dispatch_bf16<16>(qb, kb, vb, ob, B, S, T, H, K, causal, window, softcap, st);
    case 32: return (int)dispatch_bf16<32>(qb, kb, vb, ob, B, S, T, H, K, causal, window, softcap, st);
    case 64: return (int)dispatch_hopper<64>(qb, kb, vb, ob, B, S, T, H, K, causal, window, softcap, st);
    case 128: return (int)dispatch_hopper<128>(qb, kb, vb, ob, B, S, T, H, K, causal, window, softcap, st);
    case 256: return (int)dispatch_hopper<256>(qb, kb, vb, ob, B, S, T, H, K, causal, window, softcap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory (bytes) of the bf16 kernel that serves head width HD,
// 0 for a width the library is not built for.
int flash_attention_bf16_smem_bytes(int HD) {
  switch (HD) {
    case 16: return (int)bf16::Cfg<16>::bytes;
    case 32: return (int)bf16::Cfg<32>::bytes;
    case 64: return (int)hop::Cfg<64>::bytes;
    case 128: return (int)hop::Cfg<128>::bytes;
    case 256: return (int)hop::Cfg<256>::bytes;
    default: return 0;
  }
}

}  // extern "C"
