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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
// The bf16 entry (flash_attention_bf16): q, k, v and o in bf16. A bf16 x
// bf16 product is exact in f32 and mma.sync m16n8k16 bf16 accumulates in
// f32, which is what the TPU kernel's jnp.dot(..., preferred_element_type=
// float32) computes: one product, no split. Each warp owns 16 query rows
// over the full head width (the hd <= 128 layout at every width: without
// the split the 16 x 256 accumulator, 128 registers, fits beside the rest).
// K and V tiles (64 keys, 32 at hd 256) stream through the same
// double-buffered cp.async ring in bf16; Q's A fragments stay in registers
// up to hd 128 and are read from shared memory at each use at hd 256. The
// S accumulator of two neighbouring 8-key blocks is, element for element,
// the A fragment of P for a 16-key k-step of P V, so P is rounded to bf16
// in registers (__floats2bfloat162_rn, the TPU kernel's p.astype(v.dtype))
// and never leaves them; V's B fragments come from ldmatrix.x4.trans (two
// 8-column blocks a load). The running max, the normaliser (summed from
// the unrounded f32 P, as the TPU kernel sums it), the soft-cap and the
// rescale stay in f32; the output is rounded to bf16 once. Row strides of
// hd + 8 bf16 keep rows 16-byte aligned and the fragment loads and
// ldmatrix free of bank conflicts. No atomics: run to run bitwise.
// Bound: its products at 989 TFLOP/s (dense bf16) against its bytes in
// bf16 and its f32 exponentials; see PERF.md and chip_smoke.py phase 13.
namespace bf16 {
template <int HD>
struct Cfg {
  static constexpr int BK = HD <= 128 ? 64 : 32;  // keys per streamed tile
  static constexpr int RS = HD + 8;               // row stride of Q, K, V (bf16)
  static constexpr bool QREG = HD <= 128;         // Q's fragments in registers
  static constexpr int MINB = HD <= 64 ? 4 : (HD <= 128 ? 2 : 1);  // CTAs an SM
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
  uint32_t qf[CF::QREG ? KK : 1][4];
  if constexpr (CF::QREG) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) q_frag(kk, qf[kk]);
  }
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
      uint32_t a[4];
      if constexpr (CF::QREG) {
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] = qf[kk][c];
      } else {
        q_frag(kk, a);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const uint16_t* kp = Ks + (n * 8 + g) * RS + kk * 16 + 2 * t4;
        mma_bf16(s[n], a, ld32(kp), ld32(kp + 8));
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
// flash_attention_f32, at the same head widths.
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
    case 64: return (int)dispatch_bf16<64>(qb, kb, vb, ob, B, S, T, H, K, causal, window, softcap, st);
    case 128: return (int)dispatch_bf16<128>(qb, kb, vb, ob, B, S, T, H, K, causal, window, softcap, st);
    case 256: return (int)dispatch_bf16<256>(qb, kb, vb, ob, B, S, T, H, K, causal, window, softcap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
