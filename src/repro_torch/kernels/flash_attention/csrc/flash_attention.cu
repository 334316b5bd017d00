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

template <int HD>
__global__ void __launch_bounds__(NT, 3)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S,
             int T, int H, int K, int causal, int window, float scale) {
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
          float x = s[n][2 * r + c] * scale2;
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

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int T, int H, int K, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = Cfg<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)HD);
  flash_kernel<HD><<<dim3(H * B, (S + BQ - 1) / BQ), NT, smem, stream>>>(
      q, k, v, o, S, T, H, K, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if the kernel is built for this head width, else 0.
int flash_attention_supported(int HD) {
  return HD == 16 || HD == 32 || HD == 64 || HD == 128;
}

// q (B,S,H,HD), k/v (B,T,K,HD), o (B,S,H,HD); float32, contiguous, 16-byte
// aligned, on the device; H a multiple of K; window <= 0 means no window.
// Returns a cudaError_t (0 on success).
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, int B, int S, int T, int H, int K, int HD,
                        int causal, int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (HD) {
    case 16: return (int)launch<16>(q, k, v, o, B, S, T, H, K, causal, window, st);
    case 32: return (int)launch<32>(q, k, v, o, B, S, T, H, K, causal, window, st);
    case 64: return (int)launch<64>(q, k, v, o, B, S, T, H, K, causal, window, st);
    case 128: return (int)launch<128>(q, k, v, o, B, S, T, H, K, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
