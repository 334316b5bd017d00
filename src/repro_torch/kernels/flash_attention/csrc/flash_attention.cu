// Flash attention (online softmax) for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention (body
// _flash_kernel): q (B,S,H,hd), k/v (B,T,K,hd) -> o (B,S,H,hd) with causal
// and sliding-window masks and GQA (H = K*G; query head h reads KV head
// h / G, with no copy of K or V). One CTA owns one (q-block of 64 rows,
// head, batch) and streams 64-row K/V tiles through shared memory, keeping
// the online-softmax state (running max m, normaliser l, accumulator) in
// registers, so the (S x T) score matrix never exists. As in the TPU
// kernel, row 0 of q-block iq sits at key position q0 = 64 iq + (T - S),
// and KV tiles that the causal or window mask kills entirely are skipped
// (the lo/hi range). Unlike the TPU kernel, a ragged last q-block or KV
// tile is masked here (rows past S are not stored, keys past T are masked),
// so any S and T work.
//
// Float32 inputs; products are explicit fmaf on the CUDA cores (no TF32, no
// tensor cores yet); a 16 x 16 thread grid, each thread a 4 x 4 score tile
// and a 4 x (hd/16) output tile; row statistics are reduced across the 16
// threads of a row with warp shuffles. No atomics: run to run bitwise.
//
// Bound on the H100 SXM at its 700 W limit (67 TFLOP/s f32 outside the
// tensor cores, 3.35 TB/s HBM): at the zamba2-1.2b prefill shape (B 4,
// S = T = 2048, H = K = 32, hd 64, causal) the work is 68.75 GFLOP over the
// unmasked half of QK^T and PV, and the bytes 0.27 GB, so it is bound by
// operations: 1.03 ms. It takes 3.14 ms there (H100 80GB HBM3, 700 W,
// chip_smoke.py), 33 % of the bound. What bounds it today, by its
// structure: shared-memory loads (half a 32-bit load per fmaf) and the f32
// rate itself. Tensor cores (mma/wgmma, in bf16, or in split products that
// keep f32 accuracy) are the later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;    // query rows per CTA
constexpr int BK = 64;    // keys per streamed tile
constexpr int NT = 256;   // threads per CTA: a 16 x 16 grid
constexpr int PS = BK + 1;

template <int HD>
struct Smem {
  static constexpr int LD = HD + 1;               // padded row stride of Q, K
  static constexpr int q = 0;                     // [BQ][LD]
  static constexpr int k = q + BQ * LD;           // [BK][LD]
  static constexpr int v = k + BK * LD;           // [BK][HD]
  static constexpr int p = v + BK * HD;           // [BQ][PS] probabilities
  static constexpr size_t bytes = sizeof(float) * (p + BQ * PS);
};

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S,
             int T, int H, int K, int causal, int window, float scale) {
  using L_ = Smem<HD>;
  constexpr int LD = L_::LD;
  constexpr int DJ = HD / 16;     // output columns per thread
  extern __shared__ float sm[];
  float* Qs = sm + L_::q;
  float* Ks = sm + L_::k;
  float* Vs = sm + L_::v;
  float* Ps = sm + L_::p;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q_first = iq * BQ;          // first query row of the block
  const int q0 = q_first + (T - S);     // its key position

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, dd = i % HD, row = q_first + r;
    Qs[r * LD + dd] =
        row < S ? q[(((size_t)b * S + row) * H + h) * HD + dd] : 0.f;
  }
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

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const size_t kv_row = (size_t)K * HD;   // stride of one key in k and v
  const float* kb = k + (size_t)b * T * kv_row + (size_t)kh * HD;
  const float* vb = v + (size_t)b * T * kv_row + (size_t)kh * HD;

  for (int kt = lo; kt < hi; ++kt) {
    const int k_first = kt * BK;
    __syncthreads();   // the last tile's K, V and P are read
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, dd = i % HD, t = k_first + r;
      const bool in = t < T;
      Ks[r * LD + dd] = in ? kb[(size_t)t * kv_row + dd] : 0.f;
      Vs[r * HD + dd] = in ? vb[(size_t)t * kv_row + dd] : 0.f;
    }
    __syncthreads();
    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4] = {};
#pragma unroll 8
    for (int dd = 0; dd < HD; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_first + tx + 16 * j;
        const bool ok = kpos < T && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float alpha = 1.f, psum = 0.f;
      if (m_new != -INFINITY) {     // else no live key yet: p = 0
        alpha = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          psum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    // acc += P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll 8
    for (int t = 0; t < BK; ++t) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + t];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[t * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_first + ty + 16 * i;
    if (row < S) {
      const float den = fmaxf(l[i], 1e-30f);
      float* out = o + (((size_t)b * S + row) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = acc[i][j] / den;
    }
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int T, int H, int K, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)HD);
  flash_kernel<HD><<<dim3((S + BQ - 1) / BQ, H, B), NT, smem, stream>>>(
      q, k, v, o, S, T, H, K, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if the kernel is built for this head width, else 0.
int flash_attention_supported(int HD) {
  return HD == 16 || HD == 32 || HD == 64 || HD == 128;
}

// q (B,S,H,HD), k/v (B,T,K,HD), o (B,S,H,HD); float32, contiguous, on the
// device; H a multiple of K; window <= 0 means no window. Returns a
// cudaError_t (0 on success).
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
