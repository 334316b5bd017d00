// Fused SSD (Mamba-2) scan for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:ssd_scan
// (body _ssd_kernel): the scalar-decay-per-head SSM
//     h_t = exp(dt_t A_h) h_{t-1} + dt_t B_t (x) u_t,   y_t = C_t h_t + D_h u_t
// in the chunked matmul form. The TPU kernel holds one (batch, head) strip
// in VMEM and carries the (N, hp) state across chunks with lax.scan; here
// one CTA owns one (batch, head) and walks the chunks in order, keeping
// the state in shared memory: the loop over chunks takes the place of the
// lax.scan. Per chunk of QC = 64 steps:
//   1. load u (QC, hp), B (QC, N) transposed, C (QC, N), dt (QC); steps past
//      S load as zeros, and zero dt makes them inert (the ragged last chunk
//      needs no padding in device memory);
//   2. L = cumsum(dt A) (one thread, in order);
//   3. M[t][s] = (C_t . B_s) exp(L_t - L_s) dt_s for s <= t, else 0;
//   4. y_t = sum_s M[t][s] u_s + exp(L_t) C_t h + D u_t;
//   5. h = exp(L_QC) h + sum_s B_s exp(L_QC - L_s) dt_s (x) u_s.
// The internal chunk is 64, not the model's 128: the working set is then
// 84 KB of shared memory at N = hp = 64 (128 would take 176 KB), so two CTAs
// share an SM and B*H = 256 CTAs fill the 132 SMs in one wave. The result is
// chunk-invariant up to rounding. Products run as explicit fmaf on the CUDA
// cores in float32 (no TF32, no tensor cores yet): a 16 x 16 thread grid,
// each thread a 4 x (w/16) register tile. No atomics: run to run bitwise.
//
// Bound on the H100 SXM at its 700 W limit (67 TFLOP/s f32 outside the
// tensor cores, 3.35 TB/s HBM): at the zamba2-1.2b prefill shape (B 4,
// S 2048, H 64, hp = N = 64) the function needs 9.42 GFLOP (the least
// count of the chunked form over chunk lengths, at Q = 6, with the Q x Q
// products on s <= t only; this kernel's Q = 64 does 12.99) and moves
// 0.28 GB, so it is bound by operations: 0.141 ms. It takes 1.00 ms there
// (H100 80GB HBM3, 700 W, chip_smoke.py), 14 % of the bound. What bounds
// it today, by its structure: shared-memory loads, half a 32-bit load per
// fmaf of a 4 x 4 tile step. Tensor cores (mma/wgmma on the Q x Q, Q x N and Q x hp
// products) are the later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int QC = 64;       // internal chunk length
constexpr int NT = 256;      // threads per CTA: a 16 x 16 grid
constexpr int QS = QC + 1;   // padded row stride of Bt and M (no bank clash)

template <int N, int HP>
struct Smem {
  static constexpr int CN = N + 1;                // padded row stride of C
  static constexpr int u = 0;                     // [QC][HP]
  static constexpr int bt = u + QC * HP;          // [N][QS]   B transposed
  static constexpr int c = bt + N * QS;           // [QC][CN]
  static constexpr int m = c + QC * CN;           // [QC][QS]
  static constexpr int h = m + QC * QS;           // [N][HP]   the state
  static constexpr int L = h + N * HP;            // [QC] cumulative log-decay
  static constexpr int dt = L + QC;               // [QC]
  static constexpr int w = dt + QC;               // [QC] dt_s exp(L_QC - L_s)
  static constexpr int eL = w + QC;               // [QC] exp(L_t)
  static constexpr size_t bytes = sizeof(float) * (eL + QC);
};

template <int N, int HP>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ hout, int S, int H) {
  using L_ = Smem<N, HP>;
  constexpr int CN = L_::CN;
  constexpr int NI = N / 16;     // state rows per thread
  constexpr int PJ = HP / 16;    // u / y / state columns per thread
  extern __shared__ float sm[];
  float* Us = sm + L_::u;
  float* Bt = sm + L_::bt;
  float* Cs = sm + L_::c;
  float* Ms = sm + L_::m;
  float* Hs = sm + L_::h;
  float* Ls = sm + L_::L;
  float* dts = sm + L_::dt;
  float* ws = sm + L_::w;
  float* eLs = sm + L_::eL;

  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a = A[hh], d = D[hh];

  const size_t state_off = ((size_t)b * H + hh) * N * HP;
  for (int i = tid; i < N * HP; i += NT)
    Hs[i] = h0 != nullptr ? h0[state_off + i] : 0.f;

  const size_t row = (size_t)H * HP;   // stride of one step in u and y
  const float* ub = u + (size_t)b * S * row + (size_t)hh * HP;
  float* yb = y + (size_t)b * S * row + (size_t)hh * HP;
  const float* bb = Bm + (size_t)b * S * N;
  const float* cb = Cm + (size_t)b * S * N;
  const float* db = dt + (size_t)b * S * H + hh;

  const int nchunks = (S + QC - 1) / QC;
  for (int ck = 0; ck < nchunks; ++ck) {
    const int c0 = ck * QC;
    // 1. load the chunk; steps past S are zeros
    for (int i = tid; i < QC * HP; i += NT) {
      const int t = i / HP, p = i % HP;
      Us[i] = c0 + t < S ? ub[(size_t)(c0 + t) * row + p] : 0.f;
    }
    for (int i = tid; i < QC * N; i += NT) {
      const int t = i / N, n = i % N;
      const bool in = c0 + t < S;
      Bt[n * QS + t] = in ? bb[(size_t)(c0 + t) * N + n] : 0.f;
      Cs[t * CN + n] = in ? cb[(size_t)(c0 + t) * N + n] : 0.f;
    }
    if (tid < QC)
      dts[tid] = c0 + tid < S ? db[(size_t)(c0 + tid) * H] : 0.f;
    __syncthreads();
    // 2. cumulative log-decay within the chunk
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < QC; ++t) {
        acc += dts[t] * a;
        Ls[t] = acc;
      }
    }
    __syncthreads();
    if (tid < QC) {
      ws[tid] = expf(Ls[QC - 1] - Ls[tid]) * dts[tid];
      eLs[tid] = expf(Ls[tid]);
    }
    // 3. M = (C B^T) exp(L_t - L_s) dt_s on s <= t; rows t = ty + 16 i,
    //    columns s = tx + 16 j
    {
      float acc[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * CN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bt[n * QS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          Ms[t * QS + s] =
              s <= t ? acc[i][j] * expf(Ls[t] - Ls[s]) * dts[s] : 0.f;
        }
      }
    }
    __syncthreads();
    // 4. y = M u + exp(L_t) C h + D u; rows t = ty + 16 i, columns
    //    p = tx + 16 j
    {
      float yi[4][PJ] = {}, yc[4][PJ] = {};
      const int smax = ty + 16 * 3;   // M is zero past this thread's last row
      for (int s = 0; s <= smax; ++s) {
        float mv[4], uv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = Ms[(ty + 16 * i) * QS + s];
#pragma unroll
        for (int j = 0; j < PJ; ++j) uv[j] = Us[s * HP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yi[i][j] = fmaf(mv[i], uv[j], yi[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * CN + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = Hs[n * HP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yc[i][j] = fmaf(cv[i], hv[j], yc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (c0 + t < S) {
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const int p = tx + 16 * j;
            yb[(size_t)(c0 + t) * row + p] =
                (yi[i][j] + eLs[t] * yc[i][j]) + Us[t * HP + p] * d;
          }
        }
      }
    }
    __syncthreads();
    // 5. h = exp(L_QC) h + sum_s (B_s w_s) (x) u_s; rows n = ty + 16 i,
    //    columns p = tx + 16 j
    {
      float sc[NI][PJ] = {};
      for (int s = 0; s < QC; ++s) {
        const float wv = ws[s];
        float bv[NI], uv[PJ];
#pragma unroll
        for (int i = 0; i < NI; ++i) bv[i] = Bt[(ty + 16 * i) * QS + s] * wv;
#pragma unroll
        for (int j = 0; j < PJ; ++j) uv[j] = Us[s * HP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) sc[i][j] = fmaf(bv[i], uv[j], sc[i][j]);
      }
      const float dq = expf(Ls[QC - 1]);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int k = (ty + 16 * i) * HP + tx + 16 * j;
          Hs[k] = dq * Hs[k] + sc[i][j];
        }
    }
    __syncthreads();
  }
  for (int i = tid; i < N * HP; i += NT) hout[state_off + i] = Hs[i];
}

template <int N, int HP>
cudaError_t launch(const float* u, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* D,
                   const float* h0, float* y, float* hout, int B, int S,
                   int H, cudaStream_t stream) {
  const size_t smem = Smem<N, HP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<N, HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  ssd_scan_kernel<N, HP><<<dim3(H, B), NT, smem, stream>>>(
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
// y (B,S,H,HP), hout (B,H,N,HP). All float32, contiguous, on the device.
// Returns a cudaError_t (0 on success).
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

}  // extern "C"
