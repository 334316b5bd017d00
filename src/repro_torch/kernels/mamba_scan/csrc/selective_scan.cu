// Selective scan (Mamba-1) for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py:
// selective_scan (body _scan_kernel): the diagonal-A recurrence
//     h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) (x) B_t,
//     y_t = <h_t, C_t> + D u_t,
// which returns y and the final h. The TPU kernel keeps a (channel block
// x N) state tile in VMEM and walks time with lax.scan; here the state
// lives in registers and each thread walks time in an explicit loop.
//
// Layout. A CTA of NT = 128 threads serves CH channels of one batch row.
// The N states of a channel are split over L = N / 4 neighbouring lanes,
// four states a lane (N = 16: L = 4, CH = 32), so B * dI * L threads run
// (131,072 at the falcon-mamba-7b prefill shape, B 4, dI 8192: 31 warps
// an SM rather than 8 with one thread per channel), and y_t is summed over
// the L lanes with __shfl_xor_sync. Time runs in tiles of TT steps
// (TT * CH = 1024): each tile's u and dt (TT x CH) and B and C (TT x N) are
// copied into shared memory with cp.async while the previous tile is
// computed (two buffers), so the serial walk never waits on device memory.
// Threads on neighbouring channels copy neighbouring addresses, and y is
// stored by one lane a channel, 32 bytes a warp a step. Steps past S and
// channels past dI are zero-filled and never stored: any S, any dI.
//
// What bounds it, at the falcon-mamba-7b prefill shape (B 4, S 2048,
// dI 8192, N 16) on the H100 SXM at its 700 W limit: the function moves
// 0.81 GB (u, dt and y are 268 MB each), 0.24 ms at 3.35 TB/s, and does
// 7.7 GFLOP (7 per (b, t, d, n): dt A, exp, the decay multiply, the input
// and C FMAs; 3 per (b, t, d)), 0.12 ms at 67 TFLOP/s: it is bound by
// bytes. The kernel takes ~1.0-1.1 ms there (H100 80GB HBM3, 700 W,
// chip_smoke.py), 22 % of the bound, moving 0.8 TB/s. Variants of this
// source (tools/scan_variants.py) show that neither the accurate expf
// (__expf saves 9 %), the SFU (~0.3 ms of ex2) nor issued instructions
// (~0.5 ms) set the time; the per-step chain (shared loads, the C
// reduction, two shuffles, ~100 cycles a step) is the suspect.
//
// Numerics: expf, not __expf; products as explicit fmaf (the build keeps
// --fmad=false for the SPH kernels). No atomics: bitwise equal run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NT = 128;     // threads per CTA
constexpr int SPT = 4;      // states per thread

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;     // 0: zero-fill, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int N>
struct Tile {
  static constexpr int L = N / SPT;      // lanes per channel
  static constexpr int CH = NT / L;      // channels per CTA
  static constexpr int TT = 1024 / CH;   // steps per tile
};

template <int N>
__global__ void __launch_bounds__(NT)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ D,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hout, int S, int dI) {
  constexpr int L = Tile<N>::L, CH = Tile<N>::CH, TT = Tile<N>::TT;
  __shared__ __align__(16) float Us[2][TT][CH];
  __shared__ __align__(16) float DTs[2][TT][CH];
  __shared__ __align__(16) float Bs[2][TT][N];
  __shared__ __align__(16) float Cs[2][TT][N];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int c = tid / L, g = tid % L;   // channel in the CTA, state group
  const int d = d0 + c;
  const bool live = d < dI;

  float a[SPT], h[SPT];
  float dd = 0.f;
#pragma unroll
  for (int j = 0; j < SPT; ++j) a[j] = h[j] = 0.f;
  if (live) {
    const size_t row = (size_t)d * N + g * SPT;
    const size_t hrow = ((size_t)b * dI + d) * N + g * SPT;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      a[j] = A[row + j];
      h[j] = h0 != nullptr ? h0[hrow + j] : 0.f;
    }
    dd = D[d];
  }

  const float* ub = u + (size_t)b * S * dI;
  const float* dtb = dt + (size_t)b * S * dI;
  const float* bb = Bm + (size_t)b * S * N;
  const float* cb = Cm + (size_t)b * S * N;

  auto load_tile = [&](int k, int buf) {
    const int t0 = k * TT;
    for (int e = tid; e < TT * CH; e += NT) {
      const int r = e / CH, col = e % CH;
      const bool ok = t0 + r < S && d0 + col < dI;
      const size_t off = ok ? (size_t)(t0 + r) * dI + d0 + col : 0;
      cp_async4(&Us[buf][r][col], ub + off, ok);
      cp_async4(&DTs[buf][r][col], dtb + off, ok);
    }
    for (int e = tid; e < TT * N; e += NT) {
      const int r = e / N, n = e % N;
      const bool ok = t0 + r < S;
      const size_t off = ok ? (size_t)(t0 + r) * N + n : 0;
      cp_async4(&Bs[buf][r][n], bb + off, ok);
      cp_async4(&Cs[buf][r][n], cb + off, ok);
    }
    cp_async_commit();
  };

  const int ntiles = (S + TT - 1) / TT;
  load_tile(0, 0);
  for (int k = 0; k < ntiles; ++k) {
    const int buf = k & 1;
    if (k + 1 < ntiles)
      load_tile(k + 1, buf ^ 1);
    else
      cp_async_commit();             // an empty group keeps the count
    cp_async_wait_one();             // this thread's copies of tile k
    __syncthreads();                 // everyone's copies of tile k
    const int t0 = k * TT;
    const int steps = min(TT, S - t0);
    float* yt = y + ((size_t)b * S + t0) * dI + d;
#pragma unroll 4
    for (int r = 0; r < steps; ++r) {
      const float ut = Us[buf][r][c], dtt = DTs[buf][r][c];
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][r][g * SPT]);
      const float4 cv = *reinterpret_cast<const float4*>(&Cs[buf][r][g * SPT]);
      const float bn[SPT] = {bv.x, bv.y, bv.z, bv.w};
      const float cn[SPT] = {cv.x, cv.y, cv.z, cv.w};
      const float du = dtt * ut;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = fmaf(expf(dtt * a[j]), h[j], du * bn[j]);
        acc = fmaf(h[j], cn[j], acc);
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (g == 0 && live) yt[(size_t)r * dI] = acc + ut * dd;
    }
    __syncthreads();                 // tile k read before it is refilled
  }
  if (live) {
    const size_t hrow = ((size_t)b * dI + d) * N + g * SPT;
#pragma unroll
    for (int j = 0; j < SPT; ++j) hout[hrow + j] = h[j];
  }
}

template <int N>
cudaError_t launch(const float* u, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* D,
                   const float* h0, float* y, float* hout, int B, int S,
                   int dI, cudaStream_t stream) {
  constexpr int CH = Tile<N>::CH;
  const dim3 grid((dI + CH - 1) / CH, B);
  selective_scan_kernel<N><<<grid, NT, 0, stream>>>(u, dt, A, Bm, Cm, D, h0,
                                                     y, hout, S, dI);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u/dt (B,S,dI), A (dI,N), Bm/Cm (B,S,N), D (dI), h0 (B,dI,N) or null;
// y (B,S,dI), hout (B,dI,N). All float32, contiguous, on the device;
// N one of 4, 8, 16. Returns a cudaError_t (0 on success).
int selective_scan_f32(const float* u, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* D,
                       const float* h0, float* y, float* hout, int B, int S,
                       int dI, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 4:
      return (int)launch<4>(u, dt, A, Bm, Cm, D, h0, y, hout, B, S, dI, st);
    case 8:
      return (int)launch<8>(u, dt, A, Bm, Cm, D, h0, y, hout, B, S, dI, st);
    case 16:
      return (int)launch<16>(u, dt, A, Bm, Cm, D, h0, y, hout, B, S, dI, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
