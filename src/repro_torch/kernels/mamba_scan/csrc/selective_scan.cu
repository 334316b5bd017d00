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
// The N states of a channel are split over L neighbouring lanes, SPT =
// min(N, 8) states a lane (N = 16: L = 2, CH = 64), so B * dI * L threads
// run (65,536 at the falcon-mamba-7b prefill shape, B 4, dI 8192: 512 CTAs,
// four an SM at up to 128 registers a thread). Time runs in tiles of
// TT = 16 steps: each tile's u and dt (TT x CH) and B and C (TT x N) are
// copied into shared memory with 16-byte cp.async while the previous tile
// is computed (two buffers); only where dI % 4 != 0 do u and dt go as
// 4-byte copies. Steps past S and channels past dI are zero-filled (zero
// dt and u leave h as it is: exp(0) h + 0) and never stored.
//
// The step loop has no branch and no shuffle: every lane writes its
// partial <h_t, C_t> over its SPT states into a shared (TT x NT) tile, so
// the TT unrolled steps are one basic block and the next steps' shared
// loads and exponentials issue while this step's FMAs wait. After the tile
// the CTA sums each channel's L partials (in the order of the butterfly
// shuffles would use: (p0 + p1) + (p2 + p3)), adds u D and stores y with
// 16-byte stores. Each exponential is one MUFU operation: A is scaled by
// log2(e) once a lane and exp(dt A) is ex2.approx.ftz(dt A log2 e)
// (relative error ~2^-22; the kernel stays within the plain version's
// 2e-4 tolerance, PERF.md).
//
// What bounds it, at the falcon-mamba-7b prefill shape (B 4, S 2048,
// dI 8192, N 16) on the H100 SXM at its 700 W limit: the function moves
// 0.81 GB (u, dt and y are 268 MB each), 0.24 ms at 3.35 TB/s, and does
// 7.7 GFLOP, 0.12 ms at 67 TFLOP/s: it is bound by bytes. The kernel's own
// floor is its 1.07 G exponentials, ~0.29 ms at 16 a clock an SM. The
// first version of this kernel (a C reduction by two shuffles and a store
// by one lane a channel at every step, 4 lanes a channel) took ~1.0-1.1 ms
// there; this one ~0.44-0.48 ms (H100 80GB HBM3, 700 W; PERF.md,
// chip_smoke.py), about 58 % of the exponentials' rate. Variants
// (tools/scan_variants.py): with expf in place of ex2 ~0.68 ms; with 4
// lanes a channel ~0.63 ms, 8 lanes ~1.18 ms, 1 lane ~0.45 ms: fewer lanes
// a channel read each step's B and C from shared memory fewer times, and
// two lanes keep enough warps to cover the exponentials' latency.
//
// Numerics: products as explicit fmaf (the build keeps --fmad=false for
// the SPH kernels). No atomics: bitwise equal run to run.
//
// bf16 entry (selective_scan_bf16): u, B, C and y in bf16; dt, A, D, h0
// and the final state in f32. The same template: u, B and C are read with
// plain 2-byte loads and widened into the same f32 shared-memory tiles (dt
// still by cp.async), y is rounded to bf16 once as it is stored (8-byte
// stores of four channels where dI % 4 == 0). From the tiles on the
// arithmetic is the f32 entry's, as the TPU kernel upcasts everything.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NT = 128;     // threads per CTA
constexpr int TT = 16;      // steps per tile
// CTAs an SM: registers held to 128 a thread, so that the 512 CTAs of the
// falcon-mamba-7b prefill (B 4, dI 8192) run in one wave on 132 SMs
constexpr int kMinCtas = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Tile {
  static constexpr int SPT = N < 8 ? N : 8;   // states per lane
  static constexpr int L = N / SPT;           // lanes per channel
  static constexpr int CH = NT / L;           // channels per CTA
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;     // 0: zero-fill, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;    // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x in one MUFU operation (denormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the element type of u, B, C and y: float or bf16
using bf16_t = __nv_bfloat16;

__device__ __forceinline__ float widen(bf16_t x) { return __bfloat162float(x); }

template <int N, typename T>
__global__ void __launch_bounds__(NT, kMinCtas)
selective_scan_kernel(const T* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const T* __restrict__ Bm,
                      const T* __restrict__ Cm,
                      const float* __restrict__ D,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ hout, int S, int dI) {
  constexpr bool F32 = sizeof(T) == sizeof(float);
  constexpr int L = Tile<N>::L, SPT = Tile<N>::SPT, CH = Tile<N>::CH;
  constexpr int C4 = CH / 4;             // 16-byte chunks of a tile row
  __shared__ __align__(16) float Us[2][TT][CH];
  __shared__ __align__(16) float DTs[2][TT][CH];
  __shared__ __align__(16) float Bs[2][TT][N];
  __shared__ __align__(16) float Cs[2][TT][N];
  __shared__ __align__(16) float Ps[TT][NT];   // partial <h_t, C_t> a lane
  __shared__ float Ds[CH];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int c = tid / L, g = tid % L;   // channel in the CTA, state group
  const int d = d0 + c;
  const bool live = d < dI;
  const bool vec = (dI & 3) == 0;       // u/dt rows start on 16 bytes

  float a[SPT], h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) a[j] = h[j] = 0.f;
  if (live) {
    const size_t row = (size_t)d * N + g * SPT;
    const size_t hrow = ((size_t)b * dI + d) * N + g * SPT;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      a[j] = A[row + j] * kLog2e;
      h[j] = h0 != nullptr ? h0[hrow + j] : 0.f;
    }
  }
  if (tid < CH) Ds[tid] = d0 + tid < dI ? D[d0 + tid] : 0.f;

  const T* ub = u + (size_t)b * S * dI;
  const float* dtb = dt + (size_t)b * S * dI;
  const T* bb = Bm + (size_t)b * S * N;
  const T* cb = Cm + (size_t)b * S * N;

  auto load_tile = [&](int k, int buf) {
    const int t0 = k * TT;
    if constexpr (!F32) {
      // dt by cp.async; u, B and C widened through registers
      if (vec) {
        for (int e = tid; e < TT * C4; e += NT) {
          const int r = e / C4, col = (e % C4) * 4;
          const bool ok = t0 + r < S && d0 + col < dI;
          cp_async16(&DTs[buf][r][col],
                     dtb + (ok ? (size_t)(t0 + r) * dI + d0 + col : 0), ok);
        }
      } else {
        for (int e = tid; e < TT * CH; e += NT) {
          const int r = e / CH, col = e % CH;
          const bool ok = t0 + r < S && d0 + col < dI;
          cp_async4(&DTs[buf][r][col],
                    dtb + (ok ? (size_t)(t0 + r) * dI + d0 + col : 0), ok);
        }
      }
      cp_async_commit();
      for (int e = tid; e < TT * CH; e += NT) {
        const int r = e / CH, col = e % CH;
        const bool ok = t0 + r < S && d0 + col < dI;
        Us[buf][r][col] = ok ? widen(ub[(size_t)(t0 + r) * dI + d0 + col]) : 0.f;
      }
      for (int e = tid; e < TT * N; e += NT) {
        const int r = e / N, n = e % N;
        const bool ok = t0 + r < S;
        const size_t off = (size_t)(t0 + r) * N + n;
        Bs[buf][r][n] = ok ? widen(bb[off]) : 0.f;
        Cs[buf][r][n] = ok ? widen(cb[off]) : 0.f;
      }
    } else {
      if (vec) {
        for (int e = tid; e < TT * C4; e += NT) {
          const int r = e / C4, col = (e % C4) * 4;
          const bool ok = t0 + r < S && d0 + col < dI;
          const size_t off = ok ? (size_t)(t0 + r) * dI + d0 + col : 0;
          cp_async16(&Us[buf][r][col], ub + off, ok);
          cp_async16(&DTs[buf][r][col], dtb + off, ok);
        }
      } else {
        for (int e = tid; e < TT * CH; e += NT) {
          const int r = e / CH, col = e % CH;
          const bool ok = t0 + r < S && d0 + col < dI;
          const size_t off = ok ? (size_t)(t0 + r) * dI + d0 + col : 0;
          cp_async4(&Us[buf][r][col], ub + off, ok);
          cp_async4(&DTs[buf][r][col], dtb + off, ok);
        }
      }
      for (int e = tid; e < TT * N / 4; e += NT) {
        const int r = e / (N / 4), n = (e % (N / 4)) * 4;
        const bool ok = t0 + r < S;
        const size_t off = ok ? (size_t)(t0 + r) * N + n : 0;
        cp_async16(&Bs[buf][r][n], bb + off, ok);
        cp_async16(&Cs[buf][r][n], cb + off, ok);
      }
      cp_async_commit();
    }
  };

  const int ntiles = (S + TT - 1) / TT;
  load_tile(0, 0);
  for (int k = 0; k < ntiles; ++k) {
    const int buf = k & 1;
    cp_async_wait_all();             // this thread's copies of tile k
    __syncthreads();                 // everyone's; tile k - 1 fully read
    if (k + 1 < ntiles) load_tile(k + 1, buf ^ 1);

    // TT steps, straight-line: zero-filled steps leave h unchanged
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const float ut = Us[buf][r][c], dtt = DTs[buf][r][c];
      float bn[SPT], cn[SPT];
      if constexpr (SPT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < SPT; j += 4) {
          const float4 bv =
              *reinterpret_cast<const float4*>(&Bs[buf][r][g * SPT + j]);
          const float4 cv =
              *reinterpret_cast<const float4*>(&Cs[buf][r][g * SPT + j]);
          bn[j] = bv.x; bn[j + 1] = bv.y; bn[j + 2] = bv.z; bn[j + 3] = bv.w;
          cn[j] = cv.x; cn[j + 1] = cv.y; cn[j + 2] = cv.z; cn[j + 3] = cv.w;
        }
      } else {
        static_assert(SPT == 2, "two or a multiple of four states a lane");
        const float2 bv = *reinterpret_cast<const float2*>(&Bs[buf][r][g * 2]);
        const float2 cv = *reinterpret_cast<const float2*>(&Cs[buf][r][g * 2]);
        bn[0] = bv.x; bn[1] = bv.y;
        cn[0] = cv.x; cn[1] = cv.y;
      }
      const float du = dtt * ut;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = fmaf(ex2(dtt * a[j]), h[j], du * bn[j]);
        acc = fmaf(h[j], cn[j], acc);
      }
      Ps[r][tid] = acc;
    }
    __syncthreads();                 // every partial of the tile written

    // y = (sum of a channel's L partials) + u D, four channels a thread
    const int t0 = k * TT;
    for (int e = tid; e < TT * C4; e += NT) {
      const int r = e / C4, col = (e % C4) * 4;
      if (t0 + r >= S || d0 + col >= dI) continue;
      float out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float p[L];
#pragma unroll
        for (int i = 0; i < L; ++i) p[i] = Ps[r][(col + q) * L + i];
#pragma unroll
        for (int o = 1; o < L; o <<= 1)
#pragma unroll
          for (int i = 0; i < L; i += 2 * o) p[i] += p[i + o];
        out[q] = p[0] + Us[buf][r][col + q] * Ds[col + q];
      }
      T* yr = y + ((size_t)b * S + t0 + r) * dI + d0 + col;
      if constexpr (!F32) {
        if (vec) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(out[0], out[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(out[2], out[3]);
          uint2 w;
          w.x = *reinterpret_cast<const unsigned*>(&lo);
          w.y = *reinterpret_cast<const unsigned*>(&hi);
          *reinterpret_cast<uint2*>(yr) = w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (d0 + col + q < dI) yr[q] = __float2bfloat16_rn(out[q]);
        }
      } else if (vec) {
        *reinterpret_cast<float4*>(yr) =
            make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (d0 + col + q < dI) yr[q] = out[q];
      }
    }
  }
  if (live) {
    const size_t hrow = ((size_t)b * dI + d) * N + g * SPT;
#pragma unroll
    for (int j = 0; j < SPT; ++j) hout[hrow + j] = h[j];
  }
}

template <int N, typename T>
cudaError_t launch(const T* u, const float* dt, const float* A,
                   const T* Bm, const T* Cm, const float* D,
                   const float* h0, T* y, float* hout, int B, int S,
                   int dI, cudaStream_t stream) {
  constexpr int CH = Tile<N>::CH;
  const dim3 grid((dI + CH - 1) / CH, B);
  selective_scan_kernel<N, T><<<grid, NT, 0, stream>>>(u, dt, A, Bm, Cm, D,
                                                        h0, y, hout, S, dI);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u/dt (B,S,dI), A (dI,N), Bm/Cm (B,S,N), D (dI), h0 (B,dI,N) or null;
// y (B,S,dI), hout (B,dI,N). All float32, contiguous, 16-byte aligned, on
// the device; N one of 4, 8, 16. Returns a cudaError_t (0 on success).
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

// The bf16 entry: u/y (B,S,dI) and Bm/Cm (B,S,N) bf16 (2 bytes each),
// everything else as selective_scan_f32 (f32); u and y 8-byte aligned,
// dt 16-byte aligned.
int selective_scan_bf16(const void* u, const float* dt, const float* A,
                        const void* Bm, const void* Cm, const float* D,
                        const float* h0, void* y, float* hout, int B, int S,
                        int dI, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16_t* ub = (const bf16_t*)u;
  const bf16_t* bb = (const bf16_t*)Bm;
  const bf16_t* cb = (const bf16_t*)Cm;
  bf16_t* yb = (bf16_t*)y;
  switch (N) {
    case 4:
      return (int)launch<4>(ub, dt, A, bb, cb, D, h0, yb, hout, B, S, dI, st);
    case 8:
      return (int)launch<8>(ub, dt, A, bb, cb, D, h0, yb, hout, B, S, dI, st);
    case 16:
      return (int)launch<16>(ub, dt, A, bb, cb, D, h0, yb, hout, B, S, dI, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
