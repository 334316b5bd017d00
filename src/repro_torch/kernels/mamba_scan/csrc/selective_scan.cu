// Selective scan (Mamba-1) for NVIDIA Hopper (sm_90a): an f32 entry and a
// bf16 entry (below).
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
// and the final state in f32; a kernel of its own,
// selective_scan_bf16_hopper<N>. The same lanes and channels a CTA as
// above and, from the shared tiles on, the f32 entry's arithmetic
// operation for operation: its h is the f32 entry's bit for bit on the same
// values widened, and its y is bf16(y_f32) rounded to nearest even
// (widening a bf16 value is exact, a 16-bit shift). What differs is how
// the operands reach the steps:
//   * a ring of kStages = 4 tiles in shared memory, filled by cp.async
//     three tiles ahead (cp.async.wait_group kStages - 3), each element in
//     its own type: u bf16 (16-byte copies of 8 channels), dt f32, B and C
//     bf16 (copies of a row's share of a lane: 16 bytes, 8 at N 4);
//   * B and C widened once a tile, one tile ahead of their steps, into f32
//     rows of the stage, which the steps read as the f32 entry does; u
//     widened where a step uses it, and again in y's epilogue;
//   * each step's operands read from shared memory one step ahead into
//     registers, so their loads and the next step's exponentials overlap
//     this step's FMAs (the compiler does not move a load across the
//     step's store of its partial);
//   * y's epilogue done by each warp for its own channels after
//     __syncwarp, not after a CTA barrier, four channels a lane (8-byte
//     stores where dI % 4 == 0), from rows of u and of the partials padded
//     so that its shared loads do not conflict.
// Where dI % 8 != 0 (no model's width) u cannot go in 16-byte copies: it
// is read by plain 2-byte loads into the ring (those tiles wait for their
// loads) and y is stored a channel at a time where dI % 4 != 0; dt keeps
// its 4-byte copies where dI % 4 != 0.
//
// What bounds it, at the falcon-mamba-7b prefill shape: the function moves
// 0.54 GB (u and y 134 MB each, dt in f32 268 MB), 0.161 ms at 3.35 TB/s;
// its 1.07 G exponentials, one MUFU operation each at 16 a clock an SM,
// take 0.257-0.290 ms at 1.98-1.755 GHz, so no design with one MUFU
// exponential a state-step passes ~60 % of the byte bound. This kernel
// takes ~0.38-0.39 ms there (H100 80GB HBM3, 700 W; PERF.md,
// tools/scan_variants.py selective_scan_bf16), ~10 % less than the f32
// entry on the same values and 1.5 x the f32 template's bf16 instantiation
// it replaces (~0.58 ms: u, B and C widened through registers as they were
// loaded, so each tile waited for its loads). The ablations place the
// rest: without the exponentials ~0.30 ms (the copies, shared loads and
// FMAs alone), without the copies or without y's epilogue ~0.36; operands
// read in their own step, or a CTA barrier before the epilogue, ~0.39-0.40;
// B and C widened in every step ~0.42; rings of 3 or 5 tiles no faster,
// tiles of 32 steps slower; every fourth exponential on the FMA pipe
// ~0.46. It is bound by the MUFU and by the issue and latency of each
// step's chain, not by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

template <int N>
__global__ void __launch_bounds__(NT, kMinCtas)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ D,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hout, int S, int dI) {
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

  const float* ub = u + (size_t)b * S * dI;
  const float* dtb = dt + (size_t)b * S * dI;
  const float* bb = Bm + (size_t)b * S * N;
  const float* cb = Cm + (size_t)b * S * N;

  auto load_tile = [&](int k, int buf) {
    const int t0 = k * TT;
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
      float* yr = y + ((size_t)b * S + t0 + r) * dI + d0 + col;
      if (vec) {
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

// ------------------------------------------------------------------ bf16
// selective_scan_bf16_hopper<N>: the bf16 entry (the header comment says
// how and why). bf16 values travel as their 16-bit patterns (uint16_t).
namespace b16 {

constexpr int kStages = 4;   // tiles in the ring: kStages - 1 copied ahead
constexpr int kTT = 16;      // steps per tile
constexpr int kUPad = 16;    // bf16 after each u row: rows 8 banks apart
constexpr int kPS = NT + 4;  // floats a row of partials: rows 4 banks apart
static_assert(kStages >= 3, "B and C are widened one tile ahead");

// one stage of the ring: u, dt, B and C as copied, each in its own type,
// and B and C widened (once a tile, one tile ahead of their steps)
template <int N>
struct __align__(16) Stage {
  static constexpr int CH = Tile<N>::CH;
  uint16_t u[kTT][CH + kUPad];   // bf16
  float dt[kTT][CH];
  float bf[kTT][N];          // B and C widened
  float cf[kTT][N];
  uint16_t b[kTT][N];        // bf16
  uint16_t c[kTT][N];        // bf16
};

template <int N>
struct Cfg {
  static constexpr int CH = Tile<N>::CH;
  static constexpr size_t ring = kStages * sizeof(Stage<N>);
  static constexpr size_t parts = sizeof(float) * kTT * kPS;  // partials
  static constexpr size_t bytes = ring + parts + sizeof(float) * CH;
};

// a bf16 value widened to f32: a 16-bit shift, exact
__device__ __forceinline__ float wide(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}

// M consecutive bf16 values from shared memory (one 8- or 16-byte load),
// widened
template <int M>
__device__ __forceinline__ void widen(const uint16_t* src, float* out) {
  static_assert(M == 4 || M == 8, "four or eight values");
  uint32_t w[M / 2];
  if constexpr (M == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x; w[1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// M consecutive f32 values from shared memory, 16 bytes a load
template <int M>
__device__ __forceinline__ void load(const float* src, float* out) {
  static_assert(M % 4 == 0, "a multiple of four values");
#pragma unroll
  for (int j = 0; j < M; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + j);
    out[j] = v.x; out[j + 1] = v.y; out[j + 2] = v.z; out[j + 3] = v.w;
  }
}

// cp.async of 8 bytes (zero-filled when !valid)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

template <int N>
__global__ void __launch_bounds__(NT, kMinCtas)
selective_scan_bf16_hopper(const uint16_t* __restrict__ u,
                           const float* __restrict__ dt,
                           const float* __restrict__ A,
                           const uint16_t* __restrict__ Bm,
                           const uint16_t* __restrict__ Cm,
                           const float* __restrict__ D,
                           const float* __restrict__ h0,
                           uint16_t* __restrict__ y,
                           float* __restrict__ hout, int S, int dI) {
  constexpr int L = Tile<N>::L, SPT = Tile<N>::SPT, CH = Tile<N>::CH;
  constexpr int TT = kTT, NS = kStages;
  constexpr int C8 = CH / 8, C4 = CH / 4;   // 8- and 4-channel pieces
  constexpr int RB = 2 * N < 16 ? 2 * N : 16;   // bytes a B/C copy
  constexpr int RQ = 2 * N / RB;                // copies a B/C row
  constexpr int Q = TT * N / 8;                 // 8-value pieces of B, C
  using St = Stage<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  St* ring = reinterpret_cast<St*>(smem);
  // partials <h_t, C_t>, a lane's at [step][lane] (rows kPS apart)
  float* Ps = reinterpret_cast<float*>(smem + Cfg<N>::ring);
  float* Ds = Ps + TT * kPS;                                    // [CH]

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int c = tid / L, g = tid % L;   // channel in the CTA, state group
  const int d = d0 + c;
  const bool live = d < dI;
  constexpr int CW = 32 / L, QW = CW / 4;   // channels of a warp
  const int lane = tid % 32, cw = tid / 32 * CW;  // its first channel
  static_assert(TT * QW % 64 == 0, "whole 4- and 8-channel pieces a lane");
  const bool vec8 = (dI & 7) == 0;      // u rows start on 16 bytes
  const bool vec4 = (dI & 3) == 0;      // dt and y rows on 16 and 8 bytes

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

  const uint16_t* ub = u + (size_t)b * S * dI;
  const float* dtb = dt + (size_t)b * S * dI;
  const uint16_t* bb = Bm + (size_t)b * S * N;
  const uint16_t* cb = Cm + (size_t)b * S * N;

  // tile k's copies into stage s (one commit group; an empty one past the
  // last tile keeps the groups counted the same). Where the rows allow it
  // each thread copies fixed columns of the tile (16 bytes a copy), so the
  // loops below have fixed trip counts
  static_assert(NT % C4 == 0 && TT * C8 % NT == 0 && TT * RQ <= NT,
                "whole 16-byte pieces a thread");
  auto load_tile = [&](int k, int s) {
    St& st = ring[s];
    const int t0 = k * TT;
    if (t0 < S) {
      if (vec8) {
        const int col = tid % C8 * 8;
#pragma unroll
        for (int i = 0; i < TT * C8 / NT; ++i) {
          const int r = (tid + i * NT) / C8;
          const bool ok = t0 + r < S && d0 + col < dI;
          const size_t off = ok ? (size_t)(t0 + r) * dI + d0 + col : 0;
          cp_async16(reinterpret_cast<float*>(&st.u[r][col]),
                     reinterpret_cast<const float*>(ub + off), ok);
        }
      } else {
        // plain 2-byte loads: these tiles wait for their loads
        for (int e = tid; e < TT * CH; e += NT) {
          const int r = e / CH, col = e % CH;
          const bool ok = t0 + r < S && d0 + col < dI;
          st.u[r][col] = ok ? ub[(size_t)(t0 + r) * dI + d0 + col] : 0;
        }
      }
      if (vec4) {
        const int col = tid % C4 * 4;
#pragma unroll
        for (int i = 0; i < TT * C4 / NT; ++i) {
          const int r = (tid + i * NT) / C4;
          const bool ok = t0 + r < S && d0 + col < dI;
          const size_t off = ok ? (size_t)(t0 + r) * dI + d0 + col : 0;
          cp_async16(&st.dt[r][col], dtb + off, ok);
        }
      } else {
        for (int e = tid; e < TT * CH; e += NT) {
          const int r = e / CH, col = e % CH;
          const bool ok = t0 + r < S && d0 + col < dI;
          const size_t off = ok ? (size_t)(t0 + r) * dI + d0 + col : 0;
          cp_async4(&st.dt[r][col], dtb + off, ok);
        }
      }
      if (tid < TT * RQ) {
        const int r = tid / RQ, n = tid % RQ * (RB / 2);
        const bool ok = t0 + r < S;
        const size_t off = ok ? (size_t)(t0 + r) * N + n : 0;
        if constexpr (RB == 16) {
          cp_async16(reinterpret_cast<float*>(&st.b[r][n]),
                     reinterpret_cast<const float*>(bb + off), ok);
          cp_async16(reinterpret_cast<float*>(&st.c[r][n]),
                     reinterpret_cast<const float*>(cb + off), ok);
        } else {
          cp_async8(&st.b[r][n], bb + off, ok);
          cp_async8(&st.c[r][n], cb + off, ok);
        }
      }
    }
    cp_async_commit();
  };

  // B and C of the tile in stage s widened, 8 values a thread at a time
  auto widen_bc = [&](int s) {
    St& st = ring[s];
#pragma unroll
    for (int i = 0; i < (2 * Q + NT - 1) / NT; ++i) {
      const int e = tid + i * NT;
      if (e >= 2 * Q) break;
      const int q = e % Q;
      float v[8];
      widen<8>((e < Q ? &st.b[0][0] : &st.c[0][0]) + 8 * q, v);
      float* dst = (e < Q ? &st.bf[0][0] : &st.cf[0][0]) + 8 * q;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
  };

  const int ntiles = (S + TT - 1) / TT;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) load_tile(s, s);
  cp_async_wait<NS - 2>();           // this thread's copies of tile 0
  __syncthreads();
  widen_bc(0);
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<NS - 3>();         // this thread's copies of tiles k, k + 1
    __syncthreads();                 // everyone's, and tile k's B and C
                                     // widened; tile k - 1 fully read
    load_tile(k + NS - 1, (k + NS - 1) % NS);
    if (k + 1 < ntiles) widen_bc((k + 1) % NS);
    const St& st = ring[k % NS];

    // step r's operands from the stage, widened
    auto read_step = [&](int r, float& ut, float& dtt, float* bn,
                         float* cn) {
      ut = wide(st.u[r][c]);
      dtt = st.dt[r][c];
      load<SPT>(&st.bf[r][g * SPT], bn);
      load<SPT>(&st.cf[r][g * SPT], cn);
    };

    // TT steps, straight-line, the f32 entry's arithmetic on the widened
    // values: zero-filled steps leave h unchanged. Each step's operands are
    // read from shared memory one step ahead, so their loads overlap the
    // step before (a step's partial is stored to shared memory, which the
    // compiler does not move loads across)
    float nu, ndt, nb[SPT], nc[SPT];
    read_step(0, nu, ndt, nb, nc);
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const float ut = nu, dtt = ndt;
      float bn[SPT], cn[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) bn[j] = nb[j], cn[j] = nc[j];
      if (r + 1 < TT) read_step(r + 1, nu, ndt, nb, nc);
      const float du = dtt * ut;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = fmaf(ex2(dtt * a[j]), h[j], du * bn[j]);
        acc = fmaf(h[j], cn[j], acc);
      }
      Ps[r * kPS + tid] = acc;
    }
    __syncwarp();                    // the warp's partials of the tile

    // y = (sum of a channel's L partials) + u D, rounded once to bf16, by
    // the warp whose lanes wrote the partials (so no CTA barrier): its CW
    // channels, four a lane at a time (8-byte stores where dI % 4 == 0)
    const int t0 = k * TT;
#pragma unroll
    for (int i = 0; i < TT * QW / 32; ++i) {
      const int e = lane + 32 * i, r = e / QW, col = cw + e % QW * 4;
      if (t0 + r >= S || d0 + col >= dI) continue;
      float uv[4], out[4];
      widen<4>(&st.u[r][col], uv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float p[L];
#pragma unroll
        for (int j = 0; j < L; ++j) p[j] = Ps[r * kPS + (col + q) * L + j];
#pragma unroll
        for (int o = 1; o < L; o <<= 1)
#pragma unroll
          for (int j = 0; j < L; j += 2 * o) p[j] += p[j + o];
        out[q] = p[0] + uv[q] * Ds[col + q];
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(out[0], out[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(out[2], out[3]);
      const uint32_t w[2] = {*reinterpret_cast<const uint32_t*>(&lo),
                             *reinterpret_cast<const uint32_t*>(&hi)};
      uint16_t* yr = y + ((size_t)b * S + t0 + r) * dI + d0 + col;
      if (vec4) {
        *reinterpret_cast<uint2*>(yr) = make_uint2(w[0], w[1]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (d0 + col + q < dI)
            yr[q] = (uint16_t)(q & 1 ? w[q / 2] >> 16 : w[q / 2] & 0xFFFFu);
      }
    }
  }
  cp_async_wait<0>();                // no copy outlives the CTA
  if (live) {
    const size_t hrow = ((size_t)b * dI + d) * N + g * SPT;
#pragma unroll
    for (int j = 0; j < SPT; ++j) hout[hrow + j] = h[j];
  }
}

template <int N>
cudaError_t launch(const uint16_t* u, const float* dt, const float* A,
                   const uint16_t* Bm, const uint16_t* Cm, const float* D,
                   const float* h0, uint16_t* y, float* hout, int B, int S,
                   int dI, cudaStream_t stream) {
  constexpr int CH = Tile<N>::CH;
  constexpr size_t smem = Cfg<N>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_bf16_hopper<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((dI + CH - 1) / CH, B);
  selective_scan_bf16_hopper<N><<<grid, NT, smem, stream>>>(
      u, dt, A, Bm, Cm, D, h0, y, hout, S, dI);
  return cudaGetLastError();
}

// CTAs an SM on the current device (-1 on a CUDA error)
template <int N>
int occupancy() {
  constexpr size_t smem = Cfg<N>::bytes;
  int n = 0;
  if (cudaFuncSetAttribute(selective_scan_bf16_hopper<N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, selective_scan_bf16_hopper<N>, NT, smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace b16

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
// everything else as selective_scan_f32 (f32); u, dt, Bm and Cm 16-byte
// aligned (y too where dI % 8 == 0).
int selective_scan_bf16(const void* u, const float* dt, const float* A,
                        const void* Bm, const void* Cm, const float* D,
                        const float* h0, void* y, float* hout, int B, int S,
                        int dI, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint16_t* ub = (const uint16_t*)u;
  const uint16_t* bb = (const uint16_t*)Bm;
  const uint16_t* cb = (const uint16_t*)Cm;
  uint16_t* yb = (uint16_t*)y;
  switch (N) {
    case 4:
      return (int)b16::launch<4>(ub, dt, A, bb, cb, D, h0, yb, hout, B, S,
                                 dI, st);
    case 8:
      return (int)b16::launch<8>(ub, dt, A, bb, cb, D, h0, yb, hout, B, S,
                                 dI, st);
    case 16:
      return (int)b16::launch<16>(ub, dt, A, bb, cb, D, h0, yb, hout, B, S,
                                  dI, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 kernel's dynamic shared memory and CTAs an SM (on the current
// device) at state width N (0 if N is not built, -1 on a CUDA error).
int selective_scan_bf16_smem_bytes(int N) {
  switch (N) {
    case 4: return (int)b16::Cfg<4>::bytes;
    case 8: return (int)b16::Cfg<8>::bytes;
    case 16: return (int)b16::Cfg<16>::bytes;
    default: return 0;
  }
}

int selective_scan_bf16_ctas_per_sm(int N) {
  switch (N) {
    case 4: return b16::occupancy<4>();
    case 8: return b16::occupancy<8>();
    case 16: return b16::occupancy<16>();
    default: return 0;
  }
}

}  // extern "C"
