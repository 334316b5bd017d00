// Backward of the selective scan (Mamba-1) for NVIDIA Hopper (sm_90a),
// float32.
//
// Replaces no TPU kernel. The reference has no backward Pallas kernel: it
// trains through plain jnp scans that JAX differentiates
// (src/repro/models/mamba.py:117-169, a chunked two-level scan under
// jax.checkpoint). The port's forward runs the hand-written kernel
// (selective_scan.cu), which autograd cannot see through, and the plain
// version may not serve a CUDA tensor: this kernel is the backward of that
// forward (ops.SelectiveScanF32), the gradients of
//     h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) (x) B_t,  y_t = <h_t, C_t> + D u_t
// given dy and the final state's gradient dh. With the adjoint of the state
//     g_t = C_t dy_t + exp(dt_{t+1} A) g_{t+1},   g_{S-1} = C dy + dh,
//     du_t  = dt_t sum_n g_t B_t + D dy_t
//     ddt_t = sum_n g_t (A exp(dt_t A) h_{t-1} + u_t B_t)
//     dA    = sum_{b,t} g_t dt_t exp(dt_t A) h_{t-1}
//     dB_t  = sum_d g_t dt_t u_t,   dC_t = sum_d dy_t h_t,   dD = sum dy u
//     dh0   = exp(dt_0 A) g_0
// (ref.py: selective_scan_bwd_ref, the plain version, walks time the same
// way).
//
// Layout: the forward's grid. A CTA of NT = 128 threads serves CH channels
// of one batch row, a channel's N states over L lanes, SPT a lane (N = 16:
// L = 2, CH = 64). Two passes over time:
//   1. a forward sweep that writes the state entering each chunk of TB = 8
//      steps to a scratch tensor (B, chunks, dI, N): each lane its own SPT
//      states, read back by the same lane;
//   2. the chunks last to first: a chunk's u, dt, dy, B and C are loaded
//      into shared memory, its states recomputed from the boundary state
//      and kept in shared memory (TB x SPT a lane), then the adjoint is
//      carried back over its steps in registers. The exponent is the
//      forward's (ex2.approx.ftz of dt A log2 e, the same operations in
//      the same order), so the recomputed states equal the forward's bit
//      for bit.
// A lane's partial sums over its SPT states (of g B and of the ddt terms)
// go to shared memory and are summed over a channel's L lanes after the
// chunk in a fixed order, as the forward sums C h. The sums over channels
// (dB, dC) are summed over a CTA's CH channels by one warp a (step,
// state) pair, lane partials then a butterfly, and written as one partial
// a CTA; dA and dD are written as one partial a batch row. No float
// atomics: the wrapper sums the partials with torch.sum over their axis
// (CTAs, batch rows), so a train step is bitwise equal run to run.
// Steps past S are zero-filled (zero dt, u, dy, B and C: exp(0) = 1 carries
// the adjoint through unchanged and adds nothing) and never stored, and so
// are channels past dI.
//
// What bounds it: at falcon-mamba-7b's train shape (B 8, S 256, dI 8192,
// N 16) the function reads u, dt, dy (67 MB each), B, C, A, D and writes
// du, ddt (67 MB each), dA, dB, dC, dD: 0.34 GB, 0.10 ms at 3.35 TB/s; the
// function does 268 M (b, t, d, n) elements of 24 operations (chip_smoke.py:
// selective_bwd_ops_bytes), 0.096 ms at 67 TFLOP/s f32, and one exponential
// an element, 0.064 ms at 16 a clock an SM (this kernel takes three: the
// forward sweep, the recompute and the adjoint's carry). This first version
// spends its time on the state's shared-memory round trips and the
// per-step reductions over channels (PERF.md, chip_smoke.py phase 16b).
//
// Numerics: products as explicit fmaf (the build keeps --fmad=false).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NT = 128;     // threads per CTA
constexpr int TB = 8;       // steps per chunk of the backward
constexpr int NWARP = NT / 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Tile {
  static constexpr int SPT = N < 8 ? N : 8;   // states per lane
  static constexpr int L = N / SPT;           // lanes per channel
  static constexpr int CH = NT / L;           // channels per CTA
  // shared memory, in floats: u, dt, dy (TB x CH), B, C (TB x N), the
  // states (TB x SPT x NT), the dB terms (the same), the two per-lane
  // partials (TB x NT), D (CH)
  static constexpr int kFloats = 3 * TB * CH + 2 * TB * N +
                                 2 * TB * SPT * NT + 2 * TB * NT + CH;
};

// 2^x in one MUFU operation (denormal results flush to zero): the forward's
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__global__ void __launch_bounds__(NT)
selective_scan_bwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ D,
                          const float* __restrict__ h0,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh,
                          float* __restrict__ du, float* __restrict__ ddt,
                          float* __restrict__ dAp, float* __restrict__ dBp,
                          float* __restrict__ dCp, float* __restrict__ dDp,
                          float* __restrict__ dh0, float* __restrict__ hck,
                          int S, int dI) {
  constexpr int L = Tile<N>::L, SPT = Tile<N>::SPT, CH = Tile<N>::CH;
  extern __shared__ __align__(16) float smem[];
  float* Us = smem;                      // [TB][CH]
  float* DTs = Us + TB * CH;             // [TB][CH]
  float* DYs = DTs + TB * CH;            // [TB][CH]
  float* Bs = DYs + TB * CH;             // [TB][N]
  float* Cs = Bs + TB * N;               // [TB][N]
  float* Hs = Cs + TB * N;               // [TB][SPT][NT]: h_t, then dy_t h_t
  float* Gs = Hs + TB * SPT * NT;        // [TB][SPT][NT]: g_t dt_t u_t
  float* PU = Gs + TB * SPT * NT;        // [TB][NT]: sum over a lane's g B
  float* PT = PU + TB * NT;              // [TB][NT]: a lane's ddt terms
  float* Ds = PT + TB * NT;              // [CH]

  const int b = blockIdx.y;
  const int blk = blockIdx.x, G = gridDim.x;
  const int d0 = blk * CH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / L, g = tid % L;   // channel in the CTA, state group
  const int d = d0 + c;
  const bool live = d < dI;
  const int nck = (S + TB - 1) / TB;

  float an[SPT], a2[SPT], h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) an[j] = a2[j] = h[j] = 0.f;
  const size_t srow = ((size_t)b * dI + d) * N + g * SPT;   // (b, d) state row
  if (live) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      an[j] = A[(size_t)d * N + g * SPT + j];
      a2[j] = an[j] * kLog2e;
      h[j] = h0 != nullptr ? h0[srow + j] : 0.f;
    }
  }
  if (tid < CH) Ds[tid] = d0 + tid < dI ? D[d0 + tid] : 0.f;

  const float* ub = u + (size_t)b * S * dI;
  const float* dtb = dt + (size_t)b * S * dI;
  const float* dyb = dy + (size_t)b * S * dI;
  const float* bb = Bm + (size_t)b * S * N;
  const float* cb = Cm + (size_t)b * S * N;

  // chunk k's tiles, zero past S and past dI; dy and C only for pass 2
  auto load_chunk = [&](int k, bool adjoint) {
    const int t0 = k * TB;
    for (int e = tid; e < TB * CH; e += NT) {
      const int r = e / CH, col = e % CH;
      const bool ok = t0 + r < S && d0 + col < dI;
      const size_t off = (size_t)(t0 + r) * dI + d0 + col;
      Us[e] = ok ? ub[off] : 0.f;
      DTs[e] = ok ? dtb[off] : 0.f;
      if (adjoint) DYs[e] = ok ? dyb[off] : 0.f;
    }
    for (int e = tid; e < TB * N; e += NT) {
      const int r = e / N;
      const bool ok = t0 + r < S;
      const size_t off = (size_t)t0 * N + e;
      Bs[e] = ok ? bb[off] : 0.f;
      if (adjoint) Cs[e] = ok ? cb[off] : 0.f;
    }
  };
  auto ckpt = [&](int k) -> float* {
    return hck + (((size_t)b * nck + k) * dI + d) * N + g * SPT;
  };

  // ---- pass 1: the forward sweep, the state entering each chunk kept
  for (int k = 0; k < nck; ++k) {
    if (live) {
      float* hk = ckpt(k);
#pragma unroll
      for (int j = 0; j < SPT; ++j) hk[j] = h[j];
    }
    __syncthreads();                 // the previous chunk's tiles are read
    load_chunk(k, false);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float ut = Us[r * CH + c], dtt = DTs[r * CH + c];
      const float dut = dtt * ut;
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        h[j] = fmaf(ex2(dtt * a2[j]), h[j], dut * Bs[r * N + g * SPT + j]);
    }
  }

  // ---- pass 2: the chunks last to first, the adjoint in registers
  float gc[SPT], dA[SPT];            // gc: exp(dt_{t+1} A) g_{t+1}
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    gc[j] = live && dh != nullptr ? dh[srow + j] : 0.f;
    dA[j] = 0.f;
  }
  float dD = 0.f;
  for (int k = nck - 1; k >= 0; --k) {
    __syncthreads();                 // the previous chunk's sums are read
    load_chunk(k, true);
    __syncthreads();
    float hs[SPT];                   // the state entering the chunk
    if (live) {
      const float* hk = ckpt(k);
#pragma unroll
      for (int j = 0; j < SPT; ++j) hs[j] = hk[j];
    } else {
#pragma unroll
      for (int j = 0; j < SPT; ++j) hs[j] = 0.f;
    }
    // the chunk's states again, h_t after step r at Hs[r][j][tid]
#pragma unroll
    for (int j = 0; j < SPT; ++j) h[j] = hs[j];
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float ut = Us[r * CH + c], dtt = DTs[r * CH + c];
      const float dut = dtt * ut;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = fmaf(ex2(dtt * a2[j]), h[j], dut * Bs[r * N + g * SPT + j]);
        Hs[(r * SPT + j) * NT + tid] = h[j];
      }
    }
    // the adjoint, last step first; Hs[r] is read at steps r and r + 1,
    // then overwritten by step r with its dC terms (this lane's own slots)
#pragma unroll
    for (int r = TB - 1; r >= 0; --r) {
      const float ut = Us[r * CH + c], dtt = DTs[r * CH + c];
      const float dyt = DYs[r * CH + c];
      float pu = 0.f, pt = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int n = g * SPT + j;
        const float hp = r > 0 ? Hs[((r - 1) * SPT + j) * NT + tid] : hs[j];
        const float ht = Hs[(r * SPT + j) * NT + tid];
        const float bn = Bs[r * N + n], cn = Cs[r * N + n];
        const float e = ex2(dtt * a2[j]);
        const float gj = fmaf(cn, dyt, gc[j]);
        pu = fmaf(gj, bn, pu);
        pt = fmaf(gj, fmaf(an[j] * e, hp, ut * bn), pt);
        dA[j] = fmaf(gj * dtt * e, hp, dA[j]);
        Gs[(r * SPT + j) * NT + tid] = gj * dtt * ut;
        Hs[(r * SPT + j) * NT + tid] = dyt * ht;
        gc[j] = e * gj;
      }
      PU[r * NT + tid] = pu;
      PT[r * NT + tid] = pt;
      if (g == 0) dD = fmaf(dyt, ut, dD);
    }
    __syncthreads();                 // every lane's terms of the chunk

    const int t0 = k * TB;
    // du and ddt: a channel's L partials summed in the forward's order
    for (int e = tid; e < TB * CH; e += NT) {
      const int r = e / CH, col = e % CH;
      if (t0 + r >= S || d0 + col >= dI) continue;
      float p[L], q[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        p[i] = PU[r * NT + col * L + i];
        q[i] = PT[r * NT + col * L + i];
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
#pragma unroll
        for (int i = 0; i < L; i += 2 * o) {
          p[i] += p[i + o];
          q[i] += q[i + o];
        }
      const size_t off = ((size_t)b * S + t0 + r) * dI + d0 + col;
      du[off] = fmaf(DTs[e], p[0], Ds[col] * DYs[e]);
      ddt[off] = q[0];
    }
    // dB and dC: one warp a (step, state) pair sums the CTA's channels
    for (int pr = warp; pr < TB * N; pr += NWARP) {
      const int r = pr / N, n = pr % N;
      const int gg = n / SPT, j = n % SPT;
      float sb = 0.f, sc = 0.f;
      for (int col = lane; col < CH; col += 32) {
        sb += Gs[(r * SPT + j) * NT + col * L + gg];
        sc += Hs[(r * SPT + j) * NT + col * L + gg];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
        sc += __shfl_xor_sync(0xffffffffu, sc, o);
      }
      if (lane == 0 && t0 + r < S) {
        const size_t off = (((size_t)b * G + blk) * S + t0 + r) * N + n;
        dBp[off] = sb;
        dCp[off] = sc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      dAp[srow + j] = dA[j];
      if (dh0 != nullptr) dh0[srow + j] = gc[j];
    }
    if (g == 0) dDp[(size_t)b * dI + d] = dD;
  }
}

template <int N>
cudaError_t launch(const float* u, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* D,
                   const float* h0, const float* dy, const float* dh,
                   float* du, float* ddt, float* dAp, float* dBp, float* dCp,
                   float* dDp, float* dh0, float* hck, int B, int S, int dI,
                   cudaStream_t stream) {
  constexpr int CH = Tile<N>::CH;
  const size_t smem = sizeof(float) * Tile<N>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dI + CH - 1) / CH, B);
  selective_scan_bwd_kernel<N><<<grid, NT, smem, stream>>>(
      u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp, dBp, dCp, dDp, dh0, hck,
      S, dI);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The partials' sizes: CTAs along dI (the dB and dC partials' second axis)
// and the chunk of the scratch's second axis, for state width N (0 if N is
// not built).
int selective_scan_bwd_groups(int dI, int N) {
  switch (N) {
    case 4: return (dI + Tile<4>::CH - 1) / Tile<4>::CH;
    case 8: return (dI + Tile<8>::CH - 1) / Tile<8>::CH;
    case 16: return (dI + Tile<16>::CH - 1) / Tile<16>::CH;
    default: return 0;
  }
}

int selective_scan_bwd_chunk() { return TB; }

int selective_scan_bwd_smem_bytes(int N) {
  switch (N) {
    case 4: return (int)sizeof(float) * Tile<4>::kFloats;
    case 8: return (int)sizeof(float) * Tile<8>::kFloats;
    case 16: return (int)sizeof(float) * Tile<16>::kFloats;
    default: return 0;
  }
}

// Inputs as selective_scan_f32's, dy (B,S,dI) and dh (B,dI,N) or null;
// du, ddt (B,S,dI); dAp (B,dI,N) and dDp (B,dI), one partial a batch row;
// dBp, dCp (B, groups, S, N), one partial a CTA; dh0 (B,dI,N) or null;
// hck (B, ceil(S / chunk), dI, N) scratch. All float32, contiguous, on the
// device; N one of 4, 8, 16. Returns a cudaError_t (0 on success).
int selective_scan_bwd_f32(const float* u, const float* dt, const float* A,
                           const float* Bm, const float* Cm, const float* D,
                           const float* h0, const float* dy, const float* dh,
                           float* du, float* ddt, float* dAp, float* dBp,
                           float* dCp, float* dDp, float* dh0, float* hck,
                           int B, int S, int dI, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 4:
      return (int)launch<4>(u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp,
                            dBp, dCp, dDp, dh0, hck, B, S, dI, st);
    case 8:
      return (int)launch<8>(u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp,
                            dBp, dCp, dDp, dh0, hck, B, S, dI, st);
    case 16:
      return (int)launch<16>(u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp,
                             dBp, dCp, dDp, dh0, hck, B, S, dI, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
