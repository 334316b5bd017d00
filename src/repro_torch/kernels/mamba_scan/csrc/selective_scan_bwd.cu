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
//   1. a forward sweep that writes the state entering each chunk of TB = 4
//      steps to a scratch tensor (B, chunks, dI, N): each lane its own SPT
//      states, read back by the same lane;
//   2. the chunks last to first: the chunk's states recomputed from its
//      entering state (bit for bit the forward's: ex2.approx.ftz of
//      dt A log2 e and the same fmaf), the factors e = exp(dt A) kept in
//      registers and the states entering its steps in shared memory (TB x
//      SPT a lane), then the adjoint carried back over its steps in
//      registers, reusing e: two exponentials an element in all.
// Every chunk's tiles (u, dt, dy, B, C and the lane's entering state) come
// in by 16-byte cp.async into a ring of NS = 4 stages, three chunks ahead of
// the one that computes (4-byte copies of u, dt and dy where dI % 4 != 0);
// the sweep streams its tiles the same way (two stages, one chunk ahead:
// 3-9 % slower, tools/scan_variants.py).
// Sums: a channel's L lane partials (of g B and of ddt's terms) by
// shuffles (p0 + p1); du and ddt stored from registers. The dB and dC
// terms (2 SPT a lane and step) are summed over the warp's channels in
// registers, in the step loop: a reduce-scatter over the lanes of a state
// group (lanes cl and cl ^ h swap halves, h = SPT, ..., 1: 15 shuffles for
// 16 terms at N = 16), then butterflies over the warp's other channels,
// leaves each lane one (term, state) sum; the CTA's four warp partials go
// through a small array (two chunks' worth, so that one barrier a chunk
// serves) and are summed in warp order into one partial a CTA; dA and dD
// are written as one partial a batch row. No float atomics: the wrapper
// sums the partials with torch.sum over their axis (CTAs, batch rows), so a
// train step is bitwise equal run to run (the order is emulated in
// tests/test_torch_scan_bwd_design.py). Steps past S are zero-filled (zero
// dt, u, dy, B and C: exp(0) = 1 carries the adjoint through unchanged and
// adds nothing) and never stored, and so are channels past dI.
//
// 46 KB of shared memory at N = 16 (55 KB at N = 8) and registers held to
// 128 a thread (__launch_bounds__(NT, 4)): 4 CTAs (16 warps) an SM at every
// N, 1,024 CTAs at the falcon-mamba-7b train shape (B 8, dI 8192).
//
// What bounds it: at that shape (S 256, N 16) the function reads u, dt, dy
// (67 MB each), B, C, A, D and writes du, ddt (67 MB each), dA, dB, dC,
// dD: 0.34 GB, 0.10 ms at 3.35 TB/s; the function does 268 M (b, t, d, n)
// elements of 24 operations (chip_smoke.py: selective_bwd_ops_bytes),
// 0.096 ms at 67 TFLOP/s f32. This design adds its scratch (the state every
// 4 steps: 268 MB written, 268 MB read; with the function's bytes 0.26 ms)
// and two exponentials an element, 0.128 ms at 16 a clock an SM. It takes
// ~0.59-0.60 ms there (the first version of this backward, one pass of
// shared-memory staging a chunk at 8 warps an SM, 1.86; H100 80GB HBM3 at
// 700 W, PERF.md; chip_smoke.py phase 16b, tools/scan_variants.py
// selective_scan_bwd with the variants that chose TB, the states' place,
// the register cap and the ring's depth).
//
// Numerics: products as explicit fmaf (the build keeps --fmad=false).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NT = 128;     // threads per CTA
constexpr int TB = 4;       // steps per chunk of the backward
// stages of the ring of chunk tiles: loads run NS - 1 chunks ahead
constexpr int NS = 4;
constexpr int NWARP = NT / 32;
// CTAs an SM: registers held to 128 a thread
constexpr int kMinCtas = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Tile {
  static constexpr int SPT = N < 8 ? N : 8;   // states per lane
  static constexpr int L = N / SPT;           // lanes per channel
  static constexpr int CH = NT / L;           // channels per CTA
  static constexpr int M = 32 / L;            // channels per warp
  static constexpr int V = 2 * SPT;           // a lane's dB, dC terms a step
  static constexpr int Q4 = SPT / 4;          // float4s of a lane's states
  static constexpr int LOGV = SPT == 8 ? 4 : 3;   // log2 V
  // a stage, in floats: u, dt, dy (TB x CH), B, C (TB x N), the lane's
  // entering state ([Q4][NT] float4s)
  static constexpr int U = 0, DT = TB * CH, DY = 2 * TB * CH;
  static constexpr int B = 3 * TB * CH, C = B + TB * N, HK = C + TB * N;
  static constexpr int STAGE = HK + SPT * NT;
  // the states entering steps 1 .. TB - 1 ([TB - 1][Q4][NT] float4s)
  static constexpr int HS = (TB - 1) * SPT * NT;
  // the warps' dB and dC partials, two chunks: [2][TB][NWARP][2][N]
  static constexpr int WP = 2 * TB * NWARP * 2 * N;
  static constexpr int kFloats = NS * STAGE + HS + WP + CH;
  static_assert(SPT % 4 == 0, "a lane's states in float4s");
  static_assert(V <= M, "a lane's terms fit the lanes of its state group");
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

// until at most n of this thread's copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// 2^x in one MUFU operation (denormal results flush to zero): the forward's
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// SPT consecutive floats from shared memory (16-byte aligned)
template <int SPT>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[SPT]) {
#pragma unroll
  for (int j = 0; j < SPT; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + j);
    x[j] = v.x;
    x[j + 1] = v.y;
    x[j + 2] = v.z;
    x[j + 3] = v.w;
  }
}

// a lane's SPT states at slot base ([Q4][NT] float4s), this lane's
template <int SPT>
__device__ __forceinline__ void load_state(const float* base, float (&x)[SPT]) {
#pragma unroll
  for (int q = 0; q < SPT / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(base)[q * NT + threadIdx.x];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

template <int SPT>
__device__ __forceinline__ void store_state(float* base, const float (&x)[SPT]) {
#pragma unroll
  for (int q = 0; q < SPT / 4; ++q)
    reinterpret_cast<float4*>(base)[q * NT + threadIdx.x] =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

template <int N>
__global__ void __launch_bounds__(NT, kMinCtas)
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
  using Tl = Tile<N>;
  constexpr int L = Tl::L, SPT = Tl::SPT, CH = Tl::CH, M = Tl::M, V = Tl::V;
  constexpr int C4 = CH / 4;             // 16-byte pieces of a tile row
  extern __shared__ __align__(16) float smem[];
  float* HSm = smem + NS * Tl::STAGE;    // states entering steps 1 .. TB - 1
  float* WPm = HSm + Tl::HS;             // warp partials of dB, dC
  float* Ds = WPm + Tl::WP;              // [CH]

  const int b = blockIdx.y;
  const int blk = blockIdx.x, G = gridDim.x;
  const int d0 = blk * CH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / L, g = tid % L;    // channel in the CTA, state group
  const int cl = lane / L;               // channel in the warp
  const int d = d0 + c;
  const bool live = d < dI;
  const bool vec = (dI & 3) == 0;        // u/dt/dy rows start on 16 bytes
  const int nck = (S + TB - 1) / TB;

  // A, and A log2 e formed where it is used (the forward's value, bit for
  // bit, without a register a state for it)
  float an[SPT], h[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) an[j] = h[j] = 0.f;
  const size_t srow = ((size_t)b * dI + d) * N + g * SPT;   // (b, d) state row
  if (live) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      an[j] = A[(size_t)d * N + g * SPT + j];
      h[j] = h0 != nullptr ? h0[srow + j] : 0.f;
    }
  }
  if (tid < CH) Ds[tid] = d0 + tid < dI ? D[d0 + tid] : 0.f;

  const float* ub = u + (size_t)b * S * dI;
  const float* dtb = dt + (size_t)b * S * dI;
  const float* dyb = dy + (size_t)b * S * dI;
  const float* bb = Bm + (size_t)b * S * N;
  const float* cb = Cm + (size_t)b * S * N;
  auto ckpt = [&](int k) -> float* {
    return hck + (((size_t)b * nck + k) * dI + d) * N + g * SPT;
  };

  // chunk k's tiles into stage buf, zero past S and past dI; dy, C and the
  // entering state only for pass 2 (the caller commits the group)
  auto load_chunk = [&](int k, int buf, bool adjoint) {
    float* st = smem + buf * Tl::STAGE;
    const int t0 = k * TB;
    if (vec) {
      for (int e = tid; e < TB * C4; e += NT) {
        const int r = e / C4, col = (e % C4) * 4;
        const bool ok = t0 + r < S && d0 + col < dI;
        const size_t off = ok ? (size_t)(t0 + r) * dI + d0 + col : 0;
        cp_async16(st + Tl::U + r * CH + col, ub + off, ok);
        cp_async16(st + Tl::DT + r * CH + col, dtb + off, ok);
        if (adjoint) cp_async16(st + Tl::DY + r * CH + col, dyb + off, ok);
      }
    } else {
      for (int e = tid; e < TB * CH; e += NT) {
        const int r = e / CH, col = e % CH;
        const bool ok = t0 + r < S && d0 + col < dI;
        const size_t off = ok ? (size_t)(t0 + r) * dI + d0 + col : 0;
        cp_async4(st + Tl::U + e, ub + off, ok);
        cp_async4(st + Tl::DT + e, dtb + off, ok);
        if (adjoint) cp_async4(st + Tl::DY + e, dyb + off, ok);
      }
    }
    for (int e = tid; e < TB * N / 4; e += NT) {
      const int r = e / (N / 4), n = (e % (N / 4)) * 4;
      const bool ok = t0 + r < S;
      const size_t off = ok ? (size_t)(t0 + r) * N + n : 0;
      cp_async16(st + Tl::B + r * N + n, bb + off, ok);
      if (adjoint) cp_async16(st + Tl::C + r * N + n, cb + off, ok);
    }
    if (adjoint) {
      const float* src = live ? ckpt(k) : hck;
#pragma unroll
      for (int q = 0; q < SPT / 4; ++q)
        cp_async16(st + Tl::HK + 4 * (q * NT + tid), src + 4 * q, live);
    }
  };

  // ---- pass 1: the forward sweep, the state entering each chunk kept (the
  // last chunk's steps lead only to the final state: not run); chunk k in
  // stage k % NS, one copy group a chunk (empty past the end)
  const int nsweep = nck - 1;
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nsweep) load_chunk(i, i, false);
    cp_async_commit();
  }
  for (int k = 0; k < nck; ++k) {
    if (live) {
      float* hk = ckpt(k);
#pragma unroll
      for (int j = 0; j < SPT; j += 4)
        *reinterpret_cast<float4*>(hk + j) =
            make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
    }
    if (k == nck - 1) break;
    cp_async_wait<NS - 2>();         // this thread's copies of chunk k
    __syncthreads();                 // everyone's; chunk k - 1 fully read
    if (k + NS - 1 < nsweep) load_chunk(k + NS - 1, (k + NS - 1) % NS, false);
    cp_async_commit();
    const float* st = smem + (k % NS) * Tl::STAGE;
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float ut = st[Tl::U + r * CH + c], dtt = st[Tl::DT + r * CH + c];
      float bn[SPT];
      load_vec<SPT>(st + Tl::B + r * N + g * SPT, bn);
      const float dut = dtt * ut;
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        h[j] = fmaf(ex2(dtt * (an[j] * kLog2e)), h[j], dut * bn[j]);
    }
  }

  // the CTA's dB, dC partials of chunk k: its warps' sums in warp order
  auto flush = [&](int k) {
    const float* wp = WPm + (k & 1) * TB * NWARP * 2 * N;
    const int t0 = k * TB;
    for (int e = tid; e < TB * 2 * N; e += NT) {
      const int r = e / (2 * N), kn = e % (2 * N);
      if (t0 + r >= S) continue;
      const float* p = wp + r * NWARP * 2 * N + kn;
      float s = p[0];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) s += p[w * 2 * N];
      float* out = kn < N ? dBp : dCp;
      out[(((size_t)b * G + blk) * S + t0 + r) * N + kn % N] = s;
    }
  };

  // ---- pass 2: the chunks last to first, the adjoint in registers
  float gc[SPT], dA[SPT];            // gc: exp(dt_{t+1} A) g_{t+1}
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    gc[j] = live && dh != nullptr ? dh[srow + j] : 0.f;
    dA[j] = 0.f;
  }
  float dD = 0.f;
  __syncthreads();                   // the sweep's stages are read
  // chunk nck - 1 - i in stage i % NS
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nck) load_chunk(nck - 1 - i, i, true);
    cp_async_commit();
  }
  for (int it = 0; it < nck; ++it) {
    const int k = nck - 1 - it, buf = k & 1;
    cp_async_wait<NS - 2>();         // this thread's copies of chunk k
    __syncthreads();                 // everyone's; chunk k + 1 fully read,
                                     // its warp partials complete
    if (it + NS - 1 < nck) load_chunk(k - (NS - 1), (it + NS - 1) % NS, true);
    cp_async_commit();
    if (k + 1 < nck) flush(k + 1);
    const float* st = smem + (it % NS) * Tl::STAGE;
    const float* hk = st + Tl::HK;   // the state entering the chunk
    const int t0 = k * TB;

    // the chunk's states again: e = exp(dt A) a step, and the state
    // entering each step
    float e[TB][SPT];
    load_state<SPT>(hk, h);
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float ut = st[Tl::U + r * CH + c], dtt = st[Tl::DT + r * CH + c];
      float bn[SPT];
      load_vec<SPT>(st + Tl::B + r * N + g * SPT, bn);
      if (r > 0) store_state<SPT>(HSm + (r - 1) * SPT * NT, h);
      const float dut = dtt * ut;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        e[r][j] = ex2(dtt * (an[j] * kLog2e));
        h[j] = fmaf(e[r][j], h[j], dut * bn[j]);
      }
    }
    // the adjoint, last step first
    float* wp = WPm + buf * TB * NWARP * 2 * N;
#pragma unroll
    for (int r = TB - 1; r >= 0; --r) {
      const float ut = st[Tl::U + r * CH + c], dtt = st[Tl::DT + r * CH + c];
      const float dyt = st[Tl::DY + r * CH + c];
      float bn[SPT], cn[SPT], hp[SPT];
      load_vec<SPT>(st + Tl::B + r * N + g * SPT, bn);
      load_vec<SPT>(st + Tl::C + r * N + g * SPT, cn);
      load_state<SPT>(r == 0 ? hk : HSm + (r - 1) * SPT * NT, hp);
      const float dut = dtt * ut;
      float pu = 0.f, pt = 0.f, v[V];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float ht = fmaf(e[r][j], hp[j], dut * bn[j]);   // h_t
        const float q = e[r][j] * hp[j];
        const float gj = fmaf(cn[j], dyt, gc[j]);
        pu = fmaf(gj, bn[j], pu);
        pt = fmaf(gj, fmaf(an[j], q, ut * bn[j]), pt);
        dA[j] = fmaf(gj * dtt, q, dA[j]);
        v[j] = gj * dut;             // dB's term
        v[SPT + j] = dyt * ht;       // dC's term
        gc[j] = e[r][j] * gj;
      }
      // a channel's L lane partials: (p0 + p1)
      if constexpr (L == 2) {
        pu += __shfl_xor_sync(0xffffffffu, pu, 1);
        pt += __shfl_xor_sync(0xffffffffu, pt, 1);
      }
      if (g == 0) {
        if (live && t0 + r < S) {
          const size_t off = ((size_t)b * S + t0 + r) * dI + d;
          du[off] = fmaf(dtt, pu, Ds[c] * dyt);
          ddt[off] = pt;
        }
        dD = fmaf(dyt, ut, dD);
      }
      // dB and dC over the warp's channels: lanes cl and cl ^ hh swap
      // halves of their terms (hh = V/2, ..., 1), then the channels apart
      // by V and more. The loops run over a counter so that they unroll:
      // over hh >>= 1 they did not, v went to local memory and the kernel
      // took 2.4 x as long
#pragma unroll
      for (int lv = 1; lv <= Tl::LOGV; ++lv) {
        const int hh = V >> lv;
        const bool upper = (cl & hh) != 0;
#pragma unroll
        for (int i = 0; i < V / 2; ++i) {
          if (i < hh) {
            const float send = upper ? v[i] : v[i + hh];
            const float keep = upper ? v[i + hh] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, hh * L);
          }
        }
      }
#pragma unroll
      for (int lv = 0; (V << lv) < M; ++lv)
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], (V << lv) * L);
      // lane (cl, g) holds term cl of its group: dB (cl < SPT) or dC of
      // state g SPT + cl % SPT
      if (cl < V)
        wp[(r * NWARP + warp) * 2 * N + (cl / SPT) * N + g * SPT + cl % SPT] =
            v[0];
    }
  }
  __syncthreads();                   // chunk 0's warp partials
  flush(0);
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

// CTAs an SM on the current device (-1 on a CUDA error)
template <int N>
int occupancy() {
  const size_t smem = sizeof(float) * Tile<N>::kFloats;
  int n = 0;
  if (cudaFuncSetAttribute(selective_scan_bwd_kernel<N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, selective_scan_bwd_kernel<N>, NT, smem) != cudaSuccess)
    return -1;
  return n;
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

// CTAs an SM at state width N on the current device (0 if N is not built,
// -1 on a CUDA error)
int selective_scan_bwd_ctas_per_sm(int N) {
  switch (N) {
    case 4: return occupancy<4>();
    case 8: return occupancy<8>();
    case 16: return occupancy<16>();
    default: return 0;
  }
}

// Inputs as selective_scan_f32's, dy (B,S,dI) and dh (B,dI,N) or null;
// du, ddt (B,S,dI); dAp (B,dI,N) and dDp (B,dI), one partial a batch row;
// dBp, dCp (B, groups, S, N), one partial a CTA; dh0 (B,dI,N) or null;
// hck (B, ceil(S / chunk), dI, N) scratch. All float32, contiguous, on the
// device, u, dt, dy, B, C and hck on 16-byte boundaries; N one of 4, 8,
// 16. Returns a cudaError_t (0 on success).
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
