// Backward of the fused SSD (Mamba-2) scan's f32 entry for NVIDIA Hopper
// (sm_90a), float32 FMA.
//
// Replaces no TPU kernel. The reference has no backward Pallas kernel: it
// trains through the plain chunked matmul (SSD) form that JAX
// differentiates (src/repro/models/mamba.py:235-342). The port's forward
// runs the hand-written kernel (ssd_scan.cu), which autograd cannot see
// through, and the plain version may not serve a CUDA tensor: this kernel
// is the backward of that forward (ops.SsdScanF32), the gradients of
//     h_t = exp(dt_t A_h) h_{t-1} + dt_t B_t (x) u_t,   y_t = C_t h_t + D_h u_t
// given dy and the final state's gradient dh, in the chunked form of
// ref.py: ssd_scan_bwd_ref (its docstring has the terms).
//
// Layout: one CTA of NT = 256 threads per (batch, head), the forward's
// chunk of QC = 64 steps (steps past S load as zeros: zero dt, u, dy, B and
// C add nothing, so any S runs without padding in device memory).
//   1. A forward pass over the T = ceil(S / 64) chunks recomputes the state
//      entering each chunk (N x hp f32, 16 KB at N = hp = 64) and writes it
//      to a scratch tensor (B, H, T, N, hp).
//   2. The chunks last to first: a chunk's u, dy (QC x hp), B, C (QC x N),
//      dt and its entering state are loaded into shared memory; L, the
//      within-chunk cumulative log-decay dt A, by a warp scan; then
//        C B^T, dy u^T (QC x QC), dy H_in^T, u dH^T (QC x N)
//      the masked products M = (C B^T) o W o dt_s, G = (dy u^T) o W o dt_s
//      and Y = (dy u^T) o (C B^T) o W with W_ts = exp(L_t - L_s) for s <= t
//      (never formed for s > t, where it overflows), the gradient of each
//      L_t from every exponent it enters (always differences of L, never a
//      lone exp(-L)), carried to dt and A by a reverse warp scan;
//        du = M^T dy + w (B dH) + D dy,  dC = G B + exp(L) (dy H_in^T),
//        dB = G^T C + w (u dH^T)        (w_s = exp(L_QC - L_s) dt_s)
//      written for rows below S, and the state's adjoint carried to the
//      previous chunk: dH = exp(L_QC) dH + (exp(L) C)^T dy. After the first
//      chunk dH is the gradient of h0.
// Every product is a loop of f32 FMAs over shared memory, each thread a
// 4 x 4 tile of the result (the 64 x 64 products: 256 tiles, one a
// thread). Row strides of QC + 1, N + 1 and hp + 1 floats keep the row and
// column walks of the per-step sums free of bank conflicts; 186 KB of
// shared memory at N = hp = 64, one CTA an SM. The sums that end in a
// per-head scalar through cancelling terms (each step's gradient of L, its
// reverse cumulative sum, ddt's direct terms, dA, dD, <dH, H_in>) are taken
// in f64: taken in f32 (sequential FMA chains of up to 64 terms), a reduced
// zamba2's A_log gradient landed outside phase 18's 1e-4 of the CPU's
// (chip_smoke.py), further than the plain version's own f32 error.
//
// Sums across CTAs have no float atomics: dB and dC (summed over heads)
// are written as one partial a head (B, H, S, N), dA and dD (summed over
// batch and steps) as one a (batch, head); the wrapper sums them with
// torch.sum over their axis, so a train step is bitwise equal run to run.
//
// What bounds it: at zamba2-1.2b's train shape (B 8, S 256, 64 heads,
// hp = N = 64) the function reads u and dy and writes du (33.5 MB each),
// with dt, B, C, ddt, dB and dC 0.104 GB: 0.031 ms at 3.35 TB/s. Its least
// operation count, the chunked form at the best chunk length
// (chip_smoke.py: ssd_bwd_ops_bytes), is 5.84 GFLOP: 0.035 ms as three
// TF32 products each at 495 TFLOP/s, the forward's yardstick (0.087 ms at
// the 67 TFLOP/s f32 FMA peak). Bound by operations. This first version
// does every product as f32 FMAs with both operands read from shared
// memory (PERF.md, chip_smoke.py phase 16b); split-TF32 mma.sync or wgmma
// and a split over S are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int QC = 64;       // the forward's chunk (ssd_scan.cu)
constexpr int NT = 256;      // threads per CTA
constexpr int PQ = QC + 1;   // row stride of the QC x QC tiles

template <int N, int HP>
struct Layout {
  static constexpr int NP = N + 1, HPP = HP + 1;
  // offsets in floats
  static constexpr int U = 0;                      // [QC][HPP]
  static constexpr int DY = U + QC * HPP;          // [QC][HPP]
  static constexpr int B = DY + QC * HPP;          // [QC][NP]
  static constexpr int C = B + QC * NP;            // [QC][NP]
  static constexpr int V = C + QC * NP;            // [QC][NP]: dy H_in^T
  static constexpr int R = V + QC * NP;            // [QC][NP]: u dH^T
  static constexpr int HIN = R + QC * NP;          // [N][HPP]
  static constexpr int DH = HIN + N * HPP;         // [N][HPP]
  static constexpr int P1 = DH + N * HPP;          // [QC][PQ]: C B^T, then M
  static constexpr int P2 = P1 + QC * PQ;          // [QC][PQ]: dy u^T, then G
  static constexpr int P3 = P2 + QC * PQ;          // [QC][PQ]: Y
  static constexpr int VEC = P3 + QC * PQ;         // 5 vectors of QC
  // f64 (an even float offset: 8-byte aligned): 3 vectors of QC, then
  // the block sums
  static constexpr int DVEC = VEC + 5 * QC;
  static constexpr int RED = DVEC + 2 * 3 * QC;
  static constexpr int kFloats = RED + 2 * NT / 32;
};

// every 4 x 4 tile of an MI x MJ result, over the CTA's threads: f(i0, j0)
template <int MI, int MJ, typename F>
__device__ __forceinline__ void for_tiles(F f) {
  constexpr int TJ = MJ / 4, TILES = (MI / 4) * TJ;
  for (int q = threadIdx.x; q < TILES; q += NT) f((q / TJ) * 4, (q % TJ) * 4);
}

// acc[a][c] += sum_k X(i0 + a, k) Y(k, j0 + c)
template <int K, typename FX, typename FY>
__device__ __forceinline__ void mm4(float (&acc)[4][4], int i0, int j0,
                                    FX X, FY Y) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = X(i0 + a, k);
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = Y(k, j0 + c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
}

// a sum over the CTA in a fixed order, in f64: warps by butterflies, then
// every thread over the warps' sums
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                   // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

template <int N, int HP>
__global__ void __launch_bounds__(NT)
ssd_scan_bwd_kernel(const float* __restrict__ u,
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
                    float* __restrict__ dh0, float* __restrict__ hin,
                    int S, int H) {
  using Ly = Layout<N, HP>;
  constexpr int NP = Ly::NP, HPP = Ly::HPP;
  extern __shared__ __align__(16) float smem[];
  float* Us = smem + Ly::U;
  float* DYs = smem + Ly::DY;
  float* Bs = smem + Ly::B;
  float* Cs = smem + Ly::C;
  float* Vs = smem + Ly::V;
  float* Rs = smem + Ly::R;
  float* HIN = smem + Ly::HIN;
  float* DH = smem + Ly::DH;
  float* P1 = smem + Ly::P1;
  float* P2 = smem + Ly::P2;
  float* P3 = smem + Ly::P3;
  float* DT = smem + Ly::VEC;        // dt
  float* Lv = DT + QC;               // L, the cumulative log-decay
  float* EL = Lv + QC;               // exp(L_t)
  float* DEC = EL + QC;              // exp(L_QC - L_s)
  float* WS = DEC + QC;              // exp(L_QC - L_s) dt_s
  // the sums with cancellation (a step's gradient of L, ddt's direct
  // terms, dA, dD) are taken in f64: they end in per-head scalars
  double* DL = reinterpret_cast<double*>(smem + Ly::DVEC);   // of L_t
  double* DTD = DL + QC;             // ddt's direct terms
  double* DTZ = DTD + QC;            // dt_s z_s
  double* red = reinterpret_cast<double*>(smem + Ly::RED);

  const int h = blockIdx.x, b = blockIdx.y;
  const int bh = b * H + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = (S + QC - 1) / QC;
  const float Ah = A[h], Dh = D[h];
  float* hin_bh = hin + (size_t)bh * T * N * HP;

  auto load_chunk = [&](int c, bool adjoint) {
    const int t0 = c * QC;
    for (int e = tid; e < QC * HP; e += NT) {
      const int r = e / HP, p = e % HP;
      const bool ok = t0 + r < S;
      const size_t off = (((size_t)b * S + t0 + r) * H + h) * HP + p;
      Us[r * HPP + p] = ok ? u[off] : 0.f;
      if (adjoint) DYs[r * HPP + p] = ok ? dy[off] : 0.f;
    }
    for (int e = tid; e < QC * N; e += NT) {
      const int r = e / N, n = e % N;
      const bool ok = t0 + r < S;
      const size_t off = ((size_t)b * S + t0 + r) * N + n;
      Bs[r * NP + n] = ok ? Bm[off] : 0.f;
      if (adjoint) Cs[r * NP + n] = ok ? Cm[off] : 0.f;
    }
    for (int r = tid; r < QC; r += NT)
      DT[r] = t0 + r < S ? dt[((size_t)b * S + t0 + r) * H + h] : 0.f;
  };
  // L (warp 0: two steps a lane, a shuffle scan), then the exponentials
  auto decays = [&]() {
    if (warp == 0) {
      const float v0 = DT[2 * lane] * Ah, v1 = DT[2 * lane + 1] * Ah;
      float s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += t;
      }
      float ex = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) ex = 0.f;
      Lv[2 * lane] = ex + v0;
      Lv[2 * lane + 1] = (ex + v0) + v1;
    }
    __syncthreads();
    const float Lend = Lv[QC - 1];
    for (int t = tid; t < QC; t += NT) {
      EL[t] = expf(Lv[t]);
      DEC[t] = expf(Lend - Lv[t]);
      WS[t] = DEC[t] * DT[t];
    }
    __syncthreads();
  };

  // ---- 1. the state entering each chunk, forward
  for (int e = tid; e < N * HP; e += NT)
    HIN[(e / HP) * HPP + e % HP] =
        h0 != nullptr ? h0[(size_t)bh * N * HP + e] : 0.f;
  for (int c = 0; c < T; ++c) {
    __syncthreads();                 // the previous update is done
    for (int e = tid; e < N * HP; e += NT)
      hin_bh[(size_t)c * N * HP + e] = HIN[(e / HP) * HPP + e % HP];
    load_chunk(c, false);
    __syncthreads();
    decays();
    if (c == T - 1) break;           // the last chunk's exit state is unused
    const float eEnd = expf(Lv[QC - 1]);
    for_tiles<N, HP>([&](int i0, int j0) {
      float acc[4][4];
      zero(acc);
      mm4<QC>(acc, i0, j0,
              [&](int n, int s) { return Bs[s * NP + n] * WS[s]; },
              [&](int s, int p) { return Us[s * HPP + p]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& x = HIN[(i0 + a) * HPP + j0 + q];
          x = fmaf(eEnd, x, acc[a][q]);
        }
    });
  }

  // ---- 2. the chunks last to first
  for (int e = tid; e < N * HP; e += NT)
    DH[(e / HP) * HPP + e % HP] =
        dh != nullptr ? dh[(size_t)bh * N * HP + e] : 0.f;
  double dA = 0.0, dD = 0.0;
  for (int c = T - 1; c >= 0; --c) {
    const int t0 = c * QC;
    __syncthreads();                 // the previous chunk is done
    load_chunk(c, true);
    for (int e = tid; e < N * HP; e += NT)
      HIN[(e / HP) * HPP + e % HP] = hin_bh[(size_t)c * N * HP + e];
    __syncthreads();
    decays();
    const float Lend = Lv[QC - 1], eEnd = expf(Lend);

    // C B^T, dy u^T; dy H_in^T, u dH^T
    for_tiles<QC, QC>([&](int i0, int j0) {
      float acc[4][4];
      zero(acc);
      mm4<N>(acc, i0, j0, [&](int t, int n) { return Cs[t * NP + n]; },
             [&](int n, int s) { return Bs[s * NP + n]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) P1[(i0 + a) * PQ + j0 + q] = acc[a][q];
      zero(acc);
      mm4<HP>(acc, i0, j0, [&](int t, int p) { return DYs[t * HPP + p]; },
              [&](int p, int s) { return Us[s * HPP + p]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) P2[(i0 + a) * PQ + j0 + q] = acc[a][q];
    });
    for_tiles<QC, N>([&](int i0, int j0) {
      float acc[4][4];
      zero(acc);
      mm4<HP>(acc, i0, j0, [&](int t, int p) { return DYs[t * HPP + p]; },
              [&](int p, int n) { return HIN[n * HPP + p]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) Vs[(i0 + a) * NP + j0 + q] = acc[a][q];
      zero(acc);
      mm4<HP>(acc, i0, j0, [&](int s, int p) { return Us[s * HPP + p]; },
              [&](int p, int n) { return DH[n * HPP + p]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) Rs[(i0 + a) * NP + j0 + q] = acc[a][q];
    });
    double part = 0.0;               // <dH, H_in>
    for (int e = tid; e < N * HP; e += NT) {
      const int i = (e / HP) * HPP + e % HP;
      part = fma((double)DH[i], (double)HIN[i], part);
    }
    const double dot = block_sum(part, red);  // also the products' barrier

    // the masked products, in place
    for (int e = tid; e < QC * QC; e += NT) {
      const int t = e / QC, s = e % QC;
      const float w = s <= t ? expf(Lv[t] - Lv[s]) : 0.f;
      const float cbv = P1[t * PQ + s], dyu = P2[t * PQ + s];
      const float wd = w * DT[s];
      P1[t * PQ + s] = cbv * wd;     // M
      P2[t * PQ + s] = dyu * wd;     // G
      P3[t * PQ + s] = dyu * cbv * w;   // Y
    }
    __syncthreads();

    // each step's gradient of L and ddt's direct terms
    for (int t = tid; t < QC; t += NT) {
      double row = 0.0, col = 0.0, cv = 0.0, br = 0.0;
      for (int s = 0; s < QC; ++s) {
        row = fma((double)P3[t * PQ + s], (double)DT[s], row);
        col += P3[s * PQ + t];
      }
      for (int n = 0; n < N; ++n) {
        cv = fma((double)Cs[t * NP + n], (double)Vs[t * NP + n], cv);
        br = fma((double)Bs[t * NP + n], (double)Rs[t * NP + n], br);
      }
      const double z = DEC[t] * br, dtt = DT[t];
      DL[t] = row - dtt * col + EL[t] * cv - dtt * z;
      DTD[t] = col + z;
      DTZ[t] = dtt * z;
    }
    __syncthreads();

    // warp 0: dla = the reverse cumulative sum of dL (the chunk's last step
    // also takes the exit state's terms); ddt and dA
    if (warp == 0) {
      double zs = DTZ[2 * lane] + DTZ[2 * lane + 1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) zs += __shfl_xor_sync(0xffffffffu, zs, o);
      const double x0 = DL[2 * lane];
      double x1 = DL[2 * lane + 1];
      if (lane == 31) x1 += eEnd * dot + zs;
      double s = x0 + x1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_down_sync(0xffffffffu, s, o);
        if (lane + o < 32) s += t;
      }
      double ex = __shfl_down_sync(0xffffffffu, s, 1);
      if (lane == 31) ex = 0.0;
      const double dla1 = ex + x1, dla0 = dla1 + x0;
      const int ta = t0 + 2 * lane;
      if (ta < S)
        ddt[((size_t)b * S + ta) * H + h] = (float)fma((double)Ah, dla0,
                                                       DTD[2 * lane]);
      if (ta + 1 < S)
        ddt[((size_t)b * S + ta + 1) * H + h] =
            (float)fma((double)Ah, dla1, DTD[2 * lane + 1]);
      dA = fma((double)DT[2 * lane], dla0, dA);
      dA = fma((double)DT[2 * lane + 1], dla1, dA);
    }

    // du = M^T dy + w (B dH) + D dy
    for_tiles<QC, HP>([&](int i0, int j0) {
      float acc[4][4], st[4][4];
      zero(acc);
      mm4<QC>(acc, i0, j0, [&](int s, int t) { return P1[t * PQ + s]; },
              [&](int t, int p) { return DYs[t * HPP + p]; });
      zero(st);
      mm4<N>(st, i0, j0, [&](int s, int n) { return Bs[s * NP + n]; },
             [&](int n, int p) { return DH[n * HPP + p]; });
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int s = i0 + a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float y = DYs[s * HPP + j0 + q];
          dD = fma((double)y, (double)Us[s * HPP + j0 + q], dD);
          if (t0 + s < S)
            du[(((size_t)b * S + t0 + s) * H + h) * HP + j0 + q] =
                fmaf(Dh, y, fmaf(WS[s], st[a][q], acc[a][q]));
        }
      }
    });
    // dC = G B + exp(L) V, dB = G^T C + w R: this head's partials
    for_tiles<QC, N>([&](int i0, int j0) {
      float acc[4][4];
      zero(acc);
      mm4<QC>(acc, i0, j0, [&](int t, int s) { return P2[t * PQ + s]; },
              [&](int s, int n) { return Bs[s * NP + n]; });
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = i0 + a;
        if (t0 + t >= S) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dCp[((size_t)bh * S + t0 + t) * N + j0 + q] =
              fmaf(EL[t], Vs[t * NP + j0 + q], acc[a][q]);
      }
      zero(acc);
      mm4<QC>(acc, i0, j0, [&](int s, int t) { return P2[t * PQ + s]; },
              [&](int t, int n) { return Cs[t * NP + n]; });
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int s = i0 + a;
        if (t0 + s >= S) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dBp[((size_t)bh * S + t0 + s) * N + j0 + q] =
              fmaf(WS[s], Rs[s * NP + j0 + q], acc[a][q]);
      }
    });
    __syncthreads();                 // dH is read; now carried back

    // dH = exp(L_QC) dH + (exp(L) C)^T dy
    for_tiles<N, HP>([&](int i0, int j0) {
      float acc[4][4];
      zero(acc);
      mm4<QC>(acc, i0, j0,
              [&](int n, int t) { return EL[t] * Cs[t * NP + n]; },
              [&](int t, int p) { return DYs[t * HPP + p]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& x = DH[(i0 + a) * HPP + j0 + q];
          x = fmaf(eEnd, x, acc[a][q]);
        }
    });
  }
  __syncthreads();
  if (dh0 != nullptr)
    for (int e = tid; e < N * HP; e += NT)
      dh0[(size_t)bh * N * HP + e] = DH[(e / HP) * HPP + e % HP];
  // warp 0 alone holds dA; every thread holds a share of dD
  const double sA = block_sum(warp == 0 ? dA : 0.0, red);
  const double sD = block_sum(dD, red);
  if (tid == 0) {
    dAp[bh] = (float)sA;
    dDp[bh] = (float)sD;
  }
}

template <int N, int HP>
cudaError_t launch(const float* u, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* D,
                   const float* h0, const float* dy, const float* dh,
                   float* du, float* ddt, float* dAp, float* dBp, float* dCp,
                   float* dDp, float* dh0, float* hin, int B, int S, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout<N, HP>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_kernel<N, HP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_scan_bwd_kernel<N, HP><<<grid, NT, smem, stream>>>(
      u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp, dBp, dCp, dDp, dh0, hin,
      S, H);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_hp(int hp, const float* u, const float* dt,
                      const float* A, const float* Bm, const float* Cm,
                      const float* D, const float* h0, const float* dy,
                      const float* dh, float* du, float* ddt, float* dAp,
                      float* dBp, float* dCp, float* dDp, float* dh0,
                      float* hin, int B, int S, int H, cudaStream_t st) {
  switch (hp) {
    case 16:
      return launch<N, 16>(u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp,
                           dBp, dCp, dDp, dh0, hin, B, S, H, st);
    case 32:
      return launch<N, 32>(u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp,
                           dBp, dCp, dDp, dh0, hin, B, S, H, st);
    case 64:
      return launch<N, 64>(u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp,
                           dBp, dCp, dDp, dh0, hin, B, S, H, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ssd_scan_bwd_chunk() { return QC; }

// shared memory of the kernel at (N, hp), bytes (0 if not built)
int ssd_scan_bwd_smem_bytes(int N, int hp) {
  const int k = 3 * (N == 16) + 2 * (N == 32) + (N == 64) - 1;   // 2, 1, 0
  const int j = 3 * (hp == 16) + 2 * (hp == 32) + (hp == 64) - 1;
  if (k < 0 || j < 0) return 0;
  const int floats[3][3] = {
      {Layout<64, 64>::kFloats, Layout<64, 32>::kFloats,
       Layout<64, 16>::kFloats},
      {Layout<32, 64>::kFloats, Layout<32, 32>::kFloats,
       Layout<32, 16>::kFloats},
      {Layout<16, 64>::kFloats, Layout<16, 32>::kFloats,
       Layout<16, 16>::kFloats}};
  return (int)sizeof(float) * floats[k][j];
}

// Inputs as ssd_scan_f32's, dy (B,S,H,hp) and dh (B,H,N,hp) or null; du
// (B,S,H,hp), ddt (B,S,H); dAp, dDp (B,H) and dBp, dCp (B,H,S,N), one
// partial a (batch, head); dh0 (B,H,N,hp) or null; hin (B, H,
// ceil(S / 64), N, hp) scratch. All float32, contiguous, on the device; N
// and hp each 16, 32 or 64. Returns a cudaError_t (0 on success).
int ssd_scan_bwd_f32(const float* u, const float* dt, const float* A,
                     const float* Bm, const float* Cm, const float* D,
                     const float* h0, const float* dy, const float* dh,
                     float* du, float* ddt, float* dAp, float* dBp,
                     float* dCp, float* dDp, float* dh0, float* hin, int B,
                     int S, int H, int N, int hp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 16:
      return (int)launch_hp<16>(hp, u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt,
                                dAp, dBp, dCp, dDp, dh0, hin, B, S, H, st);
    case 32:
      return (int)launch_hp<32>(hp, u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt,
                                dAp, dBp, dCp, dDp, dh0, hin, B, S, H, st);
    case 64:
      return (int)launch_hp<64>(hp, u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt,
                                dAp, dBp, dCp, dDp, dh0, hin, B, S, H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
