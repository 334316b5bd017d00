// The backward of flash attention's f32 entry for NVIDIA Hopper (sm_90a):
// given q (B,S,H,hd), k/v (B,T,K,hd), the forward's output o, its row
// log-sum-exp lse (B,H,S) and the output's gradient dO, it returns dQ, dK
// and dV, with the forward's masks (causal with query row i at key position
// i + T - S, a sliding window), soft-cap and GQA (H = K*G, query head h
// reads KV head h / G).
//
// It has no TPU counterpart: the reference trains by differentiating plain
// jnp attention (src/repro/models/layers.py:_sdpa) with jax.value_and_grad,
// and JAX cannot differentiate its Pallas kernel
// (src/repro/kernels/flash_attention/kernel.py:flash_attention). This is the
// FlashAttention-2 backward of the port's forward (flash_attention.cu):
//
//   D   = rowsum(dO o O)                         (flash_bwd_dsum)
//   P   = exp(s - lse),  s = Q K^T / sqrt(hd), soft-capped c tanh(s / c)
//   dV  = P^T dO
//   dS  = P o (dO V^T - D)  [o (1 - tanh^2) under a soft-cap]
//   dK  = dS^T Q / sqrt(hd),  dQ = dS K / sqrt(hd)
//
// One kernel template, flash_bwd_kernel<HD, MODE, CAP>, launched twice, with
// no atomics: each output row is written by exactly one CTA, so a run is
// bitwise the next. A CTA owns 64 rows (four warps of 16, the forward's
// layout) and streams tiles of the other side through a cp.async ring:
//
//   MODE  rows (owned)          columns (streamed)           accumulates
//   DQ    queries of head h     keys of KV head h / G        dQ: dS K
//   DKV   keys of KV head kh    queries of its G heads,      dK: dS^T Q
//                               head by head, in order       dV: P^T dO
//
// Each tile recomputes s = A_rows X1^T over the full head width (DQ: Q K^T;
// DKV: K Q^T, the same dot products transposed), P from the saved lse, and
// the second product dO V^T (or V dO^T) for dS; then accumulates dS X1 (and,
// for DKV, P X2 in a second accumulator), where dS and P are already in the
// A-fragment layout of the accumulator (the forward's trick: within each
// 8-wide k-step the k index runs over (2t, 2t + 1) pairs, so no data moves
// between threads). The GQA sum over a group runs inside one CTA in head
// order. The two launches do 7 products per live (query, key) pair against
// the 5 of one kernel that also reduced dQ across CTAs (s and dP twice):
// the price of writing each dQ row from one CTA, without atomics.
//
// All products are mma.sync m16n8k8 in TF32 split into three (big*big +
// big*small + small*big, split_tf32.cuh), as in the forward: f32 accuracy.
// Tile ranges skip what the masks kill, as the forward does: DQ the key
// tiles before the window and after the diagonal; DKV the query tiles
// before the diagonal (causal: query i sees key j iff j <= i + T - S) and
// after the window. Every element is then masked on its own. Rows past S or
// T are zero-filled and never stored; a padded query column has lse = +inf,
// so its P is 0. A query row with no live key has lse = +inf (the forward's
// row_lse), so its P, dS and its gradients are 0, not NaN.
//
// Head width 256: a 16 x 256 accumulator is 128 registers a thread, so each
// CTA accumulates 128 output columns (blockIdx.z picks which; DKV holds two
// such accumulators, dK's and dV's) and the two halves recompute s and dP
// apiece (11 products a live pair); the 256-wide row tiles (135 KB for two)
// leave room for one 32-row column stage, so at hd 256 the ring has one
// stage (load, then compute), at the smaller widths two. The column tile
// is 64 rows up to hd 64, 16 at hd 128, 32 at hd 256: the fastest of
// tools/flash_bwd_variants.py's (the columns are summed in one order
// whatever the tile, so every variant gives the same bits). At hd 256 the
// duplicated products make the kernel slower than the plain autograd; a
// pair of warps splitting each tile's columns, as the forward's
// flash_kernel_wide does, is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

#include "split_tf32.cuh"

constexpr int BR = 64;   // output rows per CTA
constexpr int NW = 4;    // warps per CTA, 16 rows each
constexpr int NT = 32 * NW;
constexpr float LOG2E = 1.44269504f;

enum Mode { DQ = 0, DKV = 1 };

template <int HD>
struct Cfg {
  // columns per streamed tile: at hd 128, 16 keep a CTA at 105 KB of
  // shared memory, so two fit an SM (their registers too: DKV takes 255,
  // and 2 x 128 threads x 256 fill the 65,536)
  static constexpr int BC = HD <= 64 ? 64 : (HD == 128 ? 16 : 32);
  static constexpr int NST = HD <= 128 ? 2 : 1;     // stages of the ring
  static constexpr int DC = HD <= 128 ? HD : 128;   // output columns per CTA
  static constexpr int RS = HD + 8;                 // row stride of every tile
  // rows: A [BR][RS] (Q or K), then E [BR][RS] (dO or V)
  static constexpr int rows = 2 * BR * RS;
  // a stage: X1 [BC][RS], X2 [BC][RS], then (DKV) lse*log2(e) and D of its
  // BC query columns
  static constexpr int stage = 2 * BC * RS + 2 * BC;
  static constexpr size_t bytes = sizeof(float) * (rows + NST * stage);
};

// D = rowsum(dO o O): one warp a (b, s, h) row in memory order, lanes over
// hd in a fixed order, written to dsum (B, H, S)
__global__ void flash_bwd_dsum(const float* __restrict__ o,
                               const float* __restrict__ dout,
                               float* __restrict__ dsum, int S, int H, int HD,
                               long long nrows) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= nrows) return;
  const float* a = o + row * HD;
  const float* b = dout + row * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(a[d], b[d], acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const long long h = row % H, bs = row / H;
    const long long s = bs % S, bb = bs / S;
    dsum[(bb * H + h) * S + s] = acc;
  }
}

template <int HD, int MODE, bool CAP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 float* __restrict__ grad, float* __restrict__ grad_v,
                 int S, int T, int H, int K, int causal, int window,
                 float scale, float cap) {
  using CF = Cfg<HD>;
  constexpr int BC = CF::BC, RS = CF::RS, DC = CF::DC, NST = CF::NST;
  constexpr bool QROWS = MODE == DQ;   // rows are queries (else keys)
  constexpr int KK = HD / 8;           // k-steps of the score products
  constexpr int NK = BC / 8;           // 8-column blocks of a tile
  constexpr int ND = DC / 8;           // 8-wide blocks of the output columns
  constexpr int CH = HD / 4;           // 16-byte chunks of a row
  extern __shared__ __align__(16) float sm[];

  const int G = H / K;
  const int nrh = QROWS ? H : K;       // heads of the row side
  const int rh = blockIdx.x % nrh, b = blockIdx.x / nrh;
  // causal DQ: the last row blocks see the most keys; DKV: the first
  const int ib = QROWS ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int c0 = blockIdx.z * DC;      // first output column of this CTA
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * LOG2E;
  const int off = T - S;               // key position of query row 0
  const int r_first = ib * BR;
  const int nrows = QROWS ? S : T, ncols = QROWS ? T : S;
  const int nct = (ncols + BC - 1) / BC;

  // the live column tiles (for DKV: of each of the G heads)
  int lo = 0, hi = nct;
  if (QROWS) {
    if (causal) {
      const int last = r_first + off + BR - 1;
      hi = last < 0 ? 0 : min(nct, last / BC + 1);
    }
    if (window > 0) {
      const int first = r_first + off - window + 1;
      lo = first > 0 ? first / BC : 0;
    }
  } else {
    if (causal) {
      const int first = r_first - off;
      lo = first > 0 ? first / BC : 0;
    }
    if (window > 0) {
      const int last = r_first + BR - 1 - off + window - 1;
      hi = last < 0 ? 0 : min(nct, last / BC + 1);
    }
  }
  const int span = hi > lo ? hi - lo : 0;
  const int n_it = QROWS ? span : G * span;

  // row-side and column-side tensors: DQ rows Q, dO / columns K, V;
  // DKV rows K, V / columns Q, dO of head kh * G + gi
  const int kh = QROWS ? rh / G : rh;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)K * HD;
  const float* ra = QROWS ? q + (size_t)b * S * q_row + (size_t)rh * HD
                          : k + (size_t)b * T * kv_row + (size_t)kh * HD;
  const float* re = QROWS ? dout + (size_t)b * S * q_row + (size_t)rh * HD
                          : v + (size_t)b * T * kv_row + (size_t)kh * HD;
  const size_t r_stride = QROWS ? q_row : kv_row;

  float* As = sm;
  float* Es = sm + BR * RS;
  auto stage_at = [&](int st) { return sm + CF::rows + st * CF::stage; };

  auto load_tile = [&](int it, int st) {
    const int gi = QROWS ? 0 : it / span;
    const int ct = lo + (QROWS ? it : it % span);
    float* X1 = stage_at(st);
    float* X2 = X1 + BC * RS;
    const float* x1;
    const float* x2;
    size_t c_stride;
    if (QROWS) {
      x1 = k + (size_t)b * T * kv_row + (size_t)kh * HD;
      x2 = v + (size_t)b * T * kv_row + (size_t)kh * HD;
      c_stride = kv_row;
    } else {
      const int h = kh * G + gi;
      x1 = q + (size_t)b * S * q_row + (size_t)h * HD;
      x2 = dout + (size_t)b * S * q_row + (size_t)h * HD;
      c_stride = q_row;
      float* Ls = X2 + BC * RS;
      float* Ds = Ls + BC;
      const size_t base = ((size_t)b * H + h) * S;
      for (int i = tid; i < BC; i += NT) {
        const int qi = ct * BC + i;
        const bool in = qi < S;
        Ls[i] = in ? lse[base + qi] * LOG2E : INFINITY;
        Ds[i] = in ? dsum[base + qi] : 0.f;
      }
    }
    for (int i = tid; i < BC * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 4, t = ct * BC + r;
      const bool in = t < ncols;
      const size_t o2 = (size_t)(in ? t : 0) * c_stride + c;
      cp_async16(X1 + r * RS + c, x1 + o2, in);
      cp_async16(X2 + r * RS + c, x2 + o2, in);
    }
    cp_async_commit();
  };
  if (NST == 2 && n_it > 0) load_tile(0, 0);

  // the row tiles, zero past the last row
  for (int i = tid; i < BR * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4, row = r_first + r;
    float4 xa = make_float4(0.f, 0.f, 0.f, 0.f), xe = xa;
    if (row < nrows) {
      xa = *reinterpret_cast<const float4*>(ra + (size_t)row * r_stride + c);
      xe = *reinterpret_cast<const float4*>(re + (size_t)row * r_stride + c);
    }
    *reinterpret_cast<float4*>(As + r * RS + c) = xa;
    *reinterpret_cast<float4*>(Es + r * RS + c) = xe;
  }
  const int ra0 = r_first + warp * 16 + g;   // this thread's rows: ra0, ra0 + 8
  // DQ: each row's lse (base 2) and D
  float lr[2] = {INFINITY, INFINITY}, dr[2] = {0.f, 0.f};
  if (QROWS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra0 + 8 * r;
      if (row < S) {
        const size_t idx = ((size_t)b * H + rh) * S + row;
        lr[r] = lse[idx] * LOG2E;
        dr[r] = dsum[idx];
      }
    }
  }
  __syncthreads();
  const float* arow = As + (warp * 16 + g) * RS + 2 * t4;
  const float* erow = Es + (warp * 16 + g) * RS + 2 * t4;

  // DQ: dQ; DKV: dK in acc, dV in acc_v
  float acc[ND][4], acc_v[QROWS ? 1 : ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[n][c] = 0.f;
      if constexpr (!QROWS) acc_v[n][c] = 0.f;
    }

  for (int it = 0; it < n_it; ++it) {
    int st = 0;
    if (NST == 2) {
      st = it & 1;
      if (it + 1 < n_it) {
        load_tile(it + 1, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_tile(it, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* X1 = stage_at(st);
    const float* X2 = X1 + BC * RS;
    const float* Ls = X2 + BC * RS;
    const float* Ds = Ls + BC;
    const int cf = (lo + (QROWS ? it : it % span)) * BC;   // first column

    // s = A X1^T and dp = E X2^T for this warp's 16 rows, BC columns
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t ab[4], as[4];
      q_fragment(arow + kk * 8, RS, ab, as);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(
            X1 + (n * 8 + g) * RS + kk * 8 + 2 * t4);
        uint32_t bb0, bs0, bb1, bs1;
        split(x.x, bb0, bs0);
        split(x.y, bb1, bs1);
        mma3(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
      q_fragment(erow + kk * 8, RS, ab, as);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(
            X2 + (n * 8 + g) * RS + kk * 8 + 2 * t4);
        uint32_t bb0, bs0, bb1, bs1;
        split(x.x, bb0, bs0);
        split(x.y, bb1, bs1);
        mma3(dp[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }

    // P in place of s, dS in place of dp; s[n] holds rows (g, g + 8) x
    // columns (2t, 2t + 1) of block n
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra0 + 8 * r;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cl = n * 8 + 2 * t4 + c;   // column within the tile
          const int col = cf + cl;
          const int qi = QROWS ? row : col;    // query row
          const int kpos = QROWS ? col : row;  // key position
          const int qpos = qi + off;
          const bool ok = qi < S && kpos < T && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          const float x = s[n][2 * r + c];
          float sc, th = 0.f;
          if constexpr (CAP) {
            th = tanhf(x * scale / cap);
            sc = cap * th * LOG2E;
          } else {
            sc = x * scale2;
          }
          const float l2 = QROWS ? lr[r] : Ls[cl];
          const float p = ok ? exp2f(sc - l2) : 0.f;
          const float dq = QROWS ? dr[r] : Ds[cl];
          float ds = p * (dp[n][2 * r + c] - dq);
          if constexpr (CAP) ds *= 1.f - th * th;
          s[n][2 * r + c] = p;
          dp[n][2 * r + c] = ds;
        }
    }

    // acc += dS X1[:, c0 .. c0 + DC) (X1: K for DQ, Q for DKV); DKV also
    // acc_v += P X2[:, c0 .. c0 + DC) (X2: dO)
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t wb[4], ws[4], pb[4], ps[4];
      split(dp[n][0], wb[0], ws[0]);
      split(dp[n][2], wb[1], ws[1]);
      split(dp[n][1], wb[2], ws[2]);
      split(dp[n][3], wb[3], ws[3]);
      if constexpr (!QROWS) {
        split(s[n][0], pb[0], ps[0]);
        split(s[n][2], pb[1], ps[1]);
        split(s[n][1], pb[2], ps[2]);
        split(s[n][3], pb[3], ps[3]);
      }
      const float* m1 = X1 + (n * 8 + 2 * t4) * RS + c0 + g;
      const float* m2 = X2 + (n * 8 + 2 * t4) * RS + c0 + g;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        uint32_t bb0, bs0, bb1, bs1;
        split(m1[d * 8], bb0, bs0);
        split(m1[RS + d * 8], bb1, bs1);
        mma3(acc[d], wb, ws, bb0, bb1, bs0, bs1);
        if constexpr (!QROWS) {
          split(m2[d * 8], bb0, bs0);
          split(m2[RS + d * 8], bb1, bs1);
          mma3(acc_v[d], pb, ps, bb0, bb1, bs0, bs1);
        }
      }
    }
    __syncthreads();   // this stage is read: the next load may refill it
  }

  // dQ and dK carry the score scale; dV does not
  const size_t o_stride = QROWS ? q_row : kv_row;
  const size_t o0 = (size_t)b * nrows * o_stride + (size_t)rh * HD + c0 + 2 * t4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra0 + 8 * r;
    if (row < nrows) {
      const size_t o = o0 + (size_t)row * o_stride;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        *reinterpret_cast<float2*>(grad + o + d * 8) =
            make_float2(acc[d][2 * r] * scale, acc[d][2 * r + 1] * scale);
        if constexpr (!QROWS)
          *reinterpret_cast<float2*>(grad_v + o + d * 8) =
              make_float2(acc_v[d][2 * r], acc_v[d][2 * r + 1]);
      }
    }
  }
}

template <int HD, int MODE, bool CAP>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* dsum,
                       float* grad, float* grad_v, int B, int S, int T,
                       int H, int K, int causal, int window, float cap,
                       cudaStream_t st) {
  using CF = Cfg<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<HD, MODE, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CF::bytes);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)HD);
  const int heads = MODE == DQ ? H : K;
  const int rows = MODE == DQ ? S : T;
  const dim3 grid(heads * B, (rows + BR - 1) / BR, HD / CF::DC);
  flash_bwd_kernel<HD, MODE, CAP><<<grid, NT, CF::bytes, st>>>(
      q, k, v, dout, lse, dsum, grad, grad_v, S, T, H, K, causal, window,
      scale, cap);
  return cudaGetLastError();
}

template <int HD, bool CAP>
cudaError_t run_bwd(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* dsum,
                    float* dq, float* dk, float* dv, int B, int S, int T,
                    int H, int K, int causal, int window, float cap,
                    cudaStream_t st) {
  cudaError_t e = launch_bwd<HD, DQ, CAP>(q, k, v, dout, lse, dsum, dq,
                                          nullptr, B, S, T, H, K, causal,
                                          window, cap, st);
  if (e != cudaSuccess) return e;
  return launch_bwd<HD, DKV, CAP>(q, k, v, dout, lse, dsum, dk, dv, B, S, T,
                                  H, K, causal, window, cap, st);
}

template <int HD>
cudaError_t dispatch_bwd(const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* dsum, float* dq, float* dk, float* dv,
                         int B, int S, int T, int H, int K, int causal,
                         int window, float cap, cudaStream_t st) {
  if (cap > 0.f)
    return run_bwd<HD, true>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H,
                             K, causal, window, cap, st);
  return run_bwd<HD, false>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H,
                            K, causal, window, cap, st);
}

}  // namespace

extern "C" {

// The gradients of flash_attention_f32's output o with respect to q, k and
// v, given the output's gradient dout (B,S,H,HD) and the forward's lse
// (B,H,S). q, o, dout, dq (B,S,H,HD); k, v, dk, dv (B,T,K,HD); dsum (B,H,S)
// is a workspace the call fills with rowsum(dout o o). All float32,
// contiguous, 16-byte aligned, on the device; the masks, soft-cap and head
// widths as flash_attention_f32's. Three launches on `stream`: dsum, dq,
// then dk and dv together. Returns a cudaError_t (0 on success).
int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                            const float* o, const float* dout,
                            const float* lse, float* dq, float* dk, float* dv,
                            float* dsum, int B, int S, int T, int H, int K,
                            int HD, int causal, int window, float softcap,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (HD != 16 && HD != 32 && HD != 64 && HD != 128 && HD != 256)
    return (int)cudaErrorInvalidValue;
  const long long nrows = (long long)B * S * H;
  if (nrows > 0) {
    const int per = 8;   // warps (rows) per block
    flash_bwd_dsum<<<(unsigned)((nrows + per - 1) / per), 32 * per, 0, st>>>(
        o, dout, dsum, S, H, HD, nrows);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  switch (HD) {
    case 16: return (int)dispatch_bwd<16>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    case 32: return (int)dispatch_bwd<32>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    case 64: return (int)dispatch_bwd<64>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    case 128: return (int)dispatch_bwd<128>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    default: return (int)dispatch_bwd<256>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
  }
}

}  // extern "C"
