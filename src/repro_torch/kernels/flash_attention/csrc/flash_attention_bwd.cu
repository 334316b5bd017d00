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
// Two launches after D, with no atomics: each output row is written by
// exactly one CTA, so a run is bitwise the next. A CTA owns 64 rows and
// streams tiles of the other side:
//
//   MODE  rows (owned)          columns (streamed)           accumulates
//   DQ    queries of head h     keys of KV head h / G        dQ: dS K
//   DKV   keys of KV head kh    queries of its G heads,      dK: dS^T Q
//                               head by head, in order       dV: P^T dO
//
// Each tile forms s = A1 X1^T over the full head width (DQ: Q K^T; DKV:
// K Q^T, the same dot products transposed) and dP = A2 X2^T (dO V^T or
// V dO^T), P from the saved lse, dS, and accumulates dS X1 (and, for DKV,
// P X2). The two launches do 7 products per live (query, key) pair against
// the 5 of one kernel that also reduced dQ across CTAs (s and dP twice):
// the price of writing each dQ row from one CTA, without atomics (dQ
// accumulated across CTAs in a fixed order, FlashAttention-3's
// deterministic mode, would save the two). Tile ranges skip what the masks
// kill, as the forward does: DQ the key tiles before the window and after
// the diagonal; DKV the query tiles before the diagonal (causal: query i
// sees key j iff j <= i + T - S) and after the window. Every element is
// then masked on its own. Rows past S or T are zero-filled and never
// stored; a padded query column has lse = +inf, so its P is 0. A query row
// with no live key has lse = +inf (the forward's row_lse), so its P, dS and
// its gradients are 0, not NaN.
//
// Head widths 64, 128 and 256: flash_bwd_hopper. Its bound on the H100 is
// the tensor cores: 5 products of 2 hd flops a live pair, each in the
// three bf16 passes below at 989 TFLOP/s, put granite-8b's serving shape
// (4 x 2,048, 32/8 heads of 128) at 1.04 ms (2.1 ms in 3xTF32), its bytes
// at 0.2 ms. The kernel forms 7 products a live pair, so at most 5/7 of
// that rate. What the design does about it:
//
// - Loads by a producer warp (warp 8): one thread issues every tile as a
//   TMA box of f32 (4-D tensor maps over (hd, heads, rows, B), built on the
//   host; rows past S or T read as zeros), the row side once, the streamed
//   side through a ring of NS = 2 stages at every width, each stage with a
//   full mbarrier (expect_tx of its bytes, plus the warp's arrival once its
//   lanes have written the stage's lse * log2(e) and D, DKV, or the rows',
//   DQ) and an empty one that the consumers' eight warps arrive at. The
//   consumers never load from global memory.
// - Every product on wgmma (m64nNk16, bf16 in, f32 accumulators), with f32
//   accuracy from splitting each f32 operand into two bf16 pieces, x1 =
//   bf16(x), x2 = bf16(x - x1) (within 2^-16 of x), and three passes a
//   product (x2 y1 + x1 y2 + x1 y1, each bf16 x bf16 product exact). The
//   CPU emulation tests/test_torch_flash_bwd_split.py keeps every gradient
//   of phase 16's widths and masks within 2e-5 of its scale this way, one
//   piece above 2e-3. bf16 wgmma runs at twice TF32's rate, so three bf16
//   passes cost what 1.5 TF32 ones would, and it reads an MN-major B
//   through its transpose bit: the tile that is K-major for the score
//   products (X1, X2: rows of hd, the reduced index innermost) is read
//   MN-major for the accumulating ones (dS X1, P X2), with no transposed
//   copy.
// - Each tile is split once: the consumers' 256 threads turn a landed f32
//   tile into its two pieces in place (a tile of R x hd f32 is the size of
//   two R x hd bf16 pieces), each piece in 64-column boxes with wgmma's
//   128-byte swizzle; a named barrier (1) joins them before and after.
//   Every warp then reads the pieces; no warp converts what another has.
// - Two consumer warpgroups share each tile's 64 rows, and S and dP are
//   formed once: warpgroup 0 forms s = A1 X1^T and P, hands P (times
//   1 - tanh^2 under a cap) to warpgroup 1 through shared memory (named
//   barrier 2: arrive, sync), then for DKV accumulates dV += P X2 (P's
//   pieces from registers: wgmma's accumulator of two neighbouring 8-column
//   blocks is, element for element, the register A fragment of one 16-deep
//   k-step); warpgroup 1 forms dP = A2 X2^T, dS from the handed P, and
//   accumulates dK += dS X1 (DKV) or dQ += dS K (DQ). One accumulator of
//   64 x hd a warpgroup: 128 registers a thread at hd 256, where one
//   warpgroup holding dK and dV would need 256.
// - The next tile is split while this tile's accumulating products run
//   (its stage is the other one, so nothing the products read). The order
//   of every sum is fixed: run to run bitwise, and the tile sizes do not
//   change the bits.
// - Streamed tiles of BC = 64 rows at hd 128 (210 KB of shared memory: the
//   row side's pieces 64 KB, two 64 KB stages, P's 16 KB; one CTA an SM),
//   16 at hd 256 (198 KB: the row side's pieces alone take 128 KB), 32 at
//   hd 64 (74 KB, two CTAs an SM under a cap of 113 registers, faster than
//   one CTA of 64-row tiles). Nine warps a CTA: ptxas keeps 168 registers
//   a thread (three of the nine warps share an SM sub-partition), with a
//   few bytes spilled at hd 128 and 256.
// - What bounds it now is shared memory's 128 bytes a clock an SM more
//   than the tensor cores: a 64 x 64 x 16 score pass reads 4 KB of A and B
//   for 32 clocks of bf16 wgmma, and each tile's split reads and writes the
//   tile once more (PERF.md).
//
// Head widths 16 and 32 (reduced configurations only) keep the first
// backward kernel, flash_bwd_kernel (mma.sync m16n8k8 in TF32 split into
// three, split_tf32.cuh, as the forward): four warps of 16 rows, the
// streamed tiles through a two-stage cp.async ring; P and dS are already in
// the A-fragment layout of the accumulator (within each 8-wide k-step the k
// index runs over (2t, 2t + 1) pairs, so no data moves between threads). A
// 64-column box and the 128-byte swizzle do not fit those widths. Times:
// PERF.md, chip_smoke.py phase 16 and tools/flash_bwd_variants.py.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

#include "split_tf32.cuh"

constexpr int BR = 64;   // output rows per CTA
constexpr int NW = 4;    // warps per CTA, 16 rows each
constexpr int NT = 32 * NW;
constexpr float LOG2E = 1.44269504f;

enum Mode { DQ = 0, DKV = 1 };

// flash_bwd_kernel's tiles (hd 16 and 32)
template <int HD>
struct Cfg {
  static_assert(HD <= 32, "hd 64, 128 and 256 take flash_bwd_hopper");
  static constexpr int BC = 64;                     // columns per streamed tile
  static constexpr int NST = 2;                     // stages of the ring
  static constexpr int DC = HD;                     // output columns per CTA
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

// ------------------------------------------- hd 64, 128, 256: Hopper
namespace hb {
constexpr int BR = 64;          // rows a CTA: wgmma's M
constexpr int NC = 256;         // consumer threads: two warpgroups
constexpr int NT = NC + 32;     // and the producer warp
constexpr int NS = 2;           // stages of the streamed ring
template <int HD>
struct Cfg {
  // streamed rows a tile, CTAs an SM: at hd 64 two CTAs of 74 KB (at
  // most 113 registers a thread) beat one of 64-row tiles
  static constexpr int BC = HD == 64 ? 32 : (HD == 128 ? 64 : 16);
  static constexpr int MINB = HD == 64 ? 2 : 1;
  // one tensor's tile in f32, which the consumers rewrite in place as its
  // two bf16 pieces (each [HD / 64 boxes][rows][128 bytes], swizzled)
  static constexpr uint32_t row_bytes = BR * HD * 4;    // A1 (or A2)
  static constexpr uint32_t tile_bytes = BC * HD * 4;   // X1 (or X2)
  static constexpr uint32_t ring_off = 2 * row_bytes;   // A1, A2, the ring
  static constexpr uint32_t stage_bytes = 2 * tile_bytes;          // X1, X2
  static constexpr uint32_t pex_off = ring_off + NS * stage_bytes; // P, f32
  // [NS][2][BR] f32: a stage's lse * log2(e) and D (DKV); the rows' (DQ)
  static constexpr uint32_t lsd_off = pex_off + BR * BC * 4;
  static constexpr uint32_t bar_off = lsd_off + NS * 2 * BR * 4;
  static constexpr int nbar = 1 + 2 * NS;   // rows full; full, empty a stage
  // + 1,024: the base is rounded up to the swizzle's 1,024-byte atom
  static constexpr size_t bytes = bar_off + 8 * nbar + 1024;
  static_assert(bytes <= 232448, "over the 227 KB a CTA may use");
  static_assert(BC % 16 == 0 && BC <= BR && (BC * HD / 8) % NC == 0,
                "a tile must fit its lse and D slots and split its 8-float "
                "chunks over the consumers");
};
}  // namespace hb

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// wait until the phase of parity `parity` has completed; trap after ~10 s
// of clock, so a fault ends the launch with an error and does not hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (!mbar_try(bar, parity)) {
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// shared-memory writes of this thread made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the two consumer warpgroups (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// warpgroup 0 has written P for warpgroup 1 (named barrier 2)
__device__ __forceinline__ void p_post() {
  asm volatile("bar.arrive 2, 256;\n" ::: "memory");
}
__device__ __forceinline__ void p_wait() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

// two f32 rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) as two bf16 pairs, p1 + p2 within 2^-16 of it: p1 rounds the
// values, p2 what p1 leaves
__device__ __forceinline__ void pieces(float lo, float hi, uint32_t& p1,
                                       uint32_t& p2) {
  p1 = pack_bf16(lo, hi);
  p2 = pack_bf16(lo - __uint_as_float(p1 << 16),
                 hi - __uint_as_float(p1 & 0xFFFF0000u));
}

// An R x HD f32 tile at `tile` (row-major, as a TMA box lands it) rewritten
// in place as its two bf16 pieces, piece p at tile + p R HD 2 bytes, each in
// boxes of 64 columns (R x 128 bytes), 16-byte block j of row r at
// (j ^ (r & 7)) 16 (the 128-byte swizzle of a TMA box, wgmma's operand
// layout). Each consumer thread takes 8-float chunks ct, ct + 256, ...: read
// them all (read), then, after every thread has read (consumers_sync),
// write their pieces (write).
template <int R, int HD>
struct Split {
  static constexpr int CPR = HD / 8;                // chunks a row
  static constexpr int PER = R * CPR / hb::NC;      // chunks a thread
  float4 v[PER][2];
  __device__ __forceinline__ void read(const uint8_t* tile, int ct) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float4* p =
          reinterpret_cast<const float4*>(tile) + 2 * (ct + hb::NC * i);
      v[i][0] = p[0];
      v[i][1] = p[1];
    }
  }
  __device__ __forceinline__ void write(uint8_t* tile, int ct) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = ct + hb::NC * i, r = q / CPR, j = q % CPR;
      const uint32_t at =
          (j / 8) * R * 128 + r * 128 + (((j % 8) ^ (r & 7)) << 4);
      uint4 a, b;
      pieces(v[i][0].x, v[i][0].y, a.x, b.x);
      pieces(v[i][0].z, v[i][0].w, a.y, b.y);
      pieces(v[i][1].x, v[i][1].y, a.z, b.z);
      pieces(v[i][1].z, v[i][1].w, a.w, b.w);
      *reinterpret_cast<uint4*>(tile + at) = a;
      *reinterpret_cast<uint4*>(tile + R * HD * 2 + at) = b;
    }
  }
};

// D (64 x N, f32) {=, +=} A B, A (64 x 16) and B (16 x N) bf16 in shared
// memory, both K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D (64 x N, f32) += A B, A bf16 in registers (a wgmma accumulator's layout,
// two 8-column blocks a k-step), B bf16 in shared memory, MN-major (the
// transpose-B form)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD, int MODE, bool CAP>
__global__ void __launch_bounds__(hb::NT, hb::Cfg<HD>::MINB)
flash_bwd_hopper(const __grid_constant__ CUtensorMap ta1,
                 const __grid_constant__ CUtensorMap ta2,
                 const __grid_constant__ CUtensorMap tx1,
                 const __grid_constant__ CUtensorMap tx2,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 float* __restrict__ grad, float* __restrict__ grad_v, int S,
                 int T, int H, int K, int causal, int window, float scale,
                 float cap) {
  using CF = hb::Cfg<HD>;
  constexpr int BR = hb::BR, BC = CF::BC, NS = hb::NS;
  constexpr bool QROWS = MODE == DQ;   // rows are queries (else keys)
  constexpr uint32_t ROWP = CF::row_bytes / 2, TILEP = CF::tile_bytes / 2;
  extern __shared__ __align__(1024) uint8_t hb_smem[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(hb_smem) + 1023u) & ~1023u;
  uint8_t* gbase =
      hb_smem + (base - (uint32_t)__cvta_generic_to_shared(hb_smem));
  // A1, A2 (the row side: DQ Q, dO; DKV K, V), the ring's stages (X1, X2:
  // DQ K, V; DKV Q, dO), P, the lse and D, the mbarriers
  auto x_off = [&](int s) { return CF::ring_off + s * CF::stage_bytes; };
  float* pex = reinterpret_cast<float*>(gbase + CF::pex_off);
  float* lsd = reinterpret_cast<float*>(gbase + CF::lsd_off);
  const uint32_t rows_full = base + CF::bar_off;
  auto full = [&](int s) { return rows_full + 8 * (1 + s); };
  auto empty = [&](int s) { return rows_full + 8 * (1 + NS + s); };

  const int G = H / K;
  const int nrh = QROWS ? H : K;       // heads of the row side
  const int rh = blockIdx.x % nrh, b = blockIdx.x / nrh;
  const int kh = QROWS ? rh / G : rh;
  // causal DQ: the last row blocks see the most keys; DKV: the first
  const int ib = QROWS ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
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

  if (threadIdx.x == 0) {
    mbar_init(rows_full, 2);   // expect_tx with the row tiles, the warp's
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 2);   // expect_tx with the tiles, the warp's
      mbar_init(empty(s), 8);  // the consumers' eight warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 8) {
    // ----------------------------------------------------------- producer
    if (n_it == 0) return;
    if (lane == 0) {
      mbar_expect_tx(rows_full, 2 * CF::row_bytes);
      tma_load4(base, &ta1, 0, rh, r_first, b, rows_full);
      tma_load4(base + CF::row_bytes, &ta2, 0, rh, r_first, b, rows_full);
    }
    if (QROWS) {
      const size_t at = ((size_t)b * H + rh) * S;
      for (int i = lane; i < BR; i += 32) {
        const int row = r_first + i;
        lsd[i] = row < S ? lse[at + row] * LOG2E : INFINITY;
        lsd[BR + i] = row < S ? dsum[at + row] : 0.f;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(rows_full);
    // tile it into stage it % NS once the consumers have freed it (round
    // 0: at once): X1 and X2 by TMA, DKV's lse and D by the lanes
    for (int it = 0; it < n_it; ++it) {
      const int s = it % NS;
      const int gi = QROWS ? 0 : it / span;
      const int c0 = (lo + (QROWS ? it : it % span)) * BC;
      const int hx = QROWS ? kh : kh * G + gi;   // head of the columns
      mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), CF::stage_bytes);
        tma_load4(base + x_off(s), &tx1, 0, hx, c0, b, full(s));
        tma_load4(base + x_off(s) + CF::tile_bytes, &tx2, 0, hx, c0, b,
                  full(s));
      }
      if (!QROWS) {
        float* ls = lsd + s * 2 * BR;
        const size_t at = ((size_t)b * H + hx) * S;
        for (int i = lane; i < BC; i += 32) {
          const int qi = c0 + i;
          ls[i] = qi < S ? lse[at + qi] * LOG2E : INFINITY;
          ls[BR + i] = qi < S ? dsum[at + qi] : 0.f;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full(s));
    }
    // the last stages' loads have landed (a load that never completes
    // traps here)
    for (int it = max(n_it - NS, 0); it < n_it; ++it)
      mbar_wait(full(it % NS), (it / NS) & 1);
    return;
  }

  // -------------------------------------------------------------- consumers
  const int ct = threadIdx.x;            // 0 .. 255
  const int wg = ct >> 7;                // 0: S, P (and dV); 1: dP, dS, dK or dQ
  const int g = lane >> 2, t4 = lane & 3;
  const int rl0 = 16 * (warp & 3) + g;   // this thread's rows rl0, rl0 + 8
  const float scale2 = scale * LOG2E;
  // warpgroup 0: DKV dV; warpgroup 1: dK or dQ (DQ: warpgroup 0 has none)
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  if (n_it > 0) {
    mbar_wait(rows_full, 0);
    {
      Split<BR, HD> a;
      a.read(gbase, ct);
      consumers_sync();
      a.write(gbase, ct);
      a.read(gbase + CF::row_bytes, ct);
      consumers_sync();
      a.write(gbase + CF::row_bytes, ct);
      fence_async_shared();
    }
    // DQ: the rows' lse (base 2) and D
    float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
    if (QROWS) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lr[r] = lsd[rl0 + 8 * r];
        dr[r] = lsd[BR + rl0 + 8 * r];
      }
    }
    // the score product's A: A1 (Q or K) for warpgroup 0, A2 (dO or V) for 1
    const uint64_t da = sw128_desc(base + wg * CF::row_bytes, 16, 1024);
    // tile it's f32 stage, once landed, split in place into its pieces,
    // with a barrier after the reads of X1, of X2 and after the writes
    // (the first call's last also covers A1's and A2's pieces)
    auto split_tile = [&](int it) {
      const int s = it % NS;
      uint8_t* xg = gbase + x_off(s);
      mbar_wait(full(s), (it / NS) & 1);
      Split<BC, HD> x;
      x.read(xg, ct);
      consumers_sync();
      x.write(xg, ct);
      x.read(xg + CF::tile_bytes, ct);
      consumers_sync();
      x.write(xg + CF::tile_bytes, ct);
      fence_async_shared();
      consumers_sync();
    };
    split_tile(0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % NS;
      const int cf = (lo + (QROWS ? it : it % span)) * BC;   // first column
      const uint32_t x1 = base + x_off(s), x2 = x1 + CF::tile_bytes;
      const float* ls = lsd + s * 2 * BR;

      // warpgroup 0: s = A1 X1^T; warpgroup 1: dP = A2 X2^T, over hd in
      // 16-deep k-steps, three passes a step: small big, big small, big big
      float sacc[BC / 2];
      {
        const uint64_t dx = sw128_desc(wg == 0 ? x1 : x2, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t ao = ((kk / 4) * BR * 128 + (kk % 4) * 32) >> 4;
          const uint32_t xo = ((kk / 4) * BC * 128 + (kk % 4) * 32) >> 4;
          wgmma_ss<BC>(sacc, da + ao + (ROWP >> 4), dx + xo, kk > 0);
          wgmma_ss<BC>(sacc, da + ao, dx + xo + (TILEP >> 4), 1);
          wgmma_ss<BC>(sacc, da + ao, dx + xo, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(sacc);
      }

      // the accumulating product's A, P or dS in pieces (a wgmma
      // accumulator's two neighbouring 8-column blocks are one k-step's
      // register A fragment), and its B: X2 (dO) for dV, X1 for dK or dQ
      uint32_t pa[2][BC / 16][4];
      auto issue_acc = [&](uint32_t xb) {
#pragma unroll
        for (int j = 0; j < BC / 16; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            pieces(sacc[8 * j + 2 * c], sacc[8 * j + 2 * c + 1], pa[0][j][c],
                   pa[1][j][c]);
        const uint64_t db = sw128_desc(xb, BC * 128, 1024);   // MN-major
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BC / 16; ++j) {
          const uint32_t xo = (j * 16 * 128) >> 4;
          wgmma_rs<HD>(acc, pa[1][j], db + xo);
          wgmma_rs<HD>(acc, pa[0][j], db + xo + (TILEP >> 4));
          wgmma_rs<HD>(acc, pa[0][j], db + xo);
        }
        wgmma_commit();
      };
      if (wg == 0) {
        // P in place of s; element 4n + 2r + c is row rl0 + 8r, column
        // 8n + 2 t4 + c. P (times 1 - tanh^2 under a cap) to warpgroup 1.
#pragma unroll
        for (int n = 0; n < BC / 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * n + 2 * r + c;
              const int cl = 8 * n + 2 * t4 + c;   // column within the tile
              const int row = r_first + rl0 + 8 * r, col = cf + cl;
              const int qi = QROWS ? row : col;    // query row
              const int kpos = QROWS ? col : row;  // key position
              const int qpos = qi + off;
              const bool ok = qi < S && kpos < T &&
                              (!causal || kpos <= qpos) &&
                              (window <= 0 || kpos > qpos - window);
              const float x = sacc[e];
              float sc, th = 0.f;
              if constexpr (CAP) {
                th = tanhf(x * scale / cap);
                sc = cap * th * LOG2E;
              } else {
                sc = x * scale2;
              }
              const float l2 = QROWS ? lr[r] : ls[cl];
              const float p = ok ? exp2f(sc - l2) : 0.f;
              sacc[e] = p;
              pex[e * 128 + ct] = CAP ? p * (1.f - th * th) : p;
            }
        p_post();
        if constexpr (!QROWS) issue_acc(x2);   // dV += P dO
      } else {
        // dS = P (dP - D) in place of dP
        p_wait();
#pragma unroll
        for (int n = 0; n < BC / 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * n + 2 * r + c;
              const float dq = QROWS ? dr[r] : ls[BR + 8 * n + 2 * t4 + c];
              sacc[e] = pex[e * 128 + ct - 128] * (sacc[e] - dq);
            }
        issue_acc(x1);                         // dK += dS Q, dQ += dS K
      }
      // the next tile's pieces while the accumulation runs (its stage is
      // the other one)
      if (it + 1 < n_it) split_tile(it + 1);
      wgmma_wait<0>();
      pin(acc);
      pin(pa[0]);
      pin(pa[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // this stage is read
    }
  }

  // DKV: warpgroup 0 writes dV, 1 dK; DQ: warpgroup 1 writes dQ. dQ and dK
  // carry the score scale; dV does not.
  if (QROWS && wg == 0) return;
  float* out = wg == 1 ? grad : grad_v;
  const float f = wg == 1 ? scale : 1.f;
  const size_t o_stride = (size_t)nrh * HD;
  const size_t o0 = (size_t)b * nrows * o_stride + (size_t)rh * HD + 2 * t4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_first + rl0 + 8 * r;
    if (row < nrows) {
      float* o = out + o0 + (size_t)row * o_stride;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(acc[4 * n + 2 * r] * f, acc[4 * n + 2 * r + 1] * f);
    }
  }
}

// x (B, R, NH, HD) f32, contiguous: dims (HD, NH, R, B) innermost first,
// boxes of HD columns x `rows` rows of one head, unswizzled (the consumers
// write the swizzled pieces); what lies past R reads as zeros
bool tensor_map_f32(CUtensorMap* map, const float* x, int HD, int NH, int R,
                    int B, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)NH,
                              (cuuint64_t)R, (cuuint64_t)B};
  const cuuint64_t strides[3] = {4ull * HD, 4ull * HD * NH,
                                 4ull * HD * NH * R};
  const cuuint32_t box[4] = {(cuuint32_t)HD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int MODE, bool CAP>
cudaError_t launch_hopper(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse,
                          const float* dsum, float* grad, float* grad_v,
                          int B, int S, int T, int H, int K, int causal,
                          int window, float cap, cudaStream_t st) {
  using CF = hb::Cfg<HD>;
  CUtensorMap ta1, ta2, tx1, tx2;
  const bool ok =
      MODE == DQ
          ? tensor_map_f32(&ta1, q, HD, H, S, B, hb::BR) &&
                tensor_map_f32(&ta2, dout, HD, H, S, B, hb::BR) &&
                tensor_map_f32(&tx1, k, HD, K, T, B, CF::BC) &&
                tensor_map_f32(&tx2, v, HD, K, T, B, CF::BC)
          : tensor_map_f32(&ta1, k, HD, K, T, B, hb::BR) &&
                tensor_map_f32(&ta2, v, HD, K, T, B, hb::BR) &&
                tensor_map_f32(&tx1, q, HD, H, S, B, CF::BC) &&
                tensor_map_f32(&tx2, dout, HD, H, S, B, CF::BC);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_hopper<HD, MODE, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CF::bytes);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)HD);
  const int heads = MODE == DQ ? H : K;
  const int rows = MODE == DQ ? S : T;
  flash_bwd_hopper<HD, MODE, CAP>
      <<<dim3(heads * B, (rows + hb::BR - 1) / hb::BR), hb::NT, CF::bytes,
         st>>>(ta1, ta2, tx1, tx2, lse, dsum, grad, grad_v, S, T, H, K,
               causal, window, scale, cap);
  return cudaGetLastError();
}

template <int HD, bool CAP>
cudaError_t run_hopper(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* dsum,
                       float* dq, float* dk, float* dv, int B, int S, int T,
                       int H, int K, int causal, int window, float cap,
                       cudaStream_t st) {
  cudaError_t e = launch_hopper<HD, DQ, CAP>(q, k, v, dout, lse, dsum, dq,
                                             nullptr, B, S, T, H, K, causal,
                                             window, cap, st);
  if (e != cudaSuccess) return e;
  return launch_hopper<HD, DKV, CAP>(q, k, v, dout, lse, dsum, dk, dv, B, S,
                                     T, H, K, causal, window, cap, st);
}

template <int HD>
cudaError_t dispatch_hopper(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* dsum, float* dq, float* dk,
                            float* dv, int B, int S, int T, int H, int K,
                            int causal, int window, float cap,
                            cudaStream_t st) {
  if (cap > 0.f)
    return run_hopper<HD, true>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T,
                                H, K, causal, window, cap, st);
  return run_hopper<HD, false>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T,
                               H, K, causal, window, cap, st);
}

}  // namespace

extern "C" {

// Which kernel serves head width HD: 1 flash_bwd_hopper (64, 128, 256), 0
// flash_bwd_kernel (16, 32), -1 none. flash_attention_bwd_f32 dispatches on
// it.
int flash_attention_bwd_route(int HD) {
  if (HD == 64 || HD == 128 || HD == 256) return 1;
  return HD == 16 || HD == 32 ? 0 : -1;
}

// The gradients of flash_attention_f32's output o with respect to q, k and
// v, given the output's gradient dout (B,S,H,HD) and the forward's lse
// (B,H,S). q, o, dout, dq (B,S,H,HD); k, v, dk, dv (B,T,K,HD); dsum (B,H,S)
// is a workspace the call fills with rowsum(dout o o). All float32,
// contiguous, 16-byte aligned, on the device; the masks, soft-cap and head
// widths as flash_attention_f32's. Three launches on `stream`: dsum, dq,
// then dk and dv together (hd 64, 128, 256: flash_bwd_hopper; hd 16, 32:
// flash_bwd_kernel). Returns a cudaError_t (0 on success).
int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                            const float* o, const float* dout,
                            const float* lse, float* dq, float* dk, float* dv,
                            float* dsum, int B, int S, int T, int H, int K,
                            int HD, int causal, int window, float softcap,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int route = flash_attention_bwd_route(HD);
  if (route < 0) return (int)cudaErrorInvalidValue;
  const long long nrows = (long long)B * S * H;
  if (nrows > 0) {
    const int per = 8;   // warps (rows) per block
    flash_bwd_dsum<<<(unsigned)((nrows + per - 1) / per), 32 * per, 0, st>>>(
        o, dout, dsum, S, H, HD, nrows);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (route == 0) {
    if (HD == 16) return (int)dispatch_bwd<16>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    return (int)dispatch_bwd<32>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
  }
  if (HD == 64) return (int)dispatch_hopper<64>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
  if (HD == 128) return (int)dispatch_hopper<128>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
  return (int)dispatch_hopper<256>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
}

// Dynamic shared memory (bytes) of the dQ and dK/dV kernels that serve head
// width HD (the same for both), 0 for a width the library is not built for.
int flash_attention_bwd_smem_bytes(int HD) {
  switch (HD) {
    case 16: return (int)Cfg<16>::bytes;
    case 32: return (int)Cfg<32>::bytes;
    case 64: return (int)hb::Cfg<64>::bytes;
    case 128: return (int)hb::Cfg<128>::bytes;
    case 256: return (int)hb::Cfg<256>::bytes;
    default: return 0;
  }
}

}  // extern "C"
