// The backwards of flash attention's f32 and bf16 entries for NVIDIA
// Hopper (sm_90a): given q (B,S,H,hd), k/v (B,T,K,hd), the forward's output o, its row
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
// The f32 entry (and the bf16 one at hd 16 and 32; the bf16 entry's
// Hopper kernel is described below): two launches after D, with no
// atomics: each output row is written by exactly one CTA, so a run is
// bitwise the next. A CTA owns 64 rows and streams tiles of the other
// side:
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
//
// The bf16 entry (flash_attention_bwd_bf16: bf16 q, k, v, o, dO and
// gradients, the f32 LSE of flash_attention_bf16). bf16 x bf16 products are
// exact in f32, so each product is one bf16 pass where the f32 entry takes
// three. Its rounding points: P is recomputed in f32 from the LSE and
// rounded to bf16 for dV += P^T dO, as the forward rounds it before P V;
// dS is rounded to bf16 for dK and dQ (the products' operands; the plain
// version keeps dS in f32); s, P, dP, dS and every sum stay f32; D sums dO
// o O over the bf16 O the forward returned; the gradients are rounded to
// bf16 once. The plain version's autograd also rounds the gradient that
// reaches P through its bf16 cast; the kernel keeps dP in f32, since
// rounding it there rounds another value than the plain version does and
// adds an error of the same size: emulated on the CPU
// (tools/flash_bwd_bf16_rounding.py, 20 seeds of each attention case of
// tests/test_torch_train_bf16.py), that took dq's RMS distance from the
// plain bf16 backward to 1.87 of the tolerance's 2 (the plain version's own
// bf16-vs-f32 distance doubled), against 1.51 without (dv 1.57 either
// way). Its bound on the H100: the same 5 products a live pair in one bf16
// pass at 989 TFLOP/s, or its bf16 bytes at 3.35 TB/s (chip_smoke.py phase
// 16 prints both). At hd 16 and 32 it keeps D, then dQ and dK/dV as two
// launches of flash_bwd_kernel_bf16 (mma.sync m16n8k16, 7 products a pair).
// At hd 64, 128 and 256 it is D, then one launch of flash_bwd_bf16_hopper,
// which forms the 5 products of every live pair once:
//
// - A CTA owns BN keys of one KV head, keeps K and V in shared memory and
//   streams the query tiles its keys reach (BM rows: causal from the
//   diagonal on, a window up to its end) of its G query heads, tile by
//   tile, each tile's G heads in turn, through a TMA ring (NS stages of Q
//   and dO; a producer warp also writes each stage's lse * log2(e) and D).
//   It forms S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in registers, and
//   accumulates dV += P^T dO and dK += dS^T Q in registers over all G
//   heads: no atomics for GQA, dK and dV written once.
// - hd 64 and 128: BN = 128, two consumer warpgroups of 64 keys each, so
//   no P crosses between them; P and dS are the register A operand of dV's
//   and dK's wgmma (m64n{hd}k16, the accumulator's two neighbouring
//   8-column blocks are one k-step's A fragment), the scores m64n{BM}k16
//   (BM = 128 at hd 64, 64 at hd 128, where dK and dV take 128 registers a
//   thread). hd 256: dK and dV of 64 keys are 64 x 256 f32 each, 256
//   registers a thread for one warpgroup, so BN = BM = 64 and the
//   warpgroups split dK and dV by columns (128 each) and S^T and dP^T by
//   queries (32 each), handing P^T and dS^T over in shared memory; one
//   stage of Q and dO (64 KB) fits beside the rest.
// - dQ of a query tile is summed over the key blocks that reach it in a
//   fixed order, FlashAttention-3's deterministic mode: each CTA forms its
//   partial dS K (dS^T from shared memory, read M-major; K read MN-major)
//   in f32 and adds it into an f32 workspace chunk a (b, h, query tile)
//   behind a counter a tile, the tile's last key block first (causal: the
//   CTA before a tile in the order reaches it G or 2 G tiles earlier, so a
//   CTA seldom waits). The first adder stores, so the workspace is never
//   zeroed; the last adds the sum so far to its partial in registers,
//   scales, rounds and writes dQ in bf16, so no conversion launch follows.
//   A writer thread in the producer warpgroup moves the partials (bulk
//   copies from shared memory: a store or an f32 add in L2, then the
//   counter moved on with a release once the add landed) and fetches a
//   tile's sum for its last adder as soon as it is complete; the
//   consumers only hand a partial over through shared memory. A run is
//   bitwise the next.
// - Deadlock-free whatever order the card starts CTAs in: each CTA takes
//   its work item from a ticket (an atomic counter), and the items are
//   listed last key block first, so every item whose adds come before one's
//   is already taken by a running CTA. Waits on a counter trap after ~10 s,
//   as the barrier waits do.
// - D's launch zeroes the counters and the ticket, and dQ's rows in query
//   tiles that no key block reaches (S > T), so a call is two launches.
// - The producer warpgroup gives its registers up (setmaxnreg.dec to 24),
//   the consumers take them (setmaxnreg.inc to 240). P is formed while
//   dP's product runs; dV's and dK's products are issued before the
//   warpgroups meet (once a tile, before dQ: dS is double-buffered); the
//   mask's test runs only on the blocks that are not all live.
// - Ticket order: a call whose f32 workspace fits in 24 MB takes its (b,
//   kv head) groups all at once, key block by key block (the best balance
//   over 132 SMs); a larger one takes them one group at a time, so only the
//   sums of the groups in flight are live and stay in the 50 MB L2 (taken
//   all at once, granite-8b's serve shape sends every add to HBM).
//
// Times, shared memory, registers and the design's own bytes (the
// workspace's traffic, kernel.bf16_bwd_design): PERF.md row 3d,
// chip_smoke.py phase 16 and tools/flash_bwd_variants.py's bf16 mode.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

extern "C" int flash_attention_bwd_route(int HD);

namespace {

#include "bf16_mma.cuh"
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

// The live column tiles [lo, hi) of a CTA whose BR rows start at r_first
// (for DKV: of each of the G heads), tiles of bc columns, nct of them: DQ
// skips the key tiles before the window and after the diagonal, DKV the
// query tiles before the diagonal (causal: query i sees key j iff j <= i +
// off) and after the window
__device__ __forceinline__ void live_tiles(bool qrows, int causal, int window,
                                           int r_first, int off, int bc,
                                           int nct, int& lo, int& hi) {
  lo = 0;
  hi = nct;
  if (qrows) {
    if (causal) {
      const int last = r_first + off + BR - 1;
      hi = last < 0 ? 0 : min(nct, last / bc + 1);
    }
    if (window > 0) {
      const int first = r_first + off - window + 1;
      lo = first > 0 ? first / bc : 0;
    }
  } else {
    if (causal) {
      const int first = r_first - off;
      lo = first > 0 ? first / bc : 0;
    }
    if (window > 0) {
      const int last = r_first + BR - 1 - off + window - 1;
      hi = last < 0 ? 0 : min(nct, last / bc + 1);
    }
  }
}

// The bf16 route's live (query tile, key block) pairs, one test read both
// ways: the key blocks [klo, khi) (BN keys each, nkb of them) that query
// tile m (rows m BM .. m BM + BM - 1, query row 0 at key position off)
// reaches, and the query tiles [mlo, mhi) (nqt of them) that key block n
// reaches (causal: query i sees key j iff j <= i + off; a window: iff
// j > i + off - window). A tile with klo >= khi has no live key.
__host__ __device__ __forceinline__ void tile_kblocks(int m, int BM, int BN,
                                                      int nkb, int off,
                                                      int causal, int window,
                                                      int& klo, int& khi) {
  klo = 0;
  khi = nkb;
  if (causal) {
    const int last = m * BM + BM - 1 + off;
    khi = last < 0 ? 0 : (last / BN + 1 < nkb ? last / BN + 1 : nkb);
  }
  if (window > 0) {
    const int first = m * BM + off - window + 1;
    klo = first > 0 ? (first / BN < nkb ? first / BN : nkb) : 0;
  }
}
__host__ __device__ __forceinline__ void kblock_tiles(int n, int BM, int BN,
                                                      int nqt, int off,
                                                      int causal, int window,
                                                      int& mlo, int& mhi) {
  mlo = 0;
  mhi = nqt;
  if (causal) {
    const int first = n * BN - off;
    mlo = first > 0 ? (first / BM < nqt ? first / BM : nqt) : 0;
  }
  if (window > 0) {
    const int last = n * BN + BN - 1 - off + window - 1;
    mhi = last < 0 ? 0 : (last / BM + 1 < nqt ? last / BM + 1 : nqt);
  }
}

// D = rowsum(dO o O), written to dsum (B, H, S), each row's sum in a fixed
// order. f32 (flash_bwd_dsum): one warp a (b, s, h) row in memory order,
// lanes over hd. bf16 (flash_bwd_dsum_bf16, over the bf16 O the forward
// returned: the plain version's D sums the unrounded one): 8 elements a
// lane (one 16-byte load of each tensor), HD / 8 lanes a row, their sums
// in a fixed tree.
//
// For the bf16 entry's Hopper route the same launch readies the main one:
// it zeroes the dQ order's counters and ticket (ts.cnt, ts.ncnt of them)
// and the dQ rows of every query tile that no key block reaches (ts.dq; no
// CTA adds to those). Otherwise ts.cnt and ts.dq are null.
struct TileSetup {
  int* cnt;
  long long ncnt;
  uint16_t* dq;
  int BM, BN, nkb, off, causal, window;
};

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

__global__ void flash_bwd_dsum_bf16(const uint16_t* __restrict__ o,
                                    const uint16_t* __restrict__ dout,
                                    float* __restrict__ dsum, int S, int H,
                                    int HD, long long nrows, TileSetup ts) {
  const int L = HD / 8;   // lanes a row: 2 .. 32, a power of two
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / L;
  const int j = (int)(t % L);   // this lane's 8 elements: 8 j .. 8 j + 7
  if (ts.cnt)
    for (long long i = t; i < ts.ncnt; i += (long long)gridDim.x * blockDim.x)
      ts.cnt[i] = 0;
  const bool in = row < nrows;  // every lane takes part in the shuffles
  float acc = 0.f;
  if (in) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + row * HD + 8 * j);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + row * HD + 8 * j);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc = fmaf(__uint_as_float(xs[c] << 16), __uint_as_float(ys[c] << 16),
                 acc);
      acc = fmaf(__uint_as_float(xs[c] & 0xFFFF0000u),
                 __uint_as_float(ys[c] & 0xFFFF0000u), acc);
    }
    if (ts.dq) {
      int klo, khi;
      tile_kblocks((int)((row / H) % S) / ts.BM, ts.BM, ts.BN, ts.nkb,
                   ts.off, ts.causal, ts.window, klo, khi);
      if (khi <= klo)
        *reinterpret_cast<uint4*>(ts.dq + row * HD + 8 * j) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  for (int w = L / 2; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (in && j == 0) {
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

  int lo, hi;
  live_tiles(QROWS, causal, window, r_first, off, BC, nct, lo, hi);
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

// flash_bwd_kernel_bf16's tiles (hd 16 and 32), bf16 rows of HD + 8 (the
// forward's flash_kernel_bf16 stride: ldmatrix's eight 16-byte rows fall
// on distinct banks)
template <int HD>
struct CfgB {
  static_assert(HD <= 32, "hd 64, 128 and 256 take flash_bwd_hopper");
  static constexpr int BC = 64;                     // columns per streamed tile
  static constexpr int RS = HD + 8;                 // row stride (bf16)
  // rows: A [BR][RS] (Q or K), then E [BR][RS] (dO or V), bf16
  static constexpr size_t rows_bytes = 2 * BR * RS * 2;
  // a stage: X1 [BC][RS], X2 [BC][RS] bf16, then (DKV) lse*log2(e) and D of
  // its BC query columns, f32
  static constexpr size_t stage_bytes = 2 * BC * RS * 2 + 2 * BC * 4;
  static constexpr size_t bytes = rows_bytes + 2 * stage_bytes;
};

// The bf16 entry's backward at hd 16 and 32: flash_bwd_kernel's tiles, ring
// and masks with bf16 operands, so each product is one mma.sync m16n8k16
// in bf16 (products exact, sums in f32) where the f32 kernel splits into
// three TF32 passes. The score products read Q, K, V and dO as they are
// stored; P is rounded to bf16 for dV += P^T dO (the forward's rounding
// point) and dS for dK += dS^T Q and dQ += dS K; s, P, dP and dS are f32.
template <int HD, int MODE, bool CAP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_kernel_bf16(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      const uint16_t* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      uint16_t* __restrict__ grad, uint16_t* __restrict__ grad_v,
                      int S, int T, int H, int K, int causal, int window,
                      float scale, float cap) {
  using CF = CfgB<HD>;
  constexpr int BC = CF::BC, RS = CF::RS;
  constexpr bool QROWS = MODE == DQ;   // rows are queries (else keys)
  constexpr int KK = HD / 16;          // k-steps of the score products
  constexpr int NK = BC / 8;           // 8-column blocks of a tile
  constexpr int ND = HD / 8;           // 8-wide blocks of the output columns
  constexpr int CH = HD / 8;           // 16-byte chunks of a row
  extern __shared__ __align__(16) uint8_t smb[];

  const int G = H / K;
  const int nrh = QROWS ? H : K;       // heads of the row side
  const int rh = blockIdx.x % nrh, b = blockIdx.x / nrh;
  // causal DQ: the last row blocks see the most keys; DKV: the first
  const int ib = QROWS ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale2 = scale * LOG2E;
  const int off = T - S;               // key position of query row 0
  const int r_first = ib * BR;
  const int nrows = QROWS ? S : T, ncols = QROWS ? T : S;
  const int nct = (ncols + BC - 1) / BC;
  int lo, hi;
  live_tiles(QROWS, causal, window, r_first, off, BC, nct, lo, hi);
  const int span = hi > lo ? hi - lo : 0;
  const int n_it = QROWS ? span : G * span;

  // row-side and column-side tensors: DQ rows Q, dO / columns K, V;
  // DKV rows K, V / columns Q, dO of head kh * G + gi
  const int kh = QROWS ? rh / G : rh;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)K * HD;
  const uint16_t* ra = QROWS ? q + (size_t)b * S * q_row + (size_t)rh * HD
                             : k + (size_t)b * T * kv_row + (size_t)kh * HD;
  const uint16_t* re = QROWS ? dout + (size_t)b * S * q_row + (size_t)rh * HD
                             : v + (size_t)b * T * kv_row + (size_t)kh * HD;
  const size_t r_stride = QROWS ? q_row : kv_row;

  uint16_t* As = reinterpret_cast<uint16_t*>(smb);
  uint16_t* Es = As + BR * RS;
  auto stage_at = [&](int st) {
    return reinterpret_cast<uint16_t*>(smb + CF::rows_bytes +
                                       st * CF::stage_bytes);
  };

  auto load_tile = [&](int it, int st) {
    const int gi = QROWS ? 0 : it / span;
    const int ct = lo + (QROWS ? it : it % span);
    uint16_t* X1 = stage_at(st);
    uint16_t* X2 = X1 + BC * RS;
    const uint16_t* x1;
    const uint16_t* x2;
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
      float* Ls = reinterpret_cast<float*>(X2 + BC * RS);
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
      const int r = i / CH, c = (i % CH) * 8, t = ct * BC + r;
      const bool in = t < ncols;
      const size_t o2 = (size_t)(in ? t : 0) * c_stride + c;
      cp_async16b(X1 + r * RS + c, x1 + o2, in);
      cp_async16b(X2 + r * RS + c, x2 + o2, in);
    }
    cp_async_commit();
  };
  if (n_it > 0) load_tile(0, 0);

  // the row tiles, zero past the last row
  for (int i = tid; i < BR * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, row = r_first + r;
    uint4 xa = make_uint4(0u, 0u, 0u, 0u), xe = xa;
    if (row < nrows) {
      xa = *reinterpret_cast<const uint4*>(ra + (size_t)row * r_stride + c);
      xe = *reinterpret_cast<const uint4*>(re + (size_t)row * r_stride + c);
    }
    *reinterpret_cast<uint4*>(As + r * RS + c) = xa;
    *reinterpret_cast<uint4*>(Es + r * RS + c) = xe;
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
  // the A fragments of the row tiles at each k-step: rows (g, g + 8) x
  // columns 16 kk + (2t, 2t + 1), then the same 8 columns on
  uint32_t af[KK][4], ef[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint16_t* pa = As + (warp * 16 + g) * RS + kk * 16 + 2 * t4;
    const uint16_t* pe = Es + (warp * 16 + g) * RS + kk * 16 + 2 * t4;
    af[kk][0] = ld32(pa);
    af[kk][1] = ld32(pa + 8 * RS);
    af[kk][2] = ld32(pa + 8);
    af[kk][3] = ld32(pa + 8 * RS + 8);
    ef[kk][0] = ld32(pe);
    ef[kk][1] = ld32(pe + 8 * RS);
    ef[kk][2] = ld32(pe + 8);
    ef[kk][3] = ld32(pe + 8 * RS + 8);
  }
  // this lane's row address for ldmatrix's B fragments of a 16-row step:
  // row (l & 7) + 8 ((l >> 3) & 1), columns 8 (l >> 4) of a 16-column pair
  const int x_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;

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
    const int st = it & 1;
    if (it + 1 < n_it) {
      load_tile(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* X1 = stage_at(st);
    const uint16_t* X2 = X1 + BC * RS;
    const float* Ls = reinterpret_cast<const float*>(X2 + BC * RS);
    const float* Ds = Ls + BC;
    const int cf = (lo + (QROWS ? it : it % span)) * BC;   // first column

    // s = A X1^T and dp = E X2^T for this warp's 16 rows, BC columns: X's B
    // fragment (k over 2t, 2t + 1 and 8 on; column g) is two 4-byte loads
    // of its row g
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const uint16_t* x1 = X1 + (n * 8 + g) * RS + kk * 16 + 2 * t4;
        const uint16_t* x2 = X2 + (n * 8 + g) * RS + kk * 16 + 2 * t4;
        mma_bf16(s[n], af[kk], ld32(x1), ld32(x1 + 8));
        mma_bf16(dp[n], ef[kk], ld32(x2), ld32(x2 + 8));
      }

    // P in place of s, dS in place of dp, as the f32 kernel
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

    // acc += dS X1 (X1: K for DQ, Q for DKV); DKV also acc_v += P X2 (X2:
    // dO), over 16-column steps of the tile: the accumulators of blocks 2j
    // and 2j + 1 are the step's A fragment, rounded to bf16; X's B
    // fragments by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      const uint32_t wa[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
      const uint16_t* x1 = X1 + j * 16 * RS + x_lane;
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, x1 + d * 16);
        mma_bf16(acc[2 * d], wa, r[0], r[1]);
        mma_bf16(acc[2 * d + 1], wa, r[2], r[3]);
      }
      if constexpr (!QROWS) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const uint16_t* x2 = X2 + j * 16 * RS + x_lane;
#pragma unroll
        for (int d = 0; d < HD / 16; ++d) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, x2 + d * 16);
          mma_bf16(acc_v[2 * d], pa, r[0], r[1]);
          mma_bf16(acc_v[2 * d + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();   // this stage is read: the next load may refill it
  }

  // dQ and dK carry the score scale; dV does not
  const size_t o_stride = QROWS ? q_row : kv_row;
  const size_t o0 = (size_t)b * nrows * o_stride + (size_t)rh * HD + 2 * t4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra0 + 8 * r;
    if (row < nrows) {
      const size_t o = o0 + (size_t)row * o_stride;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        *reinterpret_cast<uint32_t*>(grad + o + d * 8) =
            pack_bf16(acc[d][2 * r] * scale, acc[d][2 * r + 1] * scale);
        if constexpr (!QROWS)
          *reinterpret_cast<uint32_t*>(grad_v + o + d * 8) =
              pack_bf16(acc_v[d][2 * r], acc_v[d][2 * r + 1]);
      }
    }
  }
}

// the mma.sync kernel of each entry (f32: flash_bwd_kernel, bf16:
// flash_bwd_kernel_bf16) and its shared memory
template <int HD, int MODE, bool CAP>
auto small_kernel(const float*) { return flash_bwd_kernel<HD, MODE, CAP>; }
template <int HD, int MODE, bool CAP>
auto small_kernel(const uint16_t*) {
  return flash_bwd_kernel_bf16<HD, MODE, CAP>;
}
template <int HD>
constexpr size_t small_bytes(const float*) { return Cfg<HD>::bytes; }
template <int HD>
constexpr size_t small_bytes(const uint16_t*) { return CfgB<HD>::bytes; }

template <int HD, int MODE, bool CAP, typename E>
cudaError_t launch_bwd(const E* q, const E* k, const E* v, const E* dout,
                       const float* lse, const float* dsum, E* grad,
                       E* grad_v, int B, int S, int T, int H, int K,
                       int causal, int window, float cap, cudaStream_t st) {
  const auto kernel = small_kernel<HD, MODE, CAP>(q);
  const size_t bytes = small_bytes<HD>(q);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)HD);
  const int heads = MODE == DQ ? H : K;
  const int rows = MODE == DQ ? S : T;
  const dim3 grid(heads * B, (rows + BR - 1) / BR);
  kernel<<<grid, NT, bytes, st>>>(q, k, v, dout, lse, dsum, grad, grad_v, S,
                                  T, H, K, causal, window, scale, cap);
  return cudaGetLastError();
}

template <int HD, bool CAP, typename E>
cudaError_t run_bwd(const E* q, const E* k, const E* v, const E* dout,
                    const float* lse, const float* dsum, E* dq, E* dk, E* dv,
                    int B, int S, int T, int H, int K, int causal, int window,
                    float cap, cudaStream_t st) {
  cudaError_t e = launch_bwd<HD, DQ, CAP>(q, k, v, dout, lse, dsum, dq,
                                          (E*)nullptr, B, S, T, H, K, causal,
                                          window, cap, st);
  if (e != cudaSuccess) return e;
  return launch_bwd<HD, DKV, CAP>(q, k, v, dout, lse, dsum, dk, dv, B, S, T,
                                  H, K, causal, window, cap, st);
}

template <int HD, typename E>
cudaError_t dispatch_bwd(const E* q, const E* k, const E* v, const E* dout,
                         const float* lse, const float* dsum, E* dq, E* dk,
                         E* dv, int B, int S, int T, int H, int K, int causal,
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
  // streamed rows a tile, CTAs an SM: at hd 64 two CTAs (of 74 KB, at most
  // 113 registers a thread) beat one of 64-row tiles
  static constexpr int BC = HD == 64 ? 32 : (HD == 128 ? 64 : 16);
  static constexpr int MINB = HD == 64 ? 2 : 1;
  // one tensor's f32 tile, which the consumers rewrite in place as its two
  // bf16 pieces, each [HD / 64 boxes][rows][128 bytes], swizzled
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
                 float* __restrict__ grad, float* __restrict__ grad_v,
                 int S, int T,
                 int H, int K, int causal, int window, float scale,
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

  int lo, hi;
  live_tiles(QROWS, causal, window, r_first, off, BC, nct, lo, hi);
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
    // a tile of `rows` rows from r0 of head `head`: one f32 box of HD
    // columns
    auto tma_tile = [&](uint32_t dst, const CUtensorMap* map, int rows,
                        int head, int r0, uint32_t bar) {
      tma_load4(dst, map, 0, head, r0, b, bar);
    };
    if (lane == 0) {
      mbar_expect_tx(rows_full, 2 * CF::row_bytes);
      tma_tile(base, &ta1, BR, rh, r_first, rows_full);
      tma_tile(base + CF::row_bytes, &ta2, BR, rh, r_first, rows_full);
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
        tma_tile(base + x_off(s), &tx1, BC, hx, c0, full(s));
        tma_tile(base + x_off(s) + CF::tile_bytes, &tx2, BC, hx, c0, full(s));
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
    // (the first call's last also covers A1's and A2's pieces). The call
    // ends on barrier 1, which warpgroup 1 reaches only after it has read
    // P of the tile before: warpgroup 0 writes the next P (and arrives at
    // barrier 2) only past it.
    auto split_tile = [&](int it) {
      const int s = it % NS;
      mbar_wait(full(s), (it / NS) & 1);
      {
        uint8_t* xg = gbase + x_off(s);
        Split<BC, HD> x;
        x.read(xg, ct);
        consumers_sync();
        x.write(xg, ct);
        x.read(xg + CF::tile_bytes, ct);
        consumers_sync();
        x.write(xg + CF::tile_bytes, ct);
        fence_async_shared();
      }
      consumers_sync();
    };
    split_tile(0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % NS;
      const int cf = (lo + (QROWS ? it : it % span)) * BC;   // first column
      const uint32_t x1 = base + x_off(s), x2 = x1 + CF::tile_bytes;
      const float* ls = lsd + s * 2 * BR;

      // warpgroup 0: s = A1 X1^T; warpgroup 1: dP = A2 X2^T, over hd in
      // 16-deep k-steps, three passes a step from f32 (small big, big
      // small, big big), one from bf16 (the tiles as they are: the big
      // pieces' place)
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
            pieces(sacc[8 * j + 2 * c], sacc[8 * j + 2 * c + 1],
                   pa[0][j][c], pa[1][j][c]);
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

// x (B, R, NH, HD) of E (f32 or bf16), contiguous: dims (HD, NH, R, B)
// innermost first, boxes of `rows` rows of one head; what lies past R reads
// as zeros. f32: boxes of HD columns, unswizzled (the consumers write the
// swizzled pieces); bf16: boxes of 64 columns with the 128-byte swizzle,
// wgmma's operand layout as it lands (the forward's tensor maps)
template <typename E>
bool tensor_map(CUtensorMap* map, const E* x, int HD, int NH, int R, int B,
                int rows) {
  constexpr bool BF = sizeof(E) == 2;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)NH,
                              (cuuint64_t)R, (cuuint64_t)B};
  const cuuint64_t strides[3] = {sizeof(E) * HD, sizeof(E) * HD * NH,
                                 sizeof(E) * HD * NH * R};
  const cuuint32_t box[4] = {BF ? 64u : (cuuint32_t)HD, 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<E*>(x), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                BF ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                BF ? CU_TENSOR_MAP_L2_PROMOTION_L2_128B
                   : CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int MODE, bool CAP>
cudaError_t launch_hopper(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse,
                          const float* dsum, float* grad, float* grad_v,
                          int B, int S, int T, int H, int K,
                          int causal, int window, float cap, cudaStream_t st) {
  using CF = hb::Cfg<HD>;
  CUtensorMap ta1, ta2, tx1, tx2;
  const bool ok =
      MODE == DQ
          ? tensor_map(&ta1, q, HD, H, S, B, hb::BR) &&
                tensor_map(&ta2, dout, HD, H, S, B, hb::BR) &&
                tensor_map(&tx1, k, HD, K, T, B, CF::BC) &&
                tensor_map(&tx2, v, HD, K, T, B, CF::BC)
          : tensor_map(&ta1, k, HD, K, T, B, hb::BR) &&
                tensor_map(&ta2, v, HD, K, T, B, hb::BR) &&
                tensor_map(&tx1, q, HD, H, S, B, CF::BC) &&
                tensor_map(&tx2, dout, HD, H, S, B, CF::BC);
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
                       const float* dout, const float* lse,
                       const float* dsum, float* dq, float* dk, float* dv,
                       int B, int S, int T, int H, int K, int causal,
                       int window, float cap, cudaStream_t st) {
  cudaError_t e = launch_hopper<HD, DQ, CAP>(q, k, v, dout, lse, dsum, dq,
                                             (float*)nullptr, B, S, T, H, K,
                                             causal, window, cap, st);
  if (e != cudaSuccess) return e;
  return launch_hopper<HD, DKV, CAP>(q, k, v, dout, lse, dsum, dk, dv, B, S,
                                     T, H, K, causal, window, cap, st);
}

template <int HD>
cudaError_t dispatch_hopper(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* dsum, float* dq, float* dk,
                            float* dv, int B,
                            int S, int T, int H, int K, int causal,
                            int window, float cap, cudaStream_t st) {
  if (cap > 0.f)
    return run_hopper<HD, true>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T,
                                H, K, causal, window, cap, st);
  return run_hopper<HD, false>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T,
                               H, K, causal, window, cap, st);
}

// ------------------------------ bf16 entry, hd 64, 128, 256: flash_bwd_bf16_hopper
// One launch forms the 5 products of every live (query, key) pair: a CTA
// owns BN keys of one KV head (K and V stay in shared memory) and streams
// the query tiles of its G heads, forming S^T and dP^T once, accumulating
// dV and dK in registers over all G heads and handing each tile's dQ
// partial, dS K, to a per-(b, h, query tile) sum in a fixed key-block order
// (the header comment above, "The bf16 entry").
namespace bb {
constexpr int NT = 384;   // the producer warpgroup and two consumer ones
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
template <int HD>
struct Cfg {
  // hd 256: the warpgroups split dK and dV by columns (64 x 256 f32 of each
  // is 256 registers a thread for one warpgroup), S^T and dP^T by queries,
  // and hand P^T and dS^T over in shared memory; hd 64 and 128: each
  // warpgroup owns 64 keys, and nothing crosses between them but dS for dQ
  static constexpr bool SPLIT_HD = HD == 256;
  static constexpr int BN = HD == 256 ? 64 : 128;   // keys a CTA
  static constexpr int BM = HD == 64 ? 128 : 64;    // queries a streamed tile
  static constexpr int NS = HD == 256 ? 1 : 2;      // stages of the Q, dO ring
  static constexpr int NB = HD / 64;                // 64-column boxes a row
  // every tile [NB boxes][rows][128 bytes], swizzled, as TMA lands it
  static constexpr uint32_t kv_bytes = BN * HD * 2;   // K (or V)
  static constexpr uint32_t qt_bytes = BM * HD * 2;   // a Q (or dO) tile
  static constexpr uint32_t k_off = 0, v_off = kv_bytes;
  static constexpr uint32_t ring_off = 2 * kv_bytes;
  static constexpr uint32_t stage_bytes = 2 * qt_bytes;   // Q, then dO
  // dS^T in bf16, [BM / 64 boxes][BN keys][64 queries], swizzled: dQ's A
  // (M-major) and, at hd 256, dK's (K-major); P^T the same (hd 256: dV's
  // A). Two of each, tile it in it % 2, so the warpgroups meet once a tile
  static constexpr uint32_t ds_bytes = BN * BM * 2;
  static constexpr uint32_t ds_off = ring_off + NS * stage_bytes;
  static constexpr uint32_t p_off = ds_off + 2 * ds_bytes;
  static constexpr uint32_t p_bytes = SPLIT_HD ? 2 * BN * BM * 2 : 0;
  // a tile's dQ partial in f32, element e of consumer thread t at e * 256 +
  // t: the layout of its (b, h, tile) chunk of the workspace
  static constexpr int R = BM * HD / 256;   // dQ registers a consumer thread
  static constexpr uint32_t dq_off = p_off + p_bytes;
  static constexpr uint32_t dq_bytes = BM * HD * 4;
  // [NS][2][BM] f32: a stage's lse * log2(e), then D
  static constexpr uint32_t lsd_off = dq_off + dq_bytes;
  // mbarriers: K and V full; full, empty a stage; dQ partial full, empty;
  // a tile's sum so far full, free
  static constexpr uint32_t bar_off = lsd_off + NS * 2 * BM * 4;
  static constexpr int nbar = 5 + 2 * NS;
  static constexpr uint32_t item_off = bar_off + 8 * nbar;   // the ticket
  // + 1,024: the base is rounded up to the swizzle's 1,024-byte atom
  static constexpr size_t bytes = item_off + 16 + 1024;
  static_assert(bytes <= 232448, "over the 227 KB a CTA may use");
};
}  // namespace bb

// D (64 x N, f32) {=, +=} A B over one 16-deep k-step, A and B bf16 in
// shared memory, each K-major (0) or MN-major (1): TA, TB are wgmma's
// transpose bits
template <int TA, int TB>
__device__ __forceinline__ void wg_ss(float (&d)[16], uint64_t da, uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wg_ss(float (&d)[32], uint64_t da, uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wg_ss(float (&d)[64], uint64_t da, uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}


// 2^x on the SFU: ex2.approx.ftz, within 2 ulp; a result under 2^-126
// flushes to 0, far below what a bf16 P holds (the forward's exponential)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
// wait until counter *c reaches n; trap after ~10 s of clock
__device__ __forceinline__ void wait_count(const int* c, int n) {
  long long t0 = 0;
  while (ld_acquire(c) < n) {
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// orders this thread's global accesses of the generic proxy with those of
// the async one (the bulk copies)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// `bytes` of global memory at src into shared memory at dst, completing on
// mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// `bytes` of shared memory at src into global memory at dst: stored, or
// added element by element in f32 (a reduction in L2)
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_add(float* dst, uint32_t src,
                                         uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// The bf16 route's dQ sums and their order live in `dsum` after D: D (B H
// S floats), then the counters (one a (b, h, query tile), then the ticket)
// as int32, then the f32 workspace, one chunk of BM x HD a (b, h, query
// tile); each part starts on 16 bytes, 4 words
__host__ __device__ __forceinline__ long long align4(long long n) {
  return (n + 3) & ~3ll;
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(bb::NT, 1)
flash_bwd_bf16_hopper(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, int* __restrict__ cnt,
                      float* __restrict__ ws, uint16_t* __restrict__ dq,
                      uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                      int B, int S, int T, int H, int K, int causal,
                      int window, float scale, float cap, int P) {
  using CF = bb::Cfg<HD>;
  constexpr int BN = CF::BN, BM = CF::BM, NS = CF::NS, NB = CF::NB;
  constexpr bool SH = CF::SPLIT_HD;
  extern __shared__ __align__(1024) uint8_t bb_smem[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(bb_smem) + 1023u) & ~1023u;
  uint8_t* gbase =
      bb_smem + (base - (uint32_t)__cvta_generic_to_shared(bb_smem));
  float* lsd = reinterpret_cast<float*>(gbase + CF::lsd_off);
  float* dqs = reinterpret_cast<float*>(gbase + CF::dq_off);
  int* item_s = reinterpret_cast<int*>(gbase + CF::item_off);
  const uint32_t kv_full = base + CF::bar_off;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + NS + s); };
  const uint32_t dq_full = kv_full + 8 * (1 + 2 * NS), dq_empty = dq_full + 8;
  const uint32_t sum_full = dq_full + 16, sum_free = dq_full + 24;

  const int G = H / K, off = T - S;
  const int nkb = (T + BN - 1) / BN, nqt = (S + BM - 1) / BM;
  if (threadIdx.x == 0) {
    // the ticket: CTAs take work items in the order they start, so every
    // item whose dQ adds come before this one's is already taken
    *item_s = atomicAdd(cnt + (size_t)B * H * nqt, 1);
    mbar_init(kv_full, 1);     // expect_tx with K and V
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 2);   // expect_tx with Q and dO, the warp's
      mbar_init(empty(s), 8);  // the consumers' eight warps
    }
    mbar_init(dq_full, 8);     // the consumers' eight warps
    mbar_init(dq_empty, 1);    // the writer
    mbar_init(sum_full, 1);    // expect_tx with a tile's sum so far
    mbar_init(sum_free, 8);    // the consumers' eight warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // item i: chunk i / (P nkb) of P (b, kv head) groups (the last chunk may
  // hold fewer), within it key block nkb - 1 - j / P' (the last first: a
  // tile's adds run from its last key block down), then the group
  const int item = *item_s;
  const int chunk = item / (P * nkb), j = item % (P * nkb);
  const int ng = min(P, B * K - chunk * P);
  const int n = nkb - 1 - j / ng, bk = chunk * P + j % ng;
  const int b = bk / K, kh = bk % K;
  int mlo, mhi;
  kblock_tiles(n, BM, BN, nqt, off, causal, window, mlo, mhi);
  // iteration it: query tile mlo + it / G of head kh G + it % G
  const int n_it = mhi > mlo ? (mhi - mlo) * G : 0;
  // this key block's place among the adders of tile m's dQ (0 first), and
  // their number
  auto order = [&](int m, int& rank, int& count) {
    int klo, khi;
    tile_kblocks(m, BM, BN, nkb, off, causal, window, klo, khi);
    rank = khi - 1 - n;
    count = khi - klo;
  };
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  if (wg == 0) {
    // ------------------------------------------ producer and dQ writer
    setmaxnreg_dec<bb::PRODUCER_REGS>();
    if (warp == 0 && n_it > 0) {
      // K and V once; then Q, dO (TMA), lse * log2(e) and D (the lanes)
      // of iteration it into stage it % NS once the consumers freed it
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * CF::kv_bytes);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load4(base + CF::k_off + c * BN * 128, &tk, 64 * c, kh, n * BN,
                    b, kv_full);
          tma_load4(base + CF::v_off + c * BN * 128, &tv, 64 * c, kh, n * BN,
                    b, kv_full);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % NS, m = mlo + it / G, h = kh * G + it % G;
        const uint32_t qs = base + CF::ring_off + s * CF::stage_bytes;
        mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(s), CF::stage_bytes);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load4(qs + c * BM * 128, &tq, 64 * c, h, m * BM, b, full(s));
            tma_load4(qs + CF::qt_bytes + c * BM * 128, &tdo, 64 * c, h,
                      m * BM, b, full(s));
          }
        }
        float* ls = lsd + s * 2 * BM;
        const size_t at = ((size_t)b * H + h) * S;
        for (int i = lane; i < BM; i += 32) {
          const int qi = m * BM + i;
          ls[i] = qi < S ? lse[at + qi] * LOG2E : INFINITY;
          ls[BM + i] = qi < S ? dsum[at + qi] : 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full(s));
      }
      // the last stages' loads have landed (a load that never completes
      // traps here)
      for (int it = max(n_it - NS, 0); it < n_it; ++it)
        mbar_wait(full(it % NS), (it / NS) & 1);
    } else if (warp == 1 && lane == 0) {
      // the dQ traffic, in the consumers' order of tiles: each partial but
      // a tile's last to the workspace once its predecessors' adds are
      // done (stored by the first adder, added by the others: bulk copies
      // from shared memory), the tile's counter moved on once the add has
      // landed; for a tile's last adder, the sum so far into shared memory
      // as soon as it is complete and the buffer is free
      int k = 0, f = 0;   // partials taken, sums fetched
      for (int it = 0; it < n_it; ++it) {
        const int m = mlo + it / G, h = kh * G + it % G;
        int rank, count;
        order(m, rank, count);
        if (count == 1) continue;   // the consumers write dQ as it is
        const size_t tile = ((size_t)b * H + h) * nqt + m;
        float* chunk = ws + tile * (size_t)(BM * HD);
        if (rank == count - 1) {
          // the consumers have read the last sum fetched
          if (f > 0) mbar_wait(sum_free, (f - 1) & 1);
          wait_count(cnt + tile, rank);
          fence_proxy_async_global();
          mbar_expect_tx(sum_full, CF::dq_bytes);
          bulk_load(base + CF::dq_off, chunk, CF::dq_bytes, sum_full);
          ++f;
          continue;
        }
        mbar_wait(dq_full, k & 1);
        wait_count(cnt + tile, rank);
        fence_proxy_async_global();
        if (rank == 0) bulk_store(chunk, base + CF::dq_off, CF::dq_bytes);
        else bulk_add(chunk, base + CF::dq_off, CF::dq_bytes);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(dq_empty);   // the partial's buffer is free
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        fence_proxy_async_global();
        st_release(cnt + tile, rank + 1);
        ++k;
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<bb::CONSUMER_REGS>();
  const int cw = wg - 1;                 // consumer warpgroup 0 or 1
  const int ct = threadIdx.x - 128;      // 0 .. 255
  const int g = lane >> 2, t4 = lane & 3;
  const int rl0 = 16 * warp + g;         // this thread's rows rl0, rl0 + 8
  const float scale2 = scale * LOG2E;
  constexpr int NSC = SH ? BM / 2 : BM;  // score columns (queries) a warpgroup
  constexpr int NKV = SH ? HD / 2 : HD;  // dK and dV columns a warpgroup
  constexpr int NQ = SH ? HD / 2 : 64;   // dQ columns a warpgroup
  // this warpgroup's part: its first key row of the block, first score
  // column, first dK and dV column, first dQ row and column
  const int krow = SH ? 0 : 64 * cw, qcol = SH ? 32 * cw : 0;
  const int kvcol = SH ? 128 * cw : 0;
  const int dqrow = HD == 64 ? 64 * cw : 0;
  const int dqcol = HD == 128 ? 64 * cw : (SH ? 128 * cw : 0);
  float dka[NKV / 2], dva[NKV / 2];
#pragma unroll
  for (int i = 0; i < NKV / 2; ++i) dka[i] = dva[i] = 0.f;

  if (n_it > 0) {
    mbar_wait(kv_full, 0);
    const uint32_t ks = base + CF::k_off, vs = base + CF::v_off;
    // S^T's and dP^T's A: this warpgroup's key rows of K and V (K-major);
    // dQ's A: dS^T read M-major (its 64 queries), dQ's B: K read MN-major
    const uint64_t ka = sw128_desc(ks + krow * 128, 16, 1024);
    const uint64_t va = sw128_desc(vs + krow * 128, 16, 1024);
    const uint64_t dsa = sw128_desc(base + CF::ds_off + (dqrow / 64) * BN * 128,
                                    BN * 128, 1024);
    const uint64_t kb = sw128_desc(ks + (dqcol / 64) * BN * 128, BN * 128,
                                   1024);
    int k = 0, f = 0;   // partials handed to the writer, sums read
    // tile it's dQ partial: 64 query rows (dqrow on) x NQ columns (dqcol
    // on), in flight from its issue until the next tile begins
    float dqa[CF::R];
    // tile it's dQ, once its product is done: the last adder's sum plus
    // this partial, times the score scale, rounded to bf16 once (element 4
    // j + 2 r + c is row dqrow + rl0 + 8 r, column dqcol + 8 j + 2 t4 + c);
    // any other adder's partial to the writer through shared memory
    auto finish_dq = [&](int it) {
      const int m = mlo + it / G, h = kh * G + it % G;
      int rank, count;
      order(m, rank, count);
      if (rank == count - 1) {
        if (count > 1) mbar_wait(sum_full, f & 1);
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r;
            const int row = m * BM + dqrow + rl0 + 8 * r;
            float x0 = dqa[e], x1 = dqa[e + 1];
            if (count > 1) {
              x0 = dqs[e * 256 + ct] + x0;
              x1 = dqs[(e + 1) * 256 + ct] + x1;
            }
            if (row < S)
              *reinterpret_cast<uint32_t*>(
                  dq + (((size_t)b * S + row) * H + h) * HD + dqcol + 8 * j +
                  2 * t4) = pack_bf16(x0 * scale, x1 * scale);
          }
        if (count > 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(sum_free);
          ++f;
        }
      } else {
        mbar_wait(dq_empty, (k & 1) ^ 1);
#pragma unroll
        for (int e = 0; e < CF::R; ++e) dqs[e * 256 + ct] = dqa[e];
        fence_async_shared();
        __syncwarp();
        if (lane == 0) mbar_arrive(dq_full);
        ++k;
      }
    };
    for (int it = 0; it < n_it; ++it) {
      const int s = it % NS, m = mlo + it / G;
      const uint32_t qs = base + CF::ring_off + s * CF::stage_bytes;
      const uint32_t dos = qs + CF::qt_bytes;
      const float* ls = lsd + s * 2 * BM;
      mbar_wait(full(s), (it / NS) & 1);

      // the last tile's dQ (finished while the next S^T product runs, it
      // measured no faster), then S^T = K Q^T and dP^T = V dO^T: this
      // warpgroup's keys x its queries
      if (it > 0) {
        wgmma_wait<0>();
        pin(dqa);
        finish_dq(it - 1);
      }
      float sacc[NSC / 2], pacc[NSC / 2];
      {
        const uint64_t qb = sw128_desc(qs + qcol * 128, 16, 1024);
        const uint64_t ob = sw128_desc(dos + qcol * 128, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wg_ss<0, 0>(sacc, ka + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4),
                      qb + (((kk / 4) * BM * 128 + (kk % 4) * 32) >> 4),
                      kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wg_ss<0, 0>(pacc, va + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4),
                      ob + (((kk / 4) * BM * 128 + (kk % 4) * 32) >> 4),
                      kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        pin(sacc);
      }

      // P^T while dP^T's product runs: element 4 j + 2 r + c is key row
      // krow + rl0 + 8 r, query column qcol + 8 j + 2 t4 + c; P rounded to
      // bf16 (a wgmma accumulator's two neighbouring 8-column blocks are
      // one 16-deep k-step's register A fragment), and in its place P (times
      // 1 - tanh^2 under a cap) for dS. The mask's test runs only where this
      // warpgroup's keys x queries are not all live (a separate loop: one
      // loop with the test inside predicates every element)
      uint32_t pa[NSC / 16][4], da[NSC / 16][4];
      const int k0 = n * BN + krow, q0 = m * BM + qcol + off;
      const bool all_live = m * BM + qcol + NSC <= S && k0 + 64 <= T &&
                            (!causal || k0 + 63 <= q0) &&
                            (window <= 0 || k0 > q0 + NSC - 1 - window);
      auto form_p = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < NSC / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float pp[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * r + c;
              const int cl = qcol + 8 * j + 2 * t4 + c;   // column in the tile
              const float x = sacc[e];
              float sc, th = 0.f;
              if constexpr (CAP) {
                th = tanhf(x * scale / cap);
                sc = cap * th * LOG2E;
              } else {
                sc = x * scale2;
              }
              pp[c] = fast_exp2(sc - ls[cl]);
              if constexpr (decltype(masked)::value) {
                const int kpos = k0 + rl0 + 8 * r;
                const int qi = m * BM + cl, qpos = qi + off;
                const bool ok = qi < S && kpos < T &&
                                (!causal || kpos <= qpos) &&
                                (window <= 0 || kpos > qpos - window);
                pp[c] = ok ? pp[c] : 0.f;
              }
              sacc[e] = CAP ? pp[c] * (1.f - th * th) : pp[c];
            }
            pa[j / 2][2 * (j % 2) + r] = pack_bf16(pp[0], pp[1]);
          }
      };
      if (all_live) form_p(std::false_type());
      else form_p(std::true_type());
      wgmma_wait<0>();
      pin(pacc);
      // dS^T = P^T o (dP^T - D), rounded to bf16
#pragma unroll
      for (int j = 0; j < NSC / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * j + 2 * r, cl = qcol + 8 * j + 2 * t4;
          da[j / 2][2 * (j % 2) + r] =
              pack_bf16(sacc[e] * (pacc[e] - ls[BM + cl]),
                        sacc[e + 1] * (pacc[e + 1] - ls[BM + cl + 1]));
        }
      // dS^T (and at hd 256 P^T) to this tile's buffers (the other ones
      // hold the last tile's, whose dQ may still read them); fragment (j,
      // c) is key row krow + rl0 + 8 (c % 2), query columns qcol + 16 j +
      // 8 (c / 2) + 2 t4 and on
      const uint32_t dsb = CF::ds_off + (it & 1) * CF::ds_bytes;
      const uint32_t pb = CF::p_off + (it & 1) * CF::ds_bytes;
#pragma unroll
      for (int j = 0; j < NSC / 16; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kr = krow + rl0 + 8 * (c % 2);
          const int qc = qcol + 16 * j + 8 * (c / 2) + 2 * t4;
          const uint32_t at = (qc / 64) * BN * 128 + kr * 128 +
                              ((((qc % 64) >> 3) ^ (kr & 7)) << 4) +
                              (qc & 7) * 2;
          *reinterpret_cast<uint32_t*>(gbase + dsb + at) = da[j][c];
          if constexpr (SH)
            *reinterpret_cast<uint32_t*>(gbase + pb + at) = pa[j][c];
        }
      fence_async_shared();

      // dV += P^T dO and dK += dS^T Q (dO and Q MN-major); hd 64, 128: A
      // from registers, all of the tile's queries, issued before the
      // warpgroups meet (the other one's dS is only dQ's); hd 256: A from
      // shared memory (both halves), this warpgroup's 128 columns
      if constexpr (SH) consumers_sync();
      wgmma_fence();
      if constexpr (!SH) {
        const uint64_t ob = sw128_desc(dos, BM * 128, 1024);
        const uint64_t qb = sw128_desc(qs, BM * 128, 1024);
#pragma unroll
        for (int j = 0; j < BM / 16; ++j)
          wgmma_rs<HD>(dva, pa[j], ob + ((j * 16 * 128) >> 4));
#pragma unroll
        for (int j = 0; j < BM / 16; ++j)
          wgmma_rs<HD>(dka, da[j], qb + ((j * 16 * 128) >> 4));
      } else {
        const uint64_t pt = sw128_desc(base + pb, 16, 1024);
        const uint64_t dt = sw128_desc(base + dsb, 16, 1024);
        const uint64_t ob = sw128_desc(dos + (kvcol / 64) * BM * 128,
                                       BM * 128, 1024);
        const uint64_t qb = sw128_desc(qs + (kvcol / 64) * BM * 128,
                                       BM * 128, 1024);
#pragma unroll
        for (int j = 0; j < BM / 16; ++j)
          wg_ss<0, 1>(dva, pt + ((j * 32) >> 4), ob + ((j * 16 * 128) >> 4),
                      1);
#pragma unroll
        for (int j = 0; j < BM / 16; ++j)
          wg_ss<0, 1>(dka, dt + ((j * 32) >> 4), qb + ((j * 16 * 128) >> 4),
                      1);
      }
      wgmma_commit();
      if constexpr (!SH) consumers_sync();
      // this tile's dQ partial, dS K over the block's keys
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wg_ss<1, 1>(dqa, dsa + (((it & 1) * CF::ds_bytes + kk * 16 * 128) >> 4),
                    kb + ((kk * 16 * 128) >> 4), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      pin(dka);
      pin(dva);
      pin(pa);
      pin(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // Q, dO and the lse are read
    }
    wgmma_wait<0>();
    pin(dqa);
    finish_dq(n_it - 1);
  }

  // dK (times the score scale) and dV of this warpgroup's rows and
  // columns: element 4 j + 2 r + c is key row krow + rl0 + 8 r, column
  // kvcol + 8 j + 2 t4 + c
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n * BN + krow + rl0 + 8 * r;
    if (key < T) {
      const size_t o = (((size_t)b * T + key) * K + kh) * HD + kvcol + 2 * t4;
#pragma unroll
      for (int j = 0; j < NKV / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + o + 8 * j) =
            pack_bf16(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o + 8 * j) =
            pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// (b, kv head) groups a chunk of the bf16 route's ticket order (BM query
// rows a tile). A call whose f32 workspace (B H ceil(S / BM) BM HD 4
// bytes) fits in L2_SUMS takes every group at once, key block by key
// block: the best balance, and it stays in the 50 MB L2. A larger one
// takes the groups one at a time: a group's key blocks run together, so
// only the dQ sums of the groups in flight are live, and they stay in L2
// (at granite-8b's serve shape the workspace is 134 MB; taken all at once,
// every add goes to HBM).
constexpr long long L2_SUMS = 24ll << 20;
inline int bf16_chunk_groups(int B, int S, int H, int K, int HD, int BM) {
  const long long ws = (long long)B * H * ((S + BM - 1) / BM) * BM * HD * 4;
  return ws <= L2_SUMS ? B * K : 1;
}

// the bf16 route's tiles: queries a streamed tile, keys a CTA
__host__ __device__ __forceinline__ void bf16_tiles(int HD, int& BM, int& BN) {
  BM = HD == 64 ? 128 : 64;
  BN = HD == 256 ? 64 : 128;
}

template <int HD, bool CAP>
cudaError_t launch_bf16_hopper(const uint16_t* q, const uint16_t* k,
                               const uint16_t* v, const uint16_t* dout,
                               const float* lse, float* dsum, uint16_t* dq,
                               uint16_t* dk, uint16_t* dv, int B, int S, int T,
                               int H, int K, int causal, int window, float cap,
                               cudaStream_t st) {
  using CF = bb::Cfg<HD>;
  CUtensorMap tq, tdo, tk, tv;
  if (!(tensor_map(&tq, q, HD, H, S, B, CF::BM) &&
        tensor_map(&tdo, dout, HD, H, S, B, CF::BM) &&
        tensor_map(&tk, k, HD, K, T, B, CF::BN) &&
        tensor_map(&tv, v, HD, K, T, B, CF::BN)))
    return cudaErrorInvalidValue;
  const auto kernel = flash_bwd_bf16_hopper<HD, CAP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CF::bytes);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)B * H * ((S + CF::BM - 1) / CF::BM);
  int* cnt = reinterpret_cast<int*>(dsum + align4((long long)B * H * S));
  float* ws = reinterpret_cast<float*>(cnt + align4(tiles + 1));
  const int nkb = (T + CF::BN - 1) / CF::BN;
  const float scale = 1.0f / sqrtf((float)HD);
  kernel<<<nkb * B * K, bb::NT, CF::bytes, st>>>(
      tq, tdo, tk, tv, lse, dsum, cnt, ws, dq, dk, dv, B, S, T, H, K, causal,
      window, scale, cap, bf16_chunk_groups(B, S, H, K, HD, CF::BM));
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_bf16_hopper(const uint16_t* q, const uint16_t* k,
                                 const uint16_t* v, const uint16_t* dout,
                                 const float* lse, float* dsum, uint16_t* dq,
                                 uint16_t* dk, uint16_t* dv, int B, int S,
                                 int T, int H, int K, int causal, int window,
                                 float cap, cudaStream_t st) {
  if (cap > 0.f)
    return launch_bf16_hopper<HD, true>(q, k, v, dout, lse, dsum, dq, dk, dv,
                                        B, S, T, H, K, causal, window, cap, st);
  return launch_bf16_hopper<HD, false>(q, k, v, dout, lse, dsum, dq, dk, dv,
                                       B, S, T, H, K, causal, window, cap, st);
}

// Either entry: D, then the route of HD. The f32 entry at hd 64, 128 and
// 256: dQ, then dK and dV together (flash_bwd_hopper); the bf16 entry
// there: one launch of all three (flash_bwd_bf16_hopper); both at hd 16 and
// 32: dQ, then dK and dV (the mma.sync kernels)
template <typename E>
int run_entry(const E* q, const E* k, const E* v, const E* o, const E* dout,
              const float* lse, E* dq, E* dk, E* dv, float* dsum, int B,
              int S, int T, int H, int K, int HD, int causal, int window,
              float softcap, cudaStream_t st) {
  constexpr bool BF = sizeof(E) == 2;
  const int route = flash_attention_bwd_route(HD);
  if (route < 0) return (int)cudaErrorInvalidValue;
  const long long nrows = (long long)B * S * H;
  TileSetup ts{};
  if (BF && route == 1) {
    bf16_tiles(HD, ts.BM, ts.BN);
    ts.nkb = (T + ts.BN - 1) / ts.BN;
    ts.off = T - S;
    ts.causal = causal;
    ts.window = window;
    ts.ncnt = (long long)B * H * ((S + ts.BM - 1) / ts.BM) + 1;
    ts.cnt = reinterpret_cast<int*>(dsum + align4(nrows));
    // dead tiles come first (the masks only drop a tile's keys from the
    // end of the sequence of tiles for S > T): none if tile 0 is live
    int klo, khi;
    tile_kblocks(0, ts.BM, ts.BN, ts.nkb, ts.off, causal, window, klo, khi);
    if (khi <= klo) ts.dq = reinterpret_cast<uint16_t*>(dq);
  }
  if (nrows > 0) {
    if constexpr (BF) {
      const long long threads = nrows * (HD / 8);
      flash_bwd_dsum_bf16<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
          o, dout, dsum, S, H, HD, nrows, ts);
    } else {
      const int per = 8;   // warps (rows) per block
      flash_bwd_dsum<<<(unsigned)((nrows + per - 1) / per), 32 * per, 0,
                       st>>>(o, dout, dsum, S, H, HD, nrows);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (route == 0) {
    if (HD == 16) return (int)dispatch_bwd<16>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    return (int)dispatch_bwd<32>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
  }
  if constexpr (BF) {
    if (HD == 64) return (int)dispatch_bf16_hopper<64>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    if (HD == 128) return (int)dispatch_bf16_hopper<128>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    return (int)dispatch_bf16_hopper<256>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
  } else {
    if (HD == 64) return (int)dispatch_hopper<64>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    if (HD == 128) return (int)dispatch_hopper<128>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
    return (int)dispatch_hopper<256>(q, k, v, dout, lse, dsum, dq, dk, dv, B, S, T, H, K, causal, window, softcap, st);
  }
}

}  // namespace

extern "C" {

// Which kernel serves head width HD in either entry: 1 the Hopper kernels
// (64, 128, 256: flash_bwd_hopper for f32, flash_bwd_bf16_hopper for bf16),
// 0 the mma.sync kernels (16, 32: flash_bwd_kernel for f32,
// flash_bwd_kernel_bf16 for bf16), -1 none. The entries dispatch on the
// same test.
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
  return run_entry(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, S, T, H, K, HD,
                   causal, window, softcap, (cudaStream_t)stream);
}

// The bf16 entry's backward: the gradients of flash_attention_bf16's output
// o, as flash_attention_bwd_f32's, with q, k, v, o, dout, dq, dk and dv
// bf16 (2 bytes each) and lse (flash_attention_bf16's, f32). dsum is a
// float32 workspace of flash_attention_bwd_workspace(B, S, H, HD, 1)
// floats: D, then (hd 64, 128, 256) the dQ order's counters and the f32
// dQ partials' sums. hd 64, 128, 256: two launches on `stream`, D (which
// also zeroes the counters) and flash_bwd_bf16_hopper (dq, dk and dv
// together); hd 16, 32: three, D, dq, then dk and dv together
// (flash_bwd_kernel_bf16). Returns a cudaError_t.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, void* dq, void* dk, void* dv,
                             float* dsum, int B, int S, int T, int H, int K,
                             int HD, int causal, int window, float softcap,
                             void* stream) {
  using E = uint16_t;
  return run_entry((const E*)q, (const E*)k, (const E*)v, (const E*)o,
                   (const E*)dout, lse, (E*)dq, (E*)dk, (E*)dv, dsum, B, S, T,
                   H, K, HD, causal, window, softcap, (cudaStream_t)stream);
}

// Floats of the dsum workspace that flash_attention_bwd_f32 (bf16 = 0) or
// flash_attention_bwd_bf16 (bf16 = 1) takes at these sizes: D's B H S, and
// for the bf16 entry's Hopper route (hd 64, 128, 256) the counters (one a
// (b, h, query tile), and the ticket) and a BM x HD f32 chunk a (b, h,
// query tile), each part 16-byte aligned.
long long flash_attention_bwd_workspace(int B, int S, int H, int HD,
                                        int bf16) {
  const long long d = (long long)B * H * S;
  if (!bf16 || flash_attention_bwd_route(HD) != 1) return d;
  int BM, BN;
  bf16_tiles(HD, BM, BN);
  const long long tiles = (long long)B * H * ((S + BM - 1) / BM);
  return align4(d) + align4(tiles + 1) + tiles * BM * HD;
}

// Dynamic shared memory (bytes) of the dQ and dK/dV kernels that serve head
// width HD in the f32 entry (the same for both), 0 for a width the library
// is not built for.
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

// The same for the bf16 entry's kernels (hd 64, 128, 256: its one main
// kernel, flash_bwd_bf16_hopper).
int flash_attention_bwd_bf16_smem_bytes(int HD) {
  switch (HD) {
    case 16: return (int)CfgB<16>::bytes;
    case 32: return (int)CfgB<32>::bytes;
    case 64: return (int)bb::Cfg<64>::bytes;
    case 128: return (int)bb::Cfg<128>::bytes;
    case 256: return (int)bb::Cfg<256>::bytes;
    default: return 0;
  }
}

// CTAs an SM of the bf16 entry's main kernel at head width HD (hd 64, 128,
// 256: flash_bwd_bf16_hopper; hd 16, 32: the dQ launch of
// flash_bwd_kernel_bf16) by the occupancy calculator, 0 for a width the
// library is not built for or on error.
int flash_attention_bwd_bf16_ctas_per_sm(int HD) {
  int n = 0;
  auto occ = [&](auto kernel, int threads, size_t bytes) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      bytes) != cudaSuccess)
      n = 0;
  };
  switch (HD) {
    case 16: occ(flash_bwd_kernel_bf16<16, DQ, false>, NT, CfgB<16>::bytes); break;
    case 32: occ(flash_bwd_kernel_bf16<32, DQ, false>, NT, CfgB<32>::bytes); break;
    case 64: occ(flash_bwd_bf16_hopper<64, false>, bb::NT, bb::Cfg<64>::bytes); break;
    case 128: occ(flash_bwd_bf16_hopper<128, false>, bb::NT, bb::Cfg<128>::bytes); break;
    case 256: occ(flash_bwd_bf16_hopper<256, false>, bb::NT, bb::Cfg<256>::bytes); break;
    default: break;
  }
  return n;
}

}  // extern "C"
