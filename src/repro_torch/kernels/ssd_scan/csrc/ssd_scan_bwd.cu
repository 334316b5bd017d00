// Backward of the fused SSD (Mamba-2) scan's f32 and bf16 entries for
// NVIDIA Hopper (sm_90a), products on the tensor cores at f32 accuracy.
//
// Replaces no TPU kernel. The reference has no backward Pallas kernel: it
// trains through the plain chunked matmul (SSD) form that JAX
// differentiates (src/repro/models/mamba.py:235-342). The port's forward
// runs the hand-written kernel (ssd_scan.cu), which autograd cannot see
// through, and the plain version may not serve a CUDA tensor: this is the
// backward of that forward (ops.SsdScanF32), the gradients of
//     h_t = exp(dt_t A_h) h_{t-1} + dt_t B_t (x) u_t,   y_t = C_t h_t + D_h u_t
// given dy and the final state's gradient dh, in the chunked form of
// ref.py: ssd_scan_bwd_ref (its docstring has the terms), chunks of QC = 64
// steps (steps past S load as zeros: zero dt, u, dy, B and C add nothing,
// so any S runs without padding in device memory).
//
// Only two things chain chunk to chunk: the state entering a chunk (H_in)
// and the adjoint of the state leaving it (dH). So two kernels, one launch
// of the C entry:
//   1. ssd_bwd_states, one CTA a (head, batch, direction): the state
//      forwards, H <- exp(L_QC) H + (w B)^T u (w_s = exp(L_QC - L_s) dt_s),
//      or its adjoint backwards, dH <- exp(L_QC) dH + (exp(L) C)^T dy, one
//      64-deep product a chunk on 16 x 8 tiles held in registers (the
//      forward's), each chunk's value written to scratch (2, B, H, T, N,
//      hp) before it is carried on; after the first chunk dH is dh0.
//   2. ssd_bwd_chunks, one CTA a (chunk, head, batch): every other gradient
//      of its chunk from its own tiles and those two states. Each of the 4
//      warps owns 16 rows of the chunk:
//        S^T = B C^T, DYU^T = u dy^T on its rows s, only the 8-step blocks
//        of t at or after its diagonal (t >= s: the causal half);
//        M^T = S^T o W o dt_s, G^T = DYU^T o W o dt_s, Y = DYU^T o S^T o W
//        in registers (W_ts = exp(L_t - L_s), never formed for t < s,
//        where it overflows);
//        du = w (B dH) + M^T dy + D dy and dB = w (u dH^T) + G^T C on rows
//        s, M^T and G^T the A operands as they stand in registers;
//        G^T to shared memory (over dH's tile), then dC = exp(L) (dy
//        H_in^T) + G B on rows t;
//        the gradient of each L_t from every exponent it enters (always
//        differences of L, never a lone exp(-L)), its reverse cumulative
//        sum within the chunk, ddt, and dA and dD as one partial a
//        (batch, head, chunk).
// Products: mma.sync m16n8k8 in TF32, each split into three (the forward's
// scheme): every operand x is big (its low 13 bits cut) + small, a product
// accumulates small*big + big*small + big*big in f32, within ~1e-6 of the
// result's scale at zamba2's widths against a float64 oracle, one product
// ~1.5e-3 (tests/test_torch_scan_bwd_design.py; the tolerance is 2e-4). The
// k index of every 8-deep step runs over (2t, 2t + 1) pairs, so an
// accumulator (rows g, g + 8; columns 2t, 2t + 1 of a block) is already
// the A fragment of the next product. Tiles 32 or 64 floats wide have no
// padding: the 8-float blocks of row r are XOR-ed with (r ^ r >> 2) & 3, so
// every fragment read (two rows a k-step, or two k rows of a column) hits
// 32 banks; 16-wide tiles have rows of 24. 101 KB of shared memory and 240
// registers a thread at N = hp = 64: two CTAs an SM. The chunk kernel's
// tiles come in two copy groups, the two states' behind u, dy, B, C and dt,
// which the first products need. Products whose A operand is in shared
// memory keep their k-steps rolled: unrolled, ptxas hoisted their operand
// loads to 255 registers and 1.2 KB of spills a thread at N = hp = 64, and
// the two kernels took 0.74-0.75 ms at zamba2's train shape in place of
// 0.34-0.36 (tools/scan_variants.py).
//
// The sums that end in a per-head scalar through cancelling terms (each
// step's gradient of L, its reverse cumulative sum, ddt's direct terms, dA,
// dD, <dH, H_in>) are taken in f64: taken in f32, a reduced zamba2's
// A_log gradient landed outside phase 18's 1e-4 of the CPU's
// (chip_smoke.py). Sums across CTAs have no float atomics: dB and dC
// (summed over heads) are written as one partial a head (B, H, S, N), dA
// and dD as one a (batch, head, chunk); the wrapper sums them with
// torch.sum over their axes, so a train step is bitwise equal run to run.
//
// The bf16 entry (ssd_scan_bwd_bf16, the backward of ssd_scan_bf16, which
// zamba2 trains through under the reference's ssm_bf16 variant) runs the
// same two kernels on the stream type TS = bf16: u, B, C and dy are read
// as bf16 in 16-byte pieces (8 values) and widened into the same f32
// tiles, each piece one 8-float block that the swizzle keeps whole (so
// 16-wide rows of 24 floats and the 32/64-wide XOR layout carry over as
// they are); every product then reads f32 tiles, as in the f32 entry. A
// widened bf16 value is its own TF32 part, so products of two stream
// tiles (B C^T, u dy^T) are exact in the first of the three passes. du is
// rounded to bf16 once from its f32 sum; dB and dC stay f32 partials a
// head, which the wrapper sums and then rounds (never a partial). The
// bf16 pieces are read by plain loads, not cp.async: a simple first
// version, its load latency not hidden.
//
// What bounds it: at zamba2-1.2b's train shape (B 8, S 256, 64 heads,
// hp = N = 64) the function reads u and dy and writes du (33.5 MB each),
// with dt, B, C, ddt, dB and dC 0.104 GB: 0.031 ms at 3.35 TB/s. Its least
// operation count, the chunked form at the best chunk length
// (chip_smoke.py: ssd_bwd_ops_bytes), is 5.84 GFLOP: 0.035 ms as three
// TF32 products each at 495 TFLOP/s, the route's arithmetic. This design
// also moves the two states' scratch (67 MB written, 67 MB read) and runs
// 10 products of a chunk's 64^3 (4 of them causal halves) against the
// bound's count. The two take ~0.34-0.36 ms there, the state kernel alone
// 0.07-0.08 (the first version of this backward, one CTA a (batch,
// head) in f32 FMAs, 0.73-0.76; H100 80GB HBM3 at 700 W,
// PERF.md; tools/scan_variants.py ssd_scan_bwd, chip_smoke.py phase 16b):
// the chunk kernel runs 8 warps an SM, each a chain of dependent loads,
// splits and mma.sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int QC = 64;        // the forward's chunk (ssd_scan.cu)
constexpr int NW = 4;         // warps a CTA: one a 16-row tile of a chunk
constexpr int NT = 32 * NW;
constexpr int SB = QC / 8;    // 8-step blocks of a chunk
constexpr float kLog2e = 1.4426950408889634f;

// A tile of rows of W floats in shared memory (W = 16, 32, 64): element
// (r, c) at at(r, c). W = 32, 64: no padding, the 8-float blocks of row r
// XOR-ed with f(r) = (r ^ (r >> 2)) & 3, injective on four rows in a row
// and on rows 2t of a k-step: conflict-free fragment reads; W = 16: rows
// of 24 floats. 16-byte pieces (c % 4 == 0) stay whole.
template <int W>
struct Tl {
  static constexpr int LD = W == 16 ? 24 : W;
  static constexpr int floats(int rows) { return rows * LD; }
  __device__ static __forceinline__ int at(int r, int c) {
    if constexpr (W == 16) return r * LD + c;
    else return r * W + (c ^ (((r ^ (r >> 2)) & 3) << 3));
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the stream tensors' element type (u, dy, B, C, du): float, or bf16
using bf16_t = __nv_bfloat16;

// stream values in a 16-byte piece
template <typename T>
constexpr int kPiece = 16 / (int)sizeof(T);

// one 16-byte piece of a stream row into an f32 tile in shared memory
// (zeros if !valid): f32 by cp.async as it is; bf16 read into registers
// and widened, its 8 values one 8-float block of the tile (whole under
// the swizzle), so every product reads f32 tiles in either entry
__device__ __forceinline__ void load_piece(float* dst, const float* src, bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void load_piece(float* dst, const bf16_t* src, bool valid) {
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (valid) x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

// two neighbouring values of a row of du, rounded once to its type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16_t* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// until at most n of this thread's copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// x = big + small: big is x with its low 13 bits cleared (its TF32 part),
// small = x - big, exact in f32; the tensor cores read small's TF32 part
// (ssd_scan.cu's split)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment (rows g, g + 8; k over (2t, 2t + 1)) split once
struct Frag {
  uint32_t big[4], small[4];
  __device__ __forceinline__ Frag(float x0, float x1, float x2, float x3) {
    split(x0, big[0], small[0]);
    split(x1, big[1], small[1]);
    split(x2, big[2], small[2]);
    split(x3, big[3], small[3]);
  }
};

// acc[i] += a b(i) at f32 accuracy for the output tiles i = lo .. K - 1 of
// one k-step (lo the same across the warp), b(i) tile i's B fragment (k 2t,
// 2t + 1; column g), split here: small*big, big*small, then big*big
template <int K, typename FB>
__device__ __forceinline__ void mma3_tiles(float (&acc)[K][4], const Frag& a,
                                           FB b, int lo = 0) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i >= lo) {
      const float2 v = b(i);
      uint32_t bb0, bs0, bb1, bs1;
      split(v.x, bb0, bs0);
      split(v.y, bb1, bs1);
      mma(acc[i], a.small, bb0, bb1);
      mma(acc[i], a.big, bs0, bs1);
      mma(acc[i], a.big, bb0, bb1);
    }
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// the A fragment of X stored [m][k] (a tile of width W): rows m0 + g,
// m0 + g + 8; k0 + 2t, k0 + 2t + 1
template <int W>
__device__ __forceinline__ Frag a_rows(const float* X, int m0, int k0) {
  const int g = lane_g(), t = lane_t();
  const float2 r0 = *reinterpret_cast<const float2*>(X + Tl<W>::at(m0 + g, k0 + 2 * t));
  const float2 r8 = *reinterpret_cast<const float2*>(X + Tl<W>::at(m0 + g + 8, k0 + 2 * t));
  return Frag(r0.x, r8.x, r0.y, r8.y);
}

// the A fragment of X stored [k][m], each value times f[k] (f null: 1)
template <int W>
__device__ __forceinline__ Frag a_cols(const float* X, int m0, int k0,
                                       const float* f = nullptr) {
  const int g = lane_g(), t = lane_t(), k = k0 + 2 * t;
  float x0 = X[Tl<W>::at(k, m0 + g)], x1 = X[Tl<W>::at(k, m0 + g + 8)];
  float x2 = X[Tl<W>::at(k + 1, m0 + g)], x3 = X[Tl<W>::at(k + 1, m0 + g + 8)];
  if (f != nullptr) {
    const float2 fv = *reinterpret_cast<const float2*>(f + k);
    x0 *= fv.x;
    x1 *= fv.x;
    x2 *= fv.y;
    x3 *= fv.y;
  }
  return Frag(x0, x1, x2, x3);
}

// the B fragment of Y stored [n][k]: (k0 + 2t, n0 + g), (k0 + 2t + 1, n0 + g)
template <int W>
__device__ __forceinline__ float2 b_rows(const float* Y, int n0, int k0) {
  return *reinterpret_cast<const float2*>(Y + Tl<W>::at(n0 + lane_g(), k0 + 2 * lane_t()));
}

// the B fragment of Y stored [k][n]
template <int W>
__device__ __forceinline__ float2 b_cols(const float* Y, int n0, int k0) {
  const int k = k0 + 2 * lane_t(), n = n0 + lane_g();
  return make_float2(Y[Tl<W>::at(k, n)], Y[Tl<W>::at(k + 1, n)]);
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
}

// L = cumsum(dt A log2 e) over a chunk (dt in shared memory), two steps a
// lane of one warp: (l0, l1) at steps 2 lane, 2 lane + 1, and L_QC
__device__ __forceinline__ void chunk_log_decay(const float* dtc, float a2,
                                                float2& dv, float& l0,
                                                float& l1, float& lend) {
  const int lane = threadIdx.x & 31;
  dv = *reinterpret_cast<const float2*>(dtc + 2 * lane);
  const float x0 = dv.x * a2, x1 = dv.y * a2;
  float incl = x0 + x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  l0 = excl + x0;
  l1 = l0 + x1;
  lend = __shfl_sync(0xffffffffu, l1, 31);
}

// ------------------------------------------------------------ 1. the states
template <int N, int HP>
struct StateCfg {
  static constexpr int XS = Tl<HP>::floats(QC);    // u or dy, [QC][HP]
  static constexpr int YS = Tl<N>::floats(QC);     // B or C, [QC][N]
  static constexpr int STAGE = XS + YS + QC;       // + dt
  // two stages, then each warp's factor (w or exp(L))
  static constexpr int kFloats = 2 * STAGE + NW * QC;
  static constexpr int PB = HP / 8;                // 8-column blocks of the state
  // the state's 16 x 8 tiles, TPW a warp, all in one 16-row block
  static constexpr int TILES = (N / 16) * PB;
  static constexpr int TPW = TILES >= NW ? TILES / NW : 1;
};

template <int N, int HP, typename TS>
__global__ void __launch_bounds__(NT)
ssd_bwd_states(const TS* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ A, const TS* __restrict__ Bm,
               const TS* __restrict__ Cm, const float* __restrict__ h0,
               const TS* __restrict__ dy, const float* __restrict__ dh,
               float* __restrict__ dh0, float* __restrict__ scratch, int S,
               int H) {
  using CF = StateCfg<N, HP>;
  constexpr int TPW = CF::TPW, PB = CF::PB, EP = kPiece<TS>;
  extern __shared__ __align__(16) float sm[];
  // adj 0: H_in, the chunks first to last; 1: dH, last to first
  const int hh = blockIdx.x, b = blockIdx.y, adj = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int T = (S + QC - 1) / QC;
  const float a2 = A[hh] * kLog2e;
  float* Fw = sm + 2 * CF::STAGE + warp * QC;   // this warp's w_s or exp(L_t)

  const size_t row = (size_t)H * HP;            // stride of a step in u, dy
  const TS* xb = (adj ? dy : u) + (size_t)b * S * row + (size_t)hh * HP;
  const TS* yb = (adj ? Cm : Bm) + (size_t)b * S * N;
  const float* db = dt + (size_t)b * S * H + hh;
  const size_t bh = (size_t)b * H + hh;
  float* out = scratch + ((size_t)adj * gridDim.y * H + bh) * T * N * HP;

  // this warp's tiles: rows 16 nb + (g, g + 8), columns 8 (pd0 + k) +
  // (2t, 2t + 1), in f32 registers across chunks
  const int tile0 = warp * TPW;
  const bool owns = tile0 < CF::TILES;
  const int nb = owns ? tile0 / PB : 0, pd0 = owns ? tile0 % PB : 0;
  const float* init = adj ? dh : h0;
  float st[TPW][4];
#pragma unroll
  for (int k = 0; k < TPW; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 16 * nb + g + 8 * (c >> 1), p = 8 * (pd0 + k) + 2 * t4 + (c & 1);
      st[k][c] = owns && init != nullptr ? init[bh * N * HP + (size_t)n * HP + p] : 0.f;
    }
  auto store_state = [&](float* dst) {
    if (!owns) return;
#pragma unroll
    for (int k = 0; k < TPW; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = 16 * nb + g + 8 * r, p = 8 * (pd0 + k) + 2 * t4;
        *reinterpret_cast<float2*>(dst + (size_t)n * HP + p) =
            make_float2(st[k][2 * r], st[k][2 * r + 1]);
      }
  };
  auto load_chunk = [&](int ck, int buf) {
    float* X = sm + buf * CF::STAGE;
    float* Y = X + CF::XS;
    float* Dc = Y + CF::YS;
    const int c0 = ck * QC;
    for (int i = tid; i < QC * HP / EP; i += NT) {
      const int r = i / (HP / EP), p = (i % (HP / EP)) * EP;
      const bool in = c0 + r < S;
      load_piece(X + Tl<HP>::at(r, p), xb + (in ? (size_t)(c0 + r) * row + p : 0), in);
    }
    for (int i = tid; i < QC * N / EP; i += NT) {
      const int r = i / (N / EP), n = (i % (N / EP)) * EP;
      const bool in = c0 + r < S;
      load_piece(Y + Tl<N>::at(r, n), yb + (in ? (size_t)(c0 + r) * N + n : 0), in);
    }
    for (int r = tid; r < QC; r += NT) {
      const bool in = c0 + r < S;
      cp_async4(Dc + r, db + (in ? (size_t)(c0 + r) * H : 0), in);
    }
    cp_async_commit();
  };

  // updates: through every chunk but the last (H_in), or every chunk but
  // the first unless dh0 is wanted (dH)
  const int updates = adj && dh0 != nullptr ? T : T - 1;
  if (updates > 0) load_chunk(adj ? T - 1 : 0, 0);
  for (int i = 0; i < T; ++i) {
    const int c = adj ? T - 1 - i : i;
    store_state(out + (size_t)c * N * HP);
    if (i >= updates) break;
    const int buf = i & 1;
    cp_async_wait<0>();        // this thread's copies of chunk c
    __syncthreads();           // everyone's; the other stage is read
    if (i + 1 < updates) load_chunk(adj ? c - 1 : c + 1, buf ^ 1);
    const float* X = sm + buf * CF::STAGE;
    const float* Y = X + CF::XS;
    float dq;
    {
      float2 dv;
      float l0, l1, lend;
      chunk_log_decay(Y + CF::YS, a2, dv, l0, l1, lend);
      *reinterpret_cast<float2*>(Fw + 2 * lane) =
          adj ? make_float2(exp2f(l0), exp2f(l1))
              : make_float2(exp2f(lend - l0) * dv.x, exp2f(lend - l1) * dv.y);
      dq = exp2f(lend);
    }
    __syncwarp();
    if (owns) {
#pragma unroll
      for (int k = 0; k < TPW; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) st[k][q] *= dq;
      // + (F Y)^T X: rows n, k over the chunk's steps
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const Frag a = a_cols<N>(Y, 16 * nb, 8 * j, Fw);
        mma3_tiles(st, a, [&](int k) { return b_cols<HP>(X, 8 * (pd0 + k), 8 * j); });
      }
    }
  }
  if (adj && dh0 != nullptr) store_state(dh0 + bh * N * HP);
}

// ------------------------------------------------------------ 2. the chunks
template <int N, int HP>
struct ChunkCfg {
  using TU = Tl<HP>;
  using TN = Tl<N>;
  using TQ = Tl<QC>;
  // offsets in floats
  static constexpr int U = 0;                           // u [QC][HP]
  static constexpr int DY = U + TU::floats(QC);         // dy [QC][HP]
  static constexpr int B = DY + TU::floats(QC);         // B [QC][N]
  static constexpr int C = B + TN::floats(QC);          // C [QC][N]
  static constexpr int HIN = C + TN::floats(QC);        // H_in [N][HP]
  static constexpr int DH = HIN + TU::floats(N);        // dH [N][HP], then G^T [QC][QC]
  static constexpr int DHG = TU::floats(N) > TQ::floats(QC) ? TU::floats(N)
                                                            : TQ::floats(QC);
  static constexpr int VEC = DH + DHG;                  // dt, L, e^L, e^(L_QC - L), w
  // f64 (an even float offset): sums over t by row s, Σ_n C V, Σ_n B R,
  // each warp's sums over s by column t, the block sums
  static constexpr int F64 = VEC + 5 * QC;
  static constexpr int kFloats = F64 + 2 * (3 * QC + NW * QC + 2 * NW);
  static_assert(F64 % 2 == 0, "f64 sums 8-byte aligned");
};

template <int N, int HP, typename TS>
__global__ void __launch_bounds__(NT, 2)
ssd_bwd_chunks(const TS* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ A, const TS* __restrict__ Bm,
               const TS* __restrict__ Cm, const float* __restrict__ D,
               const TS* __restrict__ dy, const float* __restrict__ scratch,
               TS* __restrict__ du, float* __restrict__ ddt,
               float* __restrict__ dAp, float* __restrict__ dBp,
               float* __restrict__ dCp, float* __restrict__ dDp, int S, int H) {
  using CF = ChunkCfg<N, HP>;
  using TU = typename CF::TU;
  using TN = typename CF::TN;
  using TQ = typename CF::TQ;
  constexpr int PB = HP / 8, NB = N / 8, EP = kPiece<TS>;
  extern __shared__ __align__(16) float sm[];
  float* Us = sm + CF::U;
  float* DYs = sm + CF::DY;
  float* Bs = sm + CF::B;
  float* Cs = sm + CF::C;
  float* HIN = sm + CF::HIN;
  float* DH = sm + CF::DH;
  float* GT = DH;                       // G^T, once dH is read
  float* DT = sm + CF::VEC;
  float* L2 = DT + QC;                  // L in log2 units
  float* EL = L2 + QC;                  // exp(L_t)
  float* DEC = EL + QC;                 // exp(L_QC - L_s)
  float* WS = DEC + QC;                 // exp(L_QC - L_s) dt_s
  double* COLY = reinterpret_cast<double*>(sm + CF::F64);   // Σ_t Y by s
  double* CV = COLY + QC;               // Σ_n C_t V_t
  double* Z = CV + QC;                  // exp(L_QC - L_s) Σ_n B_s R_s
  double* ROWP = Z + QC;                // [NW][QC]: a warp's Σ_s Y dt_s by t
  double* RED = ROWP + NW * QC;         // [2][NW]

  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int T = gridDim.x;
  const int t0 = c * QC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp;             // this warp's rows of the chunk
  const int jb = 2 * warp;              // its diagonal 8-step block
  const float Ah = A[hh], Dh = D[hh];
  const size_t row = (size_t)H * HP;
  const size_t bh = (size_t)b * H + hh;

  // ---- the chunk's tiles and its two states
  {
    const TS* ub = u + ((size_t)b * S + t0) * row + (size_t)hh * HP;
    const TS* yb = dy + ((size_t)b * S + t0) * row + (size_t)hh * HP;
    for (int i = tid; i < QC * HP / EP; i += NT) {
      const int r = i / (HP / EP), p = (i % (HP / EP)) * EP;
      const bool in = t0 + r < S;
      const size_t off = in ? (size_t)r * row + p : 0;
      load_piece(Us + TU::at(r, p), ub + off, in);
      load_piece(DYs + TU::at(r, p), yb + off, in);
    }
    const TS* bb = Bm + ((size_t)b * S + t0) * N;
    const TS* cb = Cm + ((size_t)b * S + t0) * N;
    for (int i = tid; i < QC * N / EP; i += NT) {
      const int r = i / (N / EP), n = (i % (N / EP)) * EP;
      const bool in = t0 + r < S;
      const size_t off = in ? (size_t)r * N + n : 0;
      load_piece(Bs + TN::at(r, n), bb + off, in);
      load_piece(Cs + TN::at(r, n), cb + off, in);
    }
    const float* db = dt + ((size_t)b * S + t0) * H + hh;
    for (int r = tid; r < QC; r += NT) {
      const bool in = t0 + r < S;
      cp_async4(DT + r, db + (in ? (size_t)r * H : 0), in);
    }
    cp_async_commit();                  // group 1: u, dy, B, C, dt
    const float* hin = scratch + (bh * T + c) * N * HP;
    const float* dhs = scratch + (((size_t)gridDim.z * H + bh) * T + c) * N * HP;
    for (int i = tid; i < N * HP / 4; i += NT) {
      const int n = i / (HP / 4), p = (i % (HP / 4)) * 4;
      cp_async16(HIN + TU::at(n, p), hin + (size_t)n * HP + p, true);
      cp_async16(DH + TU::at(n, p), dhs + (size_t)n * HP + p, true);
    }
    cp_async_commit();                  // group 2: H_in, dH
    cp_async_wait<1>();
    __syncthreads();                    // group 1 landed for every thread
  }
  // L (log2 units), exp(L), exp(L_QC - L), w: warp 0, two steps a lane
  if (warp == 0) {
    float2 dv;
    float l0, l1, lend;
    chunk_log_decay(DT, Ah * kLog2e, dv, l0, l1, lend);
    *reinterpret_cast<float2*>(L2 + 2 * lane) = make_float2(l0, l1);
    *reinterpret_cast<float2*>(EL + 2 * lane) = make_float2(exp2f(l0), exp2f(l1));
    const float e0 = exp2f(lend - l0), e1 = exp2f(lend - l1);
    *reinterpret_cast<float2*>(DEC + 2 * lane) = make_float2(e0, e1);
    *reinterpret_cast<float2*>(WS + 2 * lane) = make_float2(e0 * dv.x, e1 * dv.y);
  }
  __syncthreads();

  const int s0 = r0 + g, s1 = s0 + 8;   // this lane's rows
  // ---- S^T = B C^T and DYU^T = u dy^T on rows s, blocks t at or after
  // the diagonal; then M^T, G^T in place and Y's sums
  float sacc[SB][4], dacc[SB][4];
  zero(sacc);
  zero(dacc);
#pragma unroll 1
  for (int kk = 0; kk < N / 8; ++kk) {
    const Frag a = a_rows<N>(Bs, r0, 8 * kk);
    mma3_tiles(sacc, a, [&](int j) { return b_rows<N>(Cs, 8 * j, 8 * kk); }, jb);
  }
#pragma unroll 1
  for (int kk = 0; kk < HP / 8; ++kk) {
    const Frag a = a_rows<HP>(Us, r0, 8 * kk);
    mma3_tiles(dacc, a, [&](int j) { return b_rows<HP>(DYs, 8 * j, 8 * kk); }, jb);
  }
  {
    const float ls0 = L2[s0], ls1 = L2[s1], ds0 = DT[s0], ds1 = DT[s1];
    double cy0 = 0.0, cy1 = 0.0;        // Σ_t Y on rows s0, s1
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      if (j < jb) continue;
      const int ta = 8 * j + 2 * t4;    // this lane's columns ta, ta + 1
      const float2 lt = *reinterpret_cast<const float2*>(L2 + ta);
      float w[4];
      w[0] = ta >= s0 ? exp2f(lt.x - ls0) : 0.f;
      w[1] = ta + 1 >= s0 ? exp2f(lt.y - ls0) : 0.f;
      w[2] = ta >= s1 ? exp2f(lt.x - ls1) : 0.f;
      w[3] = ta + 1 >= s1 ? exp2f(lt.y - ls1) : 0.f;
      double cp0 = 0.0, cp1 = 0.0;      // Σ_s Y dt_s on columns ta, ta + 1
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ds = q < 2 ? ds0 : ds1;
        const float cbv = sacc[j][q], yu = dacc[j][q];
        const float wd = w[q] * ds;
        const float y = yu * cbv * w[q];
        sacc[j][q] = cbv * wd;          // M^T
        dacc[j][q] = yu * wd;           // G^T
        if (q < 2) cy0 += (double)y;
        else cy1 += (double)y;
        if (q & 1) cp1 = fma((double)y, (double)ds, cp1);
        else cp0 = fma((double)y, (double)ds, cp0);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cp0 += __shfl_xor_sync(0xffffffffu, cp0, o);
        cp1 += __shfl_xor_sync(0xffffffffu, cp1, o);
      }
      if (g == 0) {
        ROWP[warp * QC + ta] = cp0;
        ROWP[warp * QC + ta + 1] = cp1;
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      cy0 += __shfl_xor_sync(0xffffffffu, cy0, o);
      cy1 += __shfl_xor_sync(0xffffffffu, cy1, o);
    }
    if (t4 == 0) {
      COLY[s0] = cy0;
      COLY[s1] = cy1;
    }
  }

  cp_async_wait<0>();
  __syncthreads();                      // group 2 landed for every thread
  // <dH, H_in>: this thread's share (f64)
  double dotp = 0.0;
  for (int e = tid; e < N * HP; e += NT) {
    const int i = TU::at(e / HP, e % HP);
    dotp = fma((double)DH[i], (double)HIN[i], dotp);
  }

  const float ws0 = WS[s0], ws1 = WS[s1];
  double ddp = 0.0;                     // Σ dy u: this thread's share
  // ---- du = w (B dH) + M^T dy + D dy on rows s
  {
    float acc[PB][4];
    zero(acc);
#pragma unroll 1
    for (int kk = 0; kk < N / 8; ++kk) {
      const Frag a = a_rows<N>(Bs, r0, 8 * kk);
      mma3_tiles(acc, a, [&](int pb) { return b_cols<HP>(DH, 8 * pb, 8 * kk); });
    }
#pragma unroll
    for (int pb = 0; pb < PB; ++pb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[pb][q] *= q < 2 ? ws0 : ws1;
#pragma unroll
    for (int j = 0; j < SB; ++j)
      if (j >= jb) {
        const Frag a(sacc[j][0], sacc[j][2], sacc[j][1], sacc[j][3]);
        mma3_tiles(acc, a, [&](int pb) { return b_cols<HP>(DYs, 8 * pb, 8 * j); });
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = s0 + 8 * r;
#pragma unroll
      for (int pb = 0; pb < PB; ++pb) {
        const int p = 8 * pb + 2 * t4;
        const float2 yv = *reinterpret_cast<const float2*>(DYs + TU::at(s, p));
        const float2 uv = *reinterpret_cast<const float2*>(Us + TU::at(s, p));
        ddp = fma((double)yv.x, (double)uv.x, ddp);
        ddp = fma((double)yv.y, (double)uv.y, ddp);
        if (t0 + s < S)
          store2(du + (((size_t)b * S + t0 + s) * H + hh) * HP + p,
                 fmaf(Dh, yv.x, acc[pb][2 * r]), fmaf(Dh, yv.y, acc[pb][2 * r + 1]));
      }
    }
  }
  // ---- dB = w (u dH^T) + G^T C on rows s; z_s = e^(L_QC - L_s) Σ_n B R
  {
    float acc[NB][4];
    zero(acc);
#pragma unroll 1
    for (int kk = 0; kk < HP / 8; ++kk) {
      const Frag a = a_rows<HP>(Us, r0, 8 * kk);
      mma3_tiles(acc, a, [&](int nb) { return b_rows<HP>(DH, 8 * nb, 8 * kk); });
    }
    double z0 = 0.0, z1 = 0.0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = 8 * nb + 2 * t4;
      const float2 b0 = *reinterpret_cast<const float2*>(Bs + TN::at(s0, n));
      const float2 b1 = *reinterpret_cast<const float2*>(Bs + TN::at(s1, n));
      z0 = fma((double)b0.x, (double)acc[nb][0], z0);
      z0 = fma((double)b0.y, (double)acc[nb][1], z0);
      z1 = fma((double)b1.x, (double)acc[nb][2], z1);
      z1 = fma((double)b1.y, (double)acc[nb][3], z1);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      z0 += __shfl_xor_sync(0xffffffffu, z0, o);
      z1 += __shfl_xor_sync(0xffffffffu, z1, o);
    }
    if (t4 == 0) {
      Z[s0] = (double)DEC[s0] * z0;
      Z[s1] = (double)DEC[s1] * z1;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nb][q] *= q < 2 ? ws0 : ws1;
#pragma unroll
    for (int j = 0; j < SB; ++j)
      if (j >= jb) {
        const Frag a(dacc[j][0], dacc[j][2], dacc[j][1], dacc[j][3]);
        mma3_tiles(acc, a, [&](int nb) { return b_cols<N>(Cs, 8 * nb, 8 * j); });
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = s0 + 8 * r;
      if (t0 + s >= S) continue;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<float2*>(dBp + (bh * S + t0 + s) * N + 8 * nb + 2 * t4) =
            make_float2(acc[nb][2 * r], acc[nb][2 * r + 1]);
    }
  }
  __syncthreads();                      // every warp has read dH
  // G^T into dH's place: rows s, the blocks t at or after the diagonal
  // (the only ones dC's rows t >= s read)
#pragma unroll
  for (int j = 0; j < SB; ++j)
    if (j >= jb) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(GT + TQ::at(s0 + 8 * r, 8 * j + 2 * t4)) =
            make_float2(dacc[j][2 * r], dacc[j][2 * r + 1]);
    }
  __syncthreads();
  // ---- dC = exp(L) (dy H_in^T) + G B on rows t (= s0, s1 here)
  {
    float acc[NB][4];
    zero(acc);
#pragma unroll 1
    for (int kk = 0; kk < HP / 8; ++kk) {
      const Frag a = a_rows<HP>(DYs, r0, 8 * kk);
      mma3_tiles(acc, a, [&](int nb) { return b_rows<HP>(HIN, 8 * nb, 8 * kk); });
    }
    double v0 = 0.0, v1 = 0.0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = 8 * nb + 2 * t4;
      const float2 c0 = *reinterpret_cast<const float2*>(Cs + TN::at(s0, n));
      const float2 c1 = *reinterpret_cast<const float2*>(Cs + TN::at(s1, n));
      v0 = fma((double)c0.x, (double)acc[nb][0], v0);
      v0 = fma((double)c0.y, (double)acc[nb][1], v0);
      v1 = fma((double)c1.x, (double)acc[nb][2], v1);
      v1 = fma((double)c1.y, (double)acc[nb][3], v1);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, o);
      v1 += __shfl_xor_sync(0xffffffffu, v1, o);
    }
    if (t4 == 0) {
      CV[s0] = v0;
      CV[s1] = v1;
    }
    const float e0 = EL[s0], e1 = EL[s1];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nb][q] *= q < 2 ? e0 : e1;
#pragma unroll 1
    for (int j = 0; j <= jb + 1; ++j) {
      const Frag a = a_cols<QC>(GT, r0, 8 * j);
      mma3_tiles(acc, a, [&](int nb) { return b_cols<N>(Bs, 8 * nb, 8 * j); });
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = s0 + 8 * r;
      if (t0 + t >= S) continue;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<float2*>(dCp + (bh * S + t0 + t) * N + 8 * nb + 2 * t4) =
            make_float2(acc[nb][2 * r], acc[nb][2 * r + 1]);
    }
  }

  // ---- the block sums (f64: warps by butterflies, then in warp order);
  // each step's gradient of L, its reverse cumulative sum, ddt, dA
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    dotp += __shfl_xor_sync(0xffffffffu, dotp, o);
    ddp += __shfl_xor_sync(0xffffffffu, ddp, o);
  }
  if (lane == 0) {
    RED[warp] = dotp;
    RED[NW + warp] = ddp;
  }
  __syncthreads();                      // and COLY, CV, Z, ROWP
  if (warp == 0) {
    double dot = 0.0, dsum = 0.0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      dot += RED[w];
      dsum += RED[NW + w];
    }
    double dl[2], dtd[2], dtz[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int t = 2 * lane + q;
      double rowy = 0.0;
      for (int w = 0; w <= t / 16; ++w) rowy += ROWP[w * QC + t];
      const double dtt = DT[t], z = Z[t], col = COLY[t];
      dl[q] = rowy - dtt * col + (double)EL[t] * CV[t] - dtt * z;
      dtd[q] = col + z;
      dtz[q] = dtt * z;
    }
    double zs = dtz[0] + dtz[1];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) zs += __shfl_xor_sync(0xffffffffu, zs, o);
    // the chunk's last step also takes the exit state's terms
    if (lane == 31) dl[1] += (double)EL[QC - 1] * dot + zs;
    double s = dl[0] + dl[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_down_sync(0xffffffffu, s, o);
      if (lane + o < 32) s += v;
    }
    double ex = __shfl_down_sync(0xffffffffu, s, 1);
    if (lane == 31) ex = 0.0;
    const double dla1 = ex + dl[1], dla0 = dla1 + dl[0];
    const int ta = t0 + 2 * lane;
    if (ta < S)
      ddt[((size_t)b * S + ta) * H + hh] = (float)fma((double)Ah, dla0, dtd[0]);
    if (ta + 1 < S)
      ddt[((size_t)b * S + ta + 1) * H + hh] = (float)fma((double)Ah, dla1, dtd[1]);
    double da = fma((double)DT[2 * lane], dla0, 0.0);
    da = fma((double)DT[2 * lane + 1], dla1, da);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
    if (lane == 0) {
      dAp[bh * T + c] = (float)da;
      dDp[bh * T + c] = (float)dsum;
    }
  }
}

template <int N, int HP, typename TS>
cudaError_t launch(const TS* u, const float* dt, const float* A,
                   const TS* Bm, const TS* Cm, const float* D,
                   const float* h0, const TS* dy, const float* dh,
                   TS* du, float* ddt, float* dAp, float* dBp, float* dCp,
                   float* dDp, float* dh0, float* scratch, int B, int S,
                   int H, cudaStream_t stream) {
  const int T = (S + QC - 1) / QC;
  const size_t smem1 = sizeof(float) * StateCfg<N, HP>::kFloats;
  const size_t smem2 = sizeof(float) * ChunkCfg<N, HP>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states<N, HP, TS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_chunks<N, HP, TS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  ssd_bwd_states<N, HP, TS><<<dim3(H, B, 2), NT, smem1, stream>>>(
      u, dt, A, Bm, Cm, h0, dy, dh, dh0, scratch, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunks<N, HP, TS><<<dim3(T, H, B), NT, smem2, stream>>>(
      u, dt, A, Bm, Cm, D, dy, scratch, du, ddt, dAp, dBp, dCp, dDp, S, H);
  return cudaGetLastError();
}

// CTAs of each kernel an SM (the occupancy calculator, with the kernel's
// dynamic shared memory): which 0 the states, 1 the chunks; -1 on an error
template <int N, int HP, typename TS>
int occupancy(int which) {
  const size_t smem = sizeof(float) * (which == 0 ? StateCfg<N, HP>::kFloats
                                                  : ChunkCfg<N, HP>::kFloats);
  const void* fn = which == 0 ? (const void*)ssd_bwd_states<N, HP, TS>
                              : (const void*)ssd_bwd_chunks<N, HP, TS>;
  int n = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, NT, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

template <int N, int HP>
int smem_bytes(int which) {
  return (int)sizeof(float) * (which == 0 ? StateCfg<N, HP>::kFloats
                                          : ChunkCfg<N, HP>::kFloats);
}

// every built (N, hp)
#define SSD_BWD_PAIRS(X) \
  X(16, 16) X(16, 32) X(16, 64) X(32, 16) X(32, 32) X(32, 64) X(64, 16) \
  X(64, 32) X(64, 64)

template <typename TS>
int ctas_per_sm(int N, int hp, int which) {
#define SSD_BWD_CASE(n, p) \
  if (N == n && hp == p) return occupancy<n, p, TS>(which);
  SSD_BWD_PAIRS(SSD_BWD_CASE)
#undef SSD_BWD_CASE
  return 0;
}

template <typename TS>
int run(const TS* u, const float* dt, const float* A, const TS* Bm,
        const TS* Cm, const float* D, const float* h0, const TS* dy,
        const float* dh, TS* du, float* ddt, float* dAp, float* dBp,
        float* dCp, float* dDp, float* dh0, float* scratch, int B, int S,
        int H, int N, int hp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SSD_BWD_CASE(n, p)                                                     \
  if (N == n && hp == p)                                                       \
    return (int)launch<n, p, TS>(u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp, \
                                dBp, dCp, dDp, dh0, scratch, B, S, H, st);
  SSD_BWD_PAIRS(SSD_BWD_CASE)
#undef SSD_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int ssd_scan_bwd_chunk() { return QC; }

// shared memory of the state kernel (which 0) or the chunk kernel (1) at
// (N, hp), bytes (either entry: both keep f32 tiles); 0 if not built
int ssd_scan_bwd_kernel_smem_bytes(int N, int hp, int which) {
#define SSD_BWD_CASE(n, p) \
  if (N == n && hp == p) return smem_bytes<n, p>(which);
  SSD_BWD_PAIRS(SSD_BWD_CASE)
#undef SSD_BWD_CASE
  return 0;
}

// CTAs an SM of the f32 entry's state kernel (which 0) or chunk kernel (1)
// at (N, hp) on the current device (0 if not built, -1 on a CUDA error);
// the bf16 entry's likewise
int ssd_scan_bwd_ctas_per_sm(int N, int hp, int which) {
  return ctas_per_sm<float>(N, hp, which);
}
int ssd_scan_bwd_bf16_ctas_per_sm(int N, int hp, int which) {
  return ctas_per_sm<bf16_t>(N, hp, which);
}

// Inputs as ssd_scan_f32's, dy (B,S,H,hp) and dh (B,H,N,hp) or null; du
// (B,S,H,hp), ddt (B,S,H); dAp, dDp (B,H,ceil(S / 64)), one partial a
// (batch, head, chunk); dBp, dCp (B,H,S,N), one partial a (batch, head);
// dh0 (B,H,N,hp) or null; scratch (2, B, H, ceil(S / 64), N, hp): the
// states entering and the adjoints leaving each chunk. All float32,
// contiguous, on the device; N and hp each 16, 32 or 64. Two kernels on
// the stream. Returns a cudaError_t (0 on success).
int ssd_scan_bwd_f32(const float* u, const float* dt, const float* A,
                     const float* Bm, const float* Cm, const float* D,
                     const float* h0, const float* dy, const float* dh,
                     float* du, float* ddt, float* dAp, float* dBp,
                     float* dCp, float* dDp, float* dh0, float* scratch,
                     int B, int S, int H, int N, int hp, void* stream) {
  return run<float>(u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp, dBp, dCp,
                    dDp, dh0, scratch, B, S, H, N, hp, stream);
}

// The backward of ssd_scan_bf16: as ssd_scan_bwd_f32, but u, B, C, dy and
// du bf16 (du rounded once from its f32 sum; the partials of dB and dC stay
// f32, for the caller to sum and round).
int ssd_scan_bwd_bf16(const bf16_t* u, const float* dt, const float* A,
                      const bf16_t* Bm, const bf16_t* Cm, const float* D,
                      const float* h0, const bf16_t* dy, const float* dh,
                      bf16_t* du, float* ddt, float* dAp, float* dBp,
                      float* dCp, float* dDp, float* dh0, float* scratch,
                      int B, int S, int H, int N, int hp, void* stream) {
  return run<bf16_t>(u, dt, A, Bm, Cm, D, h0, dy, dh, du, ddt, dAp, dBp, dCp,
                     dDp, dh0, scratch, B, S, H, N, hp, stream);
}

}  // extern "C"
