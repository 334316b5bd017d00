// Hopper (sm_90a) kernels for SPH cell-pair interactions.
//
// Replaces the Pallas TPU kernels of repro/kernels/sph_pair/kernel.py:
//   density_pair  <- density_pair_pallas (kernel.py:132, body _density_kernel :103)
//   force_pair    <- force_pair_pallas   (kernel.py:224, bodies _force_kernel :157,
//                                         _df_weighted_contract :61, _two_sum :39,
//                                         _two_prod :47)
//
// Both kernels give both directions of a pair: row i (the i-side outputs) and
// column j (the j-side outputs), each reduced over the other side's slots in
// ascending order, as the plain PyTorch version (../ref.py) does.
//
// density_pair: one warp per pair task, four pairs a CTA, the design of
// force_pair below fitted to the density's element (about 100 f32
// operations: a square root, two IEEE divisions, W and dW/dr). The first
// version (one CTA per pair, the whole C x C distance tile in shared memory,
// every element computed) ran at 5 % of its bound, and the eight (P, C[, 3])
// blocks it read were gathered through ci/cj by separate passes (590 MB at
// Sedov 64^3). Now the warp finds each side's live end L by ballot and stages
// slots [0, L) of both sides ((x, y, z, |x|^2) as one 16-byte load, then
// m * mask, mask and h). A lane takes a slot, a row (the i-side) or a column
// (the j-side), live slots first, and marks in a cheap pass over the other
// side's live slots the elements that may lie within its own h (a superset
// test on the dot-form r^2, with force_pair's margin) and computes just
// those, in ascending order. At Sedov 64^3 a lane marks 0 to ~30 elements,
// so in that phase 68 % of lane slots wait on the busiest lane; spreading
// the warp's marked elements over its lanes (each one's terms handed back
// through shared memory to its slot's lane) was measured slower, as were
// two lanes a slot and two elements a step (tools/kernel_variants.py,
// PERF.md): the time is not in idle issue slots. The gather is fused into
// the loads: side i of pair p is cell ci[p], side j cell cj[p] with shift[p]
// added to its positions as they are read (one f32 add a component, as the
// plain gather adds it); an index outside [0, ncells) stops the kernel with
// a device-side assertion, as index_select's own check does on the card.
// The block entry passes no indices (row p of its blocks) and no shift.
// What it must move is then the cell arrays once
// (21 MB at Sedov 64^3) and its six (P, C) outputs (295 MB), which set its
// bound.
//
// Why the skipped terms change no bit (finite inputs). Slot a's sums run
// from +0 over the other side's slots b in ascending order, adding
// (m mask)_b W_ab, (m mask)_b dW/dh_ab and [W_ab > 0] mask_b. An element out
// of reach (q = r / h_a >= 1) has W = +0 and dW/dr = +0, so
// dW/dh = -(3 * 0 + r * 0) / h_a = -0 (h_a > 0), and its terms are +-0, +-0
// and +0; a dead partner (b >= L: mask 0, so m * mask = +-0) gives +-0 terms
// too. A sum that starts at +0 never becomes -0 (a rounded sum is -0 only
// when both addends are), and x + (+-0) = x for every other x: leaving such
// terms out keeps each sum's bits. The test is a superset: q < 1 needs
// r = sqrtf(r2 + eps) < h, so r2 + eps < h^2 < (h * h) * 1.000001f whatever
// the roundings (2^-22 relative against a margin of 1e-6); h <= 0 marks
// every element, and an element marked needlessly adds its own exact zeros.
// Slots past L are dead, and get their outputs as the plain version gives
// them: their sums over the other side's live slots within their own h. As
// r >= sqrtf(eps), a slot with 0 < h <= sqrtf(eps) (the engine pads with
// h = 1e-6) has no partner within reach, and its outputs are +0 without a
// pass. Slots below L with mask 0 (holes) are live slots with m * mask = 0.
// Factors of h alone (W's and dW/dr's normalisations) are computed once a
// slot, as the same expressions. Shared memory is about 2 * 7 * C floats a
// warp, so any C up to 4,150 runs (fewer pairs a CTA above C = 1,037).
//
// force_pair: one warp per pair task, four pairs a CTA, eight CTAs an SM.
// What bounded the first version (one CTA per pair, all C^2 elements of eight
// C x C shared tiles, 57 KB at C = 40, four CTAs an SM, C <= 83) was dead
// work: at Sedov 64^3 a pair holds ~144 live elements of 1,600, and only
// ~26 of those lie within reach (r < max(h_i, h_j)). Live slots are a prefix
// of each cell (a particle's slot is its rank in its cell), so the warp finds
// each side's live end L (one past the last nonzero mask) with a ballot and
// stages slots [0, L) of both sides (14 floats a slot). One lane takes each
// live row and each live column: a cheap pass over the other side's live
// slots marks the elements within reach (a superset test on the dot-form
// r^2), and the lane computes just those, in ascending order, recomputing an
// element for its own direction. Every other term is an exact zero (g = +0,
// the energy and viscous terms +-0): the plain sums keep their bits, and a
// run of such steps leaves the double-float sum as one renormalisation
// (df_renormalise) does. Slots past L are dead; a dead slot still gets its
// outputs as the plain version gives them: dv = -0 (i-side) or +0 (j-side),
// du = coef * (its energy sum over live partners within its own h) + 0, and
// a slot with h <= sqrt(eps) (the engine's padding) has no such partner.
// Shared memory is 2 * 14 * C floats a warp, so any C up to 2,075 runs (fewer
// pairs a CTA above C = 518). The least time for the work is set by the
// bytes (live slots' inputs, every slot's mask and outputs); as executed,
// the time goes to issuing the cutoff pass and the ~240 f32 operations
// (eight of them IEEE divisions) of each element within reach, unevenly
// spread over the lanes. Times on the H100: PERF.md and chip_smoke.py.
//
// Rounding. The file is compiled with --fmad=false, so no a*b+c is contracted
// into an FMA, and '/' and sqrtf are IEEE (no fast math): every operation
// rounds where the plain version's eager PyTorch ops round, in its order,
// and the cutoff tests (w > 0, q < 1, r < max(h_i, h_j), r < h) see the same
// r bits. No atomics: each output is written once, by one lane. The double-float momentum contraction needs TwoProd to be exact:
// it is written p = a*b, e = fmaf(a, b, -p) (an explicit FMA, exact), which
// equals the reference's Dekker split bit for bit. Both directions contract
// the same g and r_hat bits (an element is a pure function of its (i, j)
// inputs), which keeps each pair's momentum exchange antisymmetric to the f32
// output-rounding floor (Newton's third law).
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns the cudaError_t of the launch (0 on success).

#include <cassert>

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr float kCubicNorm = (float)(8.0 / 3.14159265358979323846);
constexpr float kWendlandNorm = (float)(21.0 / (2.0 * 3.14159265358979323846));
constexpr int kThreads = 128;

__device__ __forceinline__ float cube(float x) { return x * (x * x); }
__device__ __forceinline__ float pow4(float x) { float x2 = x * x; return x2 * x2; }

// W(r, h) given sigma = W's normalisation at h (a function of h alone);
// 0: cubic spline, 1: Wendland C2 (support radius h, as repro/sph/smoothing.py)
template <int KERNEL>
__device__ __forceinline__ float w_sig(float r, float h, float sigma) {
  const float q = r / h;
  float w;
  if (KERNEL == 0) {
    const float w1 = (1.0f - (6.0f * q) * q) + ((6.0f * q) * q) * q;
    const float w2 = 2.0f * cube(1.0f - q);
    w = (q <= 0.5f) ? w1 : w2;
  } else {
    w = pow4(1.0f - q) * ((4.0f * q) + 1.0f);
  }
  return (q < 1.0f) ? sigma * w : 0.0f;
}

// dW/dr's normalisation, a function of h alone (both kernels compute it once
// per slot)
template <int KERNEL>
__device__ __forceinline__ float dwdr_norm(float h) {
  return (KERNEL == 0 ? kCubicNorm : kWendlandNorm) / pow4(h);
}

// dW/dr(r, h) given sigma = dwdr_norm(h)
template <int KERNEL>
__device__ __forceinline__ float dwdr_sig(float r, float h, float sigma) {
  const float q = r / h;
  float d;
  if (KERNEL == 0) {
    const float d1 = (-12.0f * q) + (18.0f * q) * q;
    const float omq = 1.0f - q;
    const float d2 = -6.0f * (omq * omq);
    d = (q <= 0.5f) ? d1 : d2;
  } else {
    d = (-20.0f * q) * cube(1.0f - q);
  }
  return (q < 1.0f) ? sigma * d : 0.0f;
}

template <int KERNEL>
__device__ __forceinline__ float dwdr_fn(float r, float h) {
  return dwdr_sig<KERNEL>(r, h, dwdr_norm<KERNEL>(h));
}

// r^2 in the reference's dot form, max(., 0) keeping NaN as torch.clamp_min does
__device__ __forceinline__ float dot_r2(float sqi, float sqj, const float* xi,
                                        const float* xj) {
  const float cross = (xi[0] * xj[0] + xi[1] * xj[1]) + xi[2] * xj[2];
  const float r2 = (sqi + sqj) - 2.0f * cross;
  return (r2 < 0.0f) ? 0.0f : r2;
}

__device__ __forceinline__ float sq3(const float* x) {
  return (x[0] * x[0] + x[1] * x[1]) + x[2] * x[2];
}

// one step of the double-float sum: (s_hi, s_lo) += w * g * rh, exactly as
// _df_weighted_contract's TwoProd / TwoSum / renormalise sequence
__device__ __forceinline__ void df_accumulate(float w, float g, float rh,
                                              float& s_hi, float& s_lo) {
  const float p1 = w * g;
  const float e1 = fmaf(w, g, -p1);
  const float p2 = p1 * rh;
  const float e2 = fmaf(p1, rh, -p2);
  const float lo = e2 + e1 * rh;
  const float s = s_hi + p2;
  const float bb = s - s_hi;
  float e = (s_hi - (s - bb)) + (p2 - bb);
  e = e + (s_lo + lo);
  const float s2 = s + e;
  s_lo = e - (s2 - s);
  s_hi = s2;
}

// df_accumulate with a zero product (w or g zero, r_hat finite): s = s_hi
// (s_hi is never -0), and what is left renormalises (s_hi, s_lo). After one
// such step the pair is normalised, so a run of them equals one.
__device__ __forceinline__ void df_renormalise(float& s_hi, float& s_lo) {
  const float e = s_lo + 0.0f;
  const float s2 = s_hi + e;
  s_lo = e - (s2 - s_hi);
  s_hi = s2;
}

// One past the last slot whose mask is nonzero (0 for an empty cell): every
// slot from there on is dead. Called by the whole warp.
__device__ __forceinline__ int live_end(const float* mask, int C, int lane) {
  int L = 0;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int s = c0 + lane;
    const unsigned b = __ballot_sync(0xffffffffu, s < C && mask[s] != 0.0f);
    if (b) L = c0 + 32 - __clz((int)b);
  }
  return L;
}

// ------------------------------------------------------------------ density
// Where each side's slots lie: side i of pair p is row ci[p] of the i-side
// slot arrays, side j row cj[p] of the j-side ones (row p where the index is
// null: the block entry, whose arrays are gathered already; the fused
// entry's indices lie in [0, ncells)). The j-side's positions get shift[p]
// added as they are read (no add where it is null).
struct DensityArgs {
  const float *pos_i, *h_i, *m_i, *mask_i;   // (rows, C, 3) and (rows, C)
  const float *pos_j, *h_j, *m_j, *mask_j;
  const int *ci, *cj;                        // (P,) or null
  const float* shift;                        // (P, 3) or null
  float *rho_i, *drho_i, *nngb_i, *rho_j, *drho_j, *nngb_j;   // (P, C)
  int P, C, ncells;
};

constexpr int kDensityWarps = 4;   // pairs a CTA (fewer where C outgrows shared memory)
// floats of one side's staged slots: pos and |x|^2 (one 16-byte load a
// partner), then m * mask, mask and h, padded to 16 bytes
__host__ __device__ __forceinline__ int dside_floats(int C) {
  return 4 * C + 4 * ((3 * C + 3) / 4);
}

struct DSide {   // one side's live slots, staged in the warp's shared memory
  float4* x;     // (x, y, z, |x|^2)
  float *mw, *k, *h;
};

__device__ __forceinline__ DSide dside_at(float* base, int C) {
  DSide s;
  s.x = reinterpret_cast<float4*>(base);
  s.mw = base + 4 * C;
  s.k = s.mw + C;
  s.h = s.k + C;
  return s;
}

// slots [0, L) of the slot row starting at `base`, positions shifted by
// (s0, s1, s2) when `shifted`
__device__ __forceinline__ void dstage(const DSide& s, const float* pos, const float* h,
                                       const float* m, const float* mask, size_t base,
                                       int L, bool shifted, float s0, float s1,
                                       float s2, int lane) {
  for (int t = lane; t < L; t += 32) {
    const float* xt = pos + (base + t) * 3;
    float4 x = make_float4(xt[0], xt[1], xt[2], 0.0f);
    if (shifted) x.x = x.x + s0, x.y = x.y + s1, x.z = x.z + s2;
    x.w = (x.x * x.x + x.y * x.y) + x.z * x.z;
    s.x[t] = x;
    const float k = mask[base + t];
    s.h[t] = h[base + t];
    s.k[t] = k;
    s.mw[t] = m[base + t] * k;
  }
}

// r^2 between an own slot x = (x, y, z, |x|^2) and partner b of Q, as dot_r2
__device__ __forceinline__ float r2_to(float4 x, const DSide& Q, int b) {
  const float4 xp = Q.x[b];
  const float cross = (x.x * xp.x + x.y * xp.y) + x.z * xp.z;
  const float r2 = (x.w + xp.w) - 2.0f * cross;
  return (r2 < 0.0f) ? 0.0f : r2;
}

// The three terms element (own slot x, partner b of Q) adds to the slot's
// sums, as _density_chunk forms them: (m mask)_b W, (m mask)_b dW/dh and
// [W > 0] mask_b; sw and sd are W's and dW/dr's normalisations at h.
template <int KERNEL>
__device__ __forceinline__ float4 density_terms(float4 x, float h, float sw, float sd,
                                                const DSide& Q, int b) {
  const float r = sqrtf(r2_to(x, Q, b) + kEps);
  const float w = w_sig<KERNEL>(r, h, sw);
  const float mw = Q.mw[b];
  return make_float4(mw * w, mw * (-((3.0f * w) + r * dwdr_sig<KERNEL>(r, h, sd)) / h),
                     (w > 0.0f ? 1.0f : 0.0f) * Q.k[b], 0.0f);
}

__device__ __forceinline__ void add3(float4& sum, float4 t) {
  sum.x = sum.x + t.x;
  sum.y = sum.y + t.y;
  sum.z = sum.z + t.z;
}

// One warp per pair task, blockDim.x / 32 pairs per CTA; each warp stages its
// pair's live slots in its own part of shared memory and synchronises only
// itself. Tasks: the live rows (i-side slots below Li), the live columns
// (j-side slots below Lj), then the dead rows and columns, 32 a round. In
// each round the warp steps through the partners 32 at a time; each lane
// marks its slot's elements in a segment and computes them.
template <int KERNEL>
__global__ void __launch_bounds__(32 * kDensityWarps) density_pair_kernel(const DensityArgs a) {
  extern __shared__ float4 dsm[];
  const int C = a.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= a.P) return;   // the whole warp leaves; there is no CTA barrier
  const int ci = a.ci ? a.ci[p] : p, cj = a.cj ? a.cj[p] : p;
  assert((unsigned)ci < (unsigned)a.ncells && (unsigned)cj < (unsigned)a.ncells);
  const size_t bi = (size_t)ci * C, bj = (size_t)cj * C;
  const bool shifted = a.shift != nullptr;
  const float s0 = shifted ? a.shift[3 * p] : 0.0f;
  const float s1 = shifted ? a.shift[3 * p + 1] : 0.0f;
  const float s2 = shifted ? a.shift[3 * p + 2] : 0.0f;
  float* scratch = reinterpret_cast<float*>(dsm) + (size_t)warp * 2 * dside_floats(C);
  const DSide I = dside_at(scratch, C);
  const DSide J = dside_at(scratch + dside_floats(C), C);
  const int Li = live_end(a.mask_i + bi, C, lane);
  const int Lj = live_end(a.mask_j + bj, C, lane);
  dstage(I, a.pos_i, a.h_i, a.m_i, a.mask_i, bi, Li, false, 0.0f, 0.0f, 0.0f, lane);
  dstage(J, a.pos_j, a.h_j, a.m_j, a.mask_j, bj, Lj, shifted, s0, s1, s2, lane);
  __syncwarp();

  for (int t0 = 0; t0 < 2 * C; t0 += 32) {
    const int t = t0 + lane;
    const bool live = t < Li + Lj;
    const bool row = t < Li || (!live && t < C + Lj);
    const int own = t < Li ? t : live ? t - Li : row ? t - Lj : t - C;
    const DSide O = row ? I : J, Q = row ? J : I;   // by value: pointers in registers
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float h = 1.0f, sw = 0.0f, sd = 0.0f;
    int n = 0;
    if (t < 2 * C) {
      h = live ? O.h[own] : (row ? a.h_i + bi : a.h_j + bj)[own];
      // r >= sqrtf(eps): a slot with 0 < h <= sqrtf(eps) (the engine pads
      // with h = 1e-6) has no partner within reach
      n = (h > 0.0f && h <= sqrtf(kEps)) ? 0 : (row ? Lj : Li);
      if (live) {
        x = O.x[own];
      } else if (n) {
        const float* pos = (row ? a.pos_i + 3 * bi : a.pos_j + 3 * bj) + 3 * own;
        x = make_float4(pos[0], pos[1], pos[2], 0.0f);
        if (!row && shifted) x.x = x.x + s0, x.y = x.y + s1, x.z = x.z + s2;
        x.w = (x.x * x.x + x.y * x.y) + x.z * x.z;
      }
    }
    if (n) {   // functions of h alone, the same expressions as the plain version's
      sw = (KERNEL == 0 ? kCubicNorm : kWendlandNorm) / ((h * h) * h);
      sd = dwdr_norm<KERNEL>(h);
    }
    // q < 1 needs r = sqrtf(r2 + eps) < h, so r2 + eps < h^2 < reach
    const float reach = h > 0.0f ? (h * h) * 1.000001f : __int_as_float(0x7f800000);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // rho, drho, nngb
    const int nmax = __reduce_max_sync(0xffffffffu, n);
    for (int b0 = 0; b0 < nmax; b0 += 32) {
      unsigned hit = 0;
      const int m = min(32, n - b0);
      for (int k = 0; k < m; ++k)
        if (r2_to(x, Q, b0 + k) + kEps < reach) hit |= 1u << k;
      for (; hit; hit &= hit - 1)
        add3(sum, density_terms<KERNEL>(x, h, sw, sd, Q, b0 + __ffs((int)hit) - 1));
    }
    if (t < 2 * C) {
      const size_t q = (size_t)p * C + own;
      (row ? a.rho_i : a.rho_j)[q] = sum.x;
      (row ? a.drho_i : a.drho_j)[q] = sum.y;
      (row ? a.nngb_i : a.nngb_j)[q] = sum.z;
    }
  }
}

// -------------------------------------------------------------------- force
struct ForceArgs {
  const float *pos_i, *vel_i, *h_i, *press_i, *rho_i, *om_i, *cs_i, *m_i, *mask_i;
  const float *pos_j, *vel_j, *h_j, *press_j, *rho_j, *om_j, *cs_j, *m_j, *mask_j;
  float *dv_i, *du_i, *dv_j, *du_j;
  int P, C;
  float alpha, neg_alpha, beta;
};

// floats of one side's staged slots per unit of C: pos and vel (3 each), then
// h, P / (omega rho^2), rho, cs, m, mask, |x|^2 and dW/dr's normalisation
constexpr int kSideFloats = 14;

struct Side {   // one side's live slots, staged in the warp's shared memory
  float *x, *v, *h, *co, *rho, *cs, *m, *k, *sq, *sg;
};

__device__ __forceinline__ Side side_at(float* base, int C) {
  Side s;
  s.x = base;
  s.v = s.x + 3 * C;
  s.h = s.v + 3 * C;
  s.co = s.h + C;
  s.rho = s.co + C;
  s.cs = s.rho + C;
  s.m = s.cs + C;
  s.k = s.m + C;
  s.sq = s.k + C;
  s.sg = s.sq + C;
  return s;
}

// slots [0, L) of one side of the pair starting at slot `base`
template <int KERNEL>
__device__ __forceinline__ void stage(const Side& s, const float* pos, const float* vel,
                                      const float* h, const float* press,
                                      const float* rho, const float* om,
                                      const float* cs, const float* m,
                                      const float* mask, size_t base, int L,
                                      int lane) {
  for (int t = lane; t < 3 * L; t += 32) {
    s.x[t] = pos[base * 3 + t];
    s.v[t] = vel[base * 3 + t];
  }
  for (int t = lane; t < L; t += 32) {
    const size_t o = base + t;
    const float r = rho[o];
    s.h[t] = h[o];
    s.rho[t] = r;
    s.co[t] = press[o] / (om[o] * (r * r));
    s.cs[t] = cs[o];
    s.m[t] = m[o];
    s.k[t] = mask[o];
    s.sg[t] = dwdr_norm<KERNEL>(h[o]);
  }
  __syncwarp();
  for (int t = lane; t < L; t += 32) s.sq[t] = sq3(s.x + 3 * t);
}

// everything element (i, j) gives either direction: the momentum weight g,
// r_hat, and each side's energy and viscous-heating terms
struct Elem {
  float g, rx, ry, rz, ti, tj, vi, vj;
};

template <int KERNEL, bool VISC>
__device__ __forceinline__ Elem element(const Side& I, int i, const Side& J, int j,
                                        const ForceArgs& a) {
  const float* pi = I.x + 3 * i;
  const float* pj = J.x + 3 * j;
  const float r2 = dot_r2(I.sq[i], J.sq[j], pi, pj);
  const float r = sqrtf(r2 + kEps);
  const float dx0 = pi[0] - pj[0], dx1 = pi[1] - pj[1], dx2 = pi[2] - pj[2];
  Elem e;
  e.rx = dx0 / r;
  e.ry = dx1 / r;
  e.rz = dx2 / r;
  const float hi = I.h[i], hj = J.h[j];
  const float ki = I.k[i], kj = J.k[j];
  const float mi = I.m[i], mj = J.m[j];
  const float dwi = dwdr_sig<KERNEL>(r, hi, I.sg[i]);
  const float dwj = dwdr_sig<KERNEL>(r, hj, J.sg[j]);
  float fmag = I.co[i] * dwi + J.co[j] * dwj;
  const float sep = (r2 > kEps) ? 1.0f : 0.0f;
  const float valid = ((ki * kj) * (r < fmaxf(hi, hj) ? 1.0f : 0.0f)) * sep;
  const float* vi = I.v + 3 * i;
  const float* vj = J.v + 3 * j;
  const float dv0 = vi[0] - vj[0], dv1 = vi[1] - vj[1], dv2 = vi[2] - vj[2];
  const float vdotrhat = (dv0 * e.rx + dv1 * e.ry) + dv2 * e.rz;
  e.vi = 0.0f;
  e.vj = 0.0f;
  if (VISC) {
    const float vdotr = (dv0 * dx0 + dv1 * dx1) + dv2 * dx2;
    const float hbar = 0.5f * (hi + hj);
    const float rhobar = 0.5f * (I.rho[i] + J.rho[j]);
    const float csbar = 0.5f * (I.cs[i] + J.cs[j]);
    float mu = (hbar * vdotr) / (r2 + (0.01f * hbar) * hbar);
    mu = (vdotr < 0.0f) ? mu : 0.0f;
    const float piij = ((a.neg_alpha * csbar) * mu + (a.beta * mu) * mu) / rhobar;
    const float dwbar = 0.5f * (dwi + dwj);
    fmag = fmag + piij * dwbar;
    const float vr = vdotr / r;
    e.vi = (((mj * valid) * piij) * dwbar) * vr;
    e.vj = (((mi * valid) * piij) * dwbar) * vr;
  }
  e.g = ((valid > 0.0f) ? fmag : 0.0f) * valid;
  const float vui = (kj * (r < hi ? 1.0f : 0.0f)) * sep;
  const float vuj = (ki * (r < hj ? 1.0f : 0.0f)) * sep;
  e.ti = ((mj * vui) * vdotrhat) * dwi;
  e.tj = ((mi * vuj) * vdotrhat) * dwj;
  return e;
}

// One warp per pair task, blockDim.x / 32 pairs per CTA; each warp stages its
// pair's live slots in its own part of shared memory and synchronises only
// itself.
template <int KERNEL, bool VISC>
__global__ void __launch_bounds__(kThreads, 8) force_pair_kernel(const ForceArgs a) {
  extern __shared__ float sm[];
  const int C = a.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= a.P) return;   // the whole warp leaves; there is no CTA barrier
  const size_t base = (size_t)p * C;
  const Side I = side_at(sm + (size_t)warp * 2 * kSideFloats * C, C);
  const Side J = side_at(I.x + kSideFloats * C, C);
  const int Li = live_end(a.mask_i + base, C, lane);
  const int Lj = live_end(a.mask_j + base, C, lane);
  stage<KERNEL>(I, a.pos_i, a.vel_i, a.h_i, a.press_i, a.rho_i, a.om_i, a.cs_i,
                a.m_i, a.mask_i, base, Li, lane);
  stage<KERNEL>(J, a.pos_j, a.vel_j, a.h_j, a.press_j, a.rho_j, a.om_j, a.cs_j,
                a.m_j, a.mask_j, base, Lj, lane);
  __syncwarp();

  // rows i < Li (the i-side) and columns j < Lj (the j-side): a lane each,
  // over the other side's slots below its live end, in ascending order. Only
  // elements with r2 > eps and r < max(h_i, h_j) (~18 % at Sedov 64^3) can
  // give a nonzero term: each lane marks them in a cheap pass over a segment
  // of 32 partners, then computes just those. Every other element has g = +0
  // and zero energy and viscous terms; the plain sums stay as they are, and a
  // run of such steps leaves the double-float sum as one step does.
  for (int t = lane; t < Li + Lj; t += 32) {
    const bool row = t < Li;
    const int own = row ? t : t - Li;
    const int n = row ? Lj : Li;
    const float* w = row ? J.m : I.m;
    float h0 = 0.0f, l0 = 0.0f, h1 = 0.0f, l1 = 0.0f, h2 = 0.0f, l2 = 0.0f;
    float st = 0.0f, sv = 0.0f;
    int next = 0;   // the partners below `next` are in the sums
    for (int s0 = 0; s0 < n; s0 += 32) {
      unsigned hit = 0;
      const int m = min(32, n - s0);
      for (int k = 0; k < m; ++k) {
        const int i = row ? own : s0 + k, j = row ? s0 + k : own;
        const float r2 = dot_r2(I.sq[i], J.sq[j], I.x + 3 * i, J.x + 3 * j);
        const float hm = fmaxf(I.h[i], J.h[j]);
        // r = sqrtf(r2 + eps) < hm implies r2 + eps < hm^2 (1 + 2^-22); the
        // margin of 1e-6 makes this a superset whatever the roundings
        if (r2 > kEps && r2 + kEps < (hm * hm) * 1.000001f) hit |= 1u << k;
      }
      while (hit) {
        const int b = s0 + __ffs((int)hit) - 1;
        hit &= hit - 1;
        if (b > next) {
          df_renormalise(h0, l0);
          df_renormalise(h1, l1);
          df_renormalise(h2, l2);
        }
        const Elem e = element<KERNEL, VISC>(I, row ? own : b, J, row ? b : own, a);
        df_accumulate(w[b], e.g, e.rx, h0, l0);
        df_accumulate(w[b], e.g, e.ry, h1, l1);
        df_accumulate(w[b], e.g, e.rz, h2, l2);
        st = st + (row ? e.ti : e.tj);
        if (VISC) sv = sv + (row ? e.vi : e.vj);
        next = b + 1;
      }
    }
    if (n > next) {
      df_renormalise(h0, l0);
      df_renormalise(h1, l1);
      df_renormalise(h2, l2);
    }
    const float visc = VISC ? 0.5f * sv : 0.0f;
    const size_t q = base + own;
    if (row) {
      a.dv_i[3 * q] = -(h0 + l0);
      a.dv_i[3 * q + 1] = -(h1 + l1);
      a.dv_i[3 * q + 2] = -(h2 + l2);
      a.du_i[q] = I.co[own] * st + visc;
    } else {
      a.dv_j[3 * q] = h0 + l0;
      a.dv_j[3 * q + 1] = h1 + l1;
      a.dv_j[3 * q + 2] = h2 + l2;
      a.du_j[q] = J.co[own] * st + visc;
    }
  }

  // dead rows (i >= Li) and columns (j >= Lj). Their mask is 0, so g and the
  // viscous terms of every element are zeros: the double-float sums stay
  // (+0, +0) and the viscous sum +0. Only the energy term of a live partner
  // within the dead slot's own h can be nonzero.
  const int di = C - Li;
  for (int t = lane; t < di + (C - Lj); t += 32) {
    const bool row = t < di;
    const int own = row ? Li + t : Lj + (t - di);
    const size_t o = base + own;
    const float h = (row ? a.h_i : a.h_j)[o];
    const float rho = (row ? a.rho_i : a.rho_j)[o];
    const float co = (row ? a.press_i : a.press_j)[o] /
                     ((row ? a.om_i : a.om_j)[o] * (rho * rho));
    const Side S = row ? J : I;   // by value: the pointers stay in registers
    // r = sqrtf(r2 + eps) >= sqrtf(eps): a slot with h at or below that (the
    // engine pads with h = 1e-6) has no partner within its h
    const int n = h > sqrtf(kEps) ? (row ? Lj : Li) : 0;
    float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
    if (n) {
      const float* pos = (row ? a.pos_i : a.pos_j) + 3 * o;
      const float* vel = (row ? a.vel_i : a.vel_j) + 3 * o;
      x0 = pos[0], x1 = pos[1], x2 = pos[2];
      v0 = vel[0], v1 = vel[1], v2 = vel[2];
    }
    const float sq = (x0 * x0 + x1 * x1) + x2 * x2;
    float st = 0.0f;
    for (int b = 0; b < n; ++b) {
      const float* xp = S.x + 3 * b;
      const float cross = (x0 * xp[0] + x1 * xp[1]) + x2 * xp[2];
      float r2 = (sq + S.sq[b]) - 2.0f * cross;
      r2 = (r2 < 0.0f) ? 0.0f : r2;
      const float r = sqrtf(r2 + kEps);
      const float kp = S.k[b];
      if (r2 > kEps && r < h && kp != 0.0f) {
        const float* vp = S.v + 3 * b;
        // the element's orientation: i minus j
        const float dx0 = row ? x0 - xp[0] : xp[0] - x0;
        const float dx1 = row ? x1 - xp[1] : xp[1] - x1;
        const float dx2 = row ? x2 - xp[2] : xp[2] - x2;
        const float dv0 = row ? v0 - vp[0] : vp[0] - v0;
        const float dv1 = row ? v1 - vp[1] : vp[1] - v1;
        const float dv2 = row ? v2 - vp[2] : vp[2] - v2;
        const float rx = dx0 / r, ry = dx1 / r, rz = dx2 / r;
        const float vdotrhat = (dv0 * rx + dv1 * ry) + dv2 * rz;
        const float vu = (kp * 1.0f) * 1.0f;
        st = st + ((S.m[b] * vu) * vdotrhat) * dwdr_fn<KERNEL>(r, h);
      }
    }
    float* dv = (row ? a.dv_i : a.dv_j) + 3 * o;
    const float z = row ? -0.0f : 0.0f;
    dv[0] = z;
    dv[1] = z;
    dv[2] = z;
    (row ? a.du_i : a.du_j)[o] = co * st + 0.0f;
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

constexpr size_t kSmemLimit = 232448;   // bytes of shared memory a CTA may use

// One warp a pair, `warps` pairs a CTA, each warp with `per_warp` bytes of
// shared memory: fewer pairs a CTA only where a capacity's slots outgrow it.
template <typename K, typename A>
int launch_warps(K kernel, const A& args, int warps, size_t per_warp,
                 cudaStream_t stream) {
  while (warps > 1 && warps * per_warp > kSmemLimit) warps >>= 1;
  const size_t smem = warps * per_warp;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  int rc;
  if ((rc = set_smem(kernel, smem))) return rc;
  kernel<<<(args.P + warps - 1) / warps, 32 * warps, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename K>
int launch_force(K kernel, const ForceArgs& args, cudaStream_t stream) {
  return launch_warps(kernel, args, kThreads / 32,
                      sizeof(float) * 2 * kSideFloats * (size_t)args.C, stream);
}

template <typename K>
int launch_density(K kernel, const DensityArgs& args, cudaStream_t stream) {
  return launch_warps(kernel, args, kDensityWarps,
                      sizeof(float) * 2 * (size_t)dside_floats(args.C), stream);
}

}  // namespace

extern "C" {

// Both density entries: the block entry passes gathered (P, C[, 3]) blocks
// as the i- and j-side arrays with ci, cj and shift null (ncells = P); the
// fused entry passes the cell arrays (ncells rows) as both sides, with the
// pair list.
int sph_density_pair(const float* pos_i, const float* h_i, const float* m_i,
                     const float* mask_i, const float* pos_j, const float* h_j,
                     const float* m_j, const float* mask_j, const int* ci,
                     const int* cj, const float* shift, float* rho_i, float* drho_i,
                     float* nngb_i, float* rho_j, float* drho_j, float* nngb_j, int P,
                     int C, int ncells, int kernel, void* stream) {
  if (P == 0) return 0;
  DensityArgs args{pos_i, h_i, m_i, mask_i, pos_j, h_j, m_j, mask_j, ci, cj, shift,
                   rho_i, drho_i, nngb_i, rho_j, drho_j, nngb_j, P, C, ncells};
  cudaStream_t s = (cudaStream_t)stream;
  if (kernel == 0) return launch_density(density_pair_kernel<0>, args, s);
  return launch_density(density_pair_kernel<1>, args, s);
}

int sph_force_pair(const float* pos_i, const float* vel_i, const float* h_i,
                   const float* press_i, const float* rho_i, const float* om_i,
                   const float* cs_i, const float* m_i, const float* mask_i,
                   const float* pos_j, const float* vel_j, const float* h_j,
                   const float* press_j, const float* rho_j, const float* om_j,
                   const float* cs_j, const float* m_j, const float* mask_j,
                   float* dv_i, float* du_i, float* dv_j, float* du_j, int P, int C,
                   int kernel, float alpha, float neg_alpha, float beta,
                   void* stream) {
  if (P == 0) return 0;
  ForceArgs args{pos_i, vel_i, h_i, press_i, rho_i, om_i, cs_i, m_i, mask_i,
                 pos_j, vel_j, h_j, press_j, rho_j, om_j, cs_j, m_j, mask_j,
                 dv_i, du_i, dv_j, du_j, P, C, alpha, neg_alpha, beta};
  cudaStream_t s = (cudaStream_t)stream;
  const bool visc = alpha > 0.0f;
  if (kernel == 0 && visc) return launch_force(force_pair_kernel<0, true>, args, s);
  if (kernel == 0) return launch_force(force_pair_kernel<0, false>, args, s);
  if (visc) return launch_force(force_pair_kernel<1, true>, args, s);
  return launch_force(force_pair_kernel<1, false>, args, s);
}

}  // extern "C"
