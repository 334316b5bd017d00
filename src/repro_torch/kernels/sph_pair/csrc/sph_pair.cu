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
// density_pair: one CTA per pair task and one (C x C) distance tile in shared
// memory; thread t reduces row t and column t. Per pair the inputs are read
// once (C slots of 12 f32) and about 100 f32 operations are done per element
// of the tile; as executed, over the whole padded tile, it is bound by
// operations on the CUDA cores (the K = 3 contraction is no tensor-core
// shape). Counted on live slots only the bytes bound it. Its redesign (live
// slots only, several pairs a CTA, the gather through ci/cj fused into the
// loads) is later work.
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
// into an FMA: every operation rounds where the plain version's eager PyTorch
// ops round, and the cutoff tests (w > 0, r < max(h_i, h_j), r < h) see the
// same r bits. The double-float momentum contraction needs TwoProd to be exact:
// it is written p = a*b, e = fmaf(a, b, -p) (an explicit FMA, exact), which
// equals the reference's Dekker split bit for bit. Both directions contract
// the same g and r_hat bits (an element is a pure function of its (i, j)
// inputs), which keeps each pair's momentum exchange antisymmetric to the f32
// output-rounding floor (Newton's third law).
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream and returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr float kCubicNorm = (float)(8.0 / 3.14159265358979323846);
constexpr float kWendlandNorm = (float)(21.0 / (2.0 * 3.14159265358979323846));
constexpr int kThreads = 128;

__device__ __forceinline__ float cube(float x) { return x * (x * x); }
__device__ __forceinline__ float pow4(float x) { float x2 = x * x; return x2 * x2; }

// 0: cubic spline, 1: Wendland C2 (support radius h, as repro/sph/smoothing.py)
template <int KERNEL>
__device__ __forceinline__ float w_fn(float r, float h) {
  const float q = r / h;
  if (KERNEL == 0) {
    const float sigma = kCubicNorm / ((h * h) * h);
    const float w1 = (1.0f - (6.0f * q) * q) + ((6.0f * q) * q) * q;
    const float w2 = 2.0f * cube(1.0f - q);
    const float w = (q <= 0.5f) ? w1 : w2;
    return (q < 1.0f) ? sigma * w : 0.0f;
  } else {
    const float sigma = kWendlandNorm / ((h * h) * h);
    const float w = pow4(1.0f - q) * ((4.0f * q) + 1.0f);
    return (q < 1.0f) ? sigma * w : 0.0f;
  }
}

// dW/dr's normalisation, a function of h alone (force_pair computes it once
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

// ------------------------------------------------------------------ density
template <int KERNEL>
__global__ void __launch_bounds__(kThreads)
density_pair_kernel(const float* __restrict__ pos_i, const float* __restrict__ h_i,
                    const float* __restrict__ m_i, const float* __restrict__ mask_i,
                    const float* __restrict__ pos_j, const float* __restrict__ h_j,
                    const float* __restrict__ m_j, const float* __restrict__ mask_j,
                    float* __restrict__ rho_i, float* __restrict__ drho_i,
                    float* __restrict__ nngb_i, float* __restrict__ rho_j,
                    float* __restrict__ drho_j, float* __restrict__ nngb_j, int C) {
  extern __shared__ float sm[];
  const int S = C | 1;                 // odd row stride: no bank conflicts on rows
  float* r = sm;                       // C x S
  float* xi = r + C * S;               // C x 3
  float* xj = xi + 3 * C;
  float* hi = xj + 3 * C;
  float* hj = hi + C;
  float* mwi = hj + C;                 // m * mask
  float* mwj = mwi + C;
  float* ki = mwj + C;                 // mask
  float* kj = ki + C;
  float* sqi = kj + C;
  float* sqj = sqi + C;

  const size_t base = (size_t)blockIdx.x * C;
  for (int t = threadIdx.x; t < 3 * C; t += blockDim.x) {
    xi[t] = pos_i[base * 3 + t];
    xj[t] = pos_j[base * 3 + t];
  }
  for (int t = threadIdx.x; t < C; t += blockDim.x) {
    hi[t] = h_i[base + t];
    hj[t] = h_j[base + t];
    ki[t] = mask_i[base + t];
    kj[t] = mask_j[base + t];
    mwi[t] = m_i[base + t] * ki[t];
    mwj[t] = m_j[base + t] * kj[t];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < C; t += blockDim.x) {
    sqi[t] = sq3(xi + 3 * t);
    sqj[t] = sq3(xj + 3 * t);
  }
  __syncthreads();

  // phase 1: the distance tile, shared by both directions
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int i = e / C, j = e - (e / C) * C;
    const float r2 = dot_r2(sqi[i], sqj[j], xi + 3 * i, xj + 3 * j);
    r[i * S + j] = sqrtf(r2 + kEps);
  }
  __syncthreads();

  // phase 2: row reductions (i <- j) and column reductions (j <- i)
  for (int it = threadIdx.x; it < 2 * C; it += blockDim.x) {
    const bool row = it < C;
    const int a = row ? it : it - C;
    const float h = row ? hi[a] : hj[a];
    const float* mw = row ? mwj : mwi;
    const float* kk = row ? kj : ki;
    float rho = 0.0f, drho = 0.0f, nn = 0.0f;
    for (int b = 0; b < C; ++b) {
      const float rr = row ? r[a * S + b] : r[b * S + a];
      const float w = w_fn<KERNEL>(rr, h);
      rho = rho + mw[b] * w;
      const float dwdh = -((3.0f * w) + rr * dwdr_fn<KERNEL>(rr, h)) / h;
      drho = drho + mw[b] * dwdh;
      nn = nn + (w > 0.0f ? 1.0f : 0.0f) * kk[b];
    }
    if (row) {
      rho_i[base + a] = rho;
      drho_i[base + a] = drho;
      nngb_i[base + a] = nn;
    } else {
      rho_j[base + a] = rho;
      drho_j[base + a] = drho;
      nngb_j[base + a] = nn;
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

template <typename K>
int launch_force(K kernel, const ForceArgs& args, cudaStream_t stream) {
  // fewer pairs a CTA only where a capacity's slots outgrow shared memory
  int warps = kThreads / 32;
  const size_t per_warp = sizeof(float) * 2 * kSideFloats * (size_t)args.C;
  while (warps > 1 && warps * per_warp > kSmemLimit) warps >>= 1;
  const size_t smem = warps * per_warp;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  int rc;
  if ((rc = set_smem(kernel, smem))) return rc;
  kernel<<<(args.P + warps - 1) / warps, 32 * warps, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// shared memory of one density_pair CTA at capacity C
size_t sph_density_pair_smem(int C) {
  const int S = C | 1;
  return sizeof(float) * ((size_t)C * S + 14 * (size_t)C);
}

int sph_density_pair(const float* pos_i, const float* h_i, const float* m_i,
                     const float* mask_i, const float* pos_j, const float* h_j,
                     const float* m_j, const float* mask_j, float* rho_i,
                     float* drho_i, float* nngb_i, float* rho_j, float* drho_j,
                     float* nngb_j, int P, int C, int kernel, void* stream) {
  if (P == 0) return 0;
  const size_t smem = sph_density_pair_smem(C);
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (kernel == 0) {
    if ((rc = set_smem(density_pair_kernel<0>, smem))) return rc;
    density_pair_kernel<0><<<P, kThreads, smem, s>>>(
        pos_i, h_i, m_i, mask_i, pos_j, h_j, m_j, mask_j, rho_i, drho_i, nngb_i,
        rho_j, drho_j, nngb_j, C);
  } else {
    if ((rc = set_smem(density_pair_kernel<1>, smem))) return rc;
    density_pair_kernel<1><<<P, kThreads, smem, s>>>(
        pos_i, h_i, m_i, mask_i, pos_j, h_j, m_j, mask_j, rho_i, drho_i, nngb_i,
        rho_j, drho_j, nngb_j, C);
  }
  return (int)cudaGetLastError();
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
