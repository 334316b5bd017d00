// Hopper (sm_90a) kernels for SPH cell-pair interactions.
//
// Replaces the Pallas TPU kernels of repro/kernels/sph_pair/kernel.py:
//   density_pair  <- density_pair_pallas (kernel.py:132, body _density_kernel :103)
//   force_pair    <- force_pair_pallas   (kernel.py:224, bodies _force_kernel :157,
//                                         _df_weighted_contract :61, _two_sum :39,
//                                         _two_prod :47)
//
// One CTA per pair task. Both directions of the pair come from one (C x C)
// interaction tile: thread t reduces row t (the i-side outputs) and column t
// (the j-side outputs), each over the pair's slots in ascending order, as the
// plain PyTorch version (../ref.py) does.
//
// What bounds them on an H100: per pair the inputs are read once (C slots of
// 12 f32 for density, 26 for force) and about 100 (density) or 240 (force) f32
// operations are done per element of the C^2 tile. As executed, over the whole
// padded tile (C = 40), that is compute-bound against the 67 TFLOP/s f32 peak;
// the K = 3 contraction is not a tensor-core shape, so everything runs on the
// CUDA cores. Counted on live slots only (Sedov 64^3: mean occupancy 11.9 of
// 40), the work falls below the bytes moved, so the least time for the work is
// the bytes' (chip_smoke.py reports both). This first version is written to be
// right: each tile lives in shared memory, a CTA handles one pair and computes
// its dead slots too. Making it fast (several pairs per CTA, live slots only,
// the gather through ci/cj fused into the loads) is later work.
//
// Rounding. The file is compiled with --fmad=false, so no a*b+c is contracted
// into an FMA: every operation rounds where the plain version's eager PyTorch
// ops round, and the cutoff tests (w > 0, r < max(h_i, h_j), r < h) see the
// same r bits. The double-float momentum contraction needs TwoProd to be exact:
// it is written p = a*b, e = fmaf(a, b, -p) (an explicit FMA, exact), which
// equals the reference's Dekker split bit for bit. Both directions contract
// the same g and r_hat bits, which keeps each pair's momentum exchange
// antisymmetric to the f32 output-rounding floor (Newton's third law).
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

template <int KERNEL>
__device__ __forceinline__ float dwdr_fn(float r, float h) {
  const float q = r / h;
  const float sigma = (KERNEL == 0 ? kCubicNorm : kWendlandNorm) / pow4(h);
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
  int C;
  float alpha, neg_alpha, beta;
};

template <int KERNEL, bool VISC>
__global__ void __launch_bounds__(kThreads) force_pair_kernel(const ForceArgs a) {
  extern __shared__ float sm[];
  const int C = a.C;
  const int S = C | 1;
  const int T = C * S;
  float* g = sm;                       // momentum weight g_ij (masked)
  float* rh0 = g + T;                  // r_hat_ij, one tile per component
  float* rh1 = rh0 + T;
  float* rh2 = rh1 + T;
  float* ti = rh2 + T;                 // i-side energy terms (pressure)
  float* tj = ti + T;                  // j-side energy terms (pressure)
  float* vi_ = tj + T;                 // i-side viscous heating terms
  float* vj_ = vi_ + T;                // j-side viscous heating terms
  float* xi = vj_ + T;                 // C x 3
  float* xj = xi + 3 * C;
  float* vi = xj + 3 * C;
  float* vj = vi + 3 * C;
  float* hi = vj + 3 * C;
  float* hj = hi + C;
  float* coi = hj + C;                 // P / (omega * rho^2)
  float* coj = coi + C;
  float* rhoi = coj + C;
  float* rhoj = rhoi + C;
  float* csi = rhoj + C;
  float* csj = csi + C;
  float* mi = csj + C;
  float* mj = mi + C;
  float* ki = mj + C;
  float* kj = ki + C;
  float* sqi = kj + C;
  float* sqj = sqi + C;

  const size_t base = (size_t)blockIdx.x * C;
  for (int t = threadIdx.x; t < 3 * C; t += blockDim.x) {
    xi[t] = a.pos_i[base * 3 + t];
    xj[t] = a.pos_j[base * 3 + t];
    vi[t] = a.vel_i[base * 3 + t];
    vj[t] = a.vel_j[base * 3 + t];
  }
  for (int t = threadIdx.x; t < C; t += blockDim.x) {
    const size_t o = base + t;
    hi[t] = a.h_i[o];
    hj[t] = a.h_j[o];
    rhoi[t] = a.rho_i[o];
    rhoj[t] = a.rho_j[o];
    coi[t] = a.press_i[o] / (a.om_i[o] * (rhoi[t] * rhoi[t]));
    coj[t] = a.press_j[o] / (a.om_j[o] * (rhoj[t] * rhoj[t]));
    csi[t] = a.cs_i[o];
    csj[t] = a.cs_j[o];
    mi[t] = a.m_i[o];
    mj[t] = a.m_j[o];
    ki[t] = a.mask_i[o];
    kj[t] = a.mask_j[o];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < C; t += blockDim.x) {
    sqi[t] = sq3(xi + 3 * t);
    sqj[t] = sq3(xj + 3 * t);
  }
  __syncthreads();

  // phase 1: every element of the interaction tile
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int i = e / C, j = e - (e / C) * C;
    const float* pi = xi + 3 * i;
    const float* pj = xj + 3 * j;
    const float r2 = dot_r2(sqi[i], sqj[j], pi, pj);
    const float r = sqrtf(r2 + kEps);
    const float dx0 = pi[0] - pj[0], dx1 = pi[1] - pj[1], dx2 = pi[2] - pj[2];
    const float rx = dx0 / r, ry = dx1 / r, rz = dx2 / r;
    const float dwi = dwdr_fn<KERNEL>(r, hi[i]);
    const float dwj = dwdr_fn<KERNEL>(r, hj[j]);
    float fmag = coi[i] * dwi + coj[j] * dwj;
    const float sep = (r2 > kEps) ? 1.0f : 0.0f;
    const float valid = ((ki[i] * kj[j]) * (r < fmaxf(hi[i], hj[j]) ? 1.0f : 0.0f)) * sep;
    const float dv0 = vi[3 * i] - vj[3 * j];
    const float dv1 = vi[3 * i + 1] - vj[3 * j + 1];
    const float dv2 = vi[3 * i + 2] - vj[3 * j + 2];
    const float vdotrhat = (dv0 * rx + dv1 * ry) + dv2 * rz;
    float visc_i = 0.0f, visc_j = 0.0f;
    if (VISC) {
      const float vdotr = (dv0 * dx0 + dv1 * dx1) + dv2 * dx2;
      const float hbar = 0.5f * (hi[i] + hj[j]);
      const float rhobar = 0.5f * (rhoi[i] + rhoj[j]);
      const float csbar = 0.5f * (csi[i] + csj[j]);
      float mu = (hbar * vdotr) / (r2 + (0.01f * hbar) * hbar);
      mu = (vdotr < 0.0f) ? mu : 0.0f;
      const float piij = ((a.neg_alpha * csbar) * mu + (a.beta * mu) * mu) / rhobar;
      const float dwbar = 0.5f * (dwi + dwj);
      fmag = fmag + piij * dwbar;
      const float vr = vdotr / r;
      visc_i = (((mj[j] * valid) * piij) * dwbar) * vr;
      visc_j = (((mi[i] * valid) * piij) * dwbar) * vr;
    }
    const int o = i * S + j;
    g[o] = ((valid > 0.0f) ? fmag : 0.0f) * valid;
    rh0[o] = rx;
    rh1[o] = ry;
    rh2[o] = rz;
    const float vui = (kj[j] * (r < hi[i] ? 1.0f : 0.0f)) * sep;
    const float vuj = (ki[i] * (r < hj[j] ? 1.0f : 0.0f)) * sep;
    ti[o] = ((mj[j] * vui) * vdotrhat) * dwi;
    tj[o] = ((mi[i] * vuj) * vdotrhat) * dwj;
    vi_[o] = visc_i;
    vj_[o] = visc_j;
  }
  __syncthreads();

  // phase 2: row t (dv_i, du_i) and column t (dv_j, du_j)
  for (int it = threadIdx.x; it < 2 * C; it += blockDim.x) {
    const bool row = it < C;
    const int p = row ? it : it - C;
    const float* w = row ? mj : mi;
    float h0 = 0.0f, l0 = 0.0f, h1 = 0.0f, l1 = 0.0f, h2 = 0.0f, l2 = 0.0f;
    float st = 0.0f, sv = 0.0f;
    for (int b = 0; b < C; ++b) {
      const int o = row ? p * S + b : b * S + p;
      const float gv = g[o];
      df_accumulate(w[b], gv, rh0[o], h0, l0);
      df_accumulate(w[b], gv, rh1[o], h1, l1);
      df_accumulate(w[b], gv, rh2[o], h2, l2);
      st = st + (row ? ti[o] : tj[o]);
      if (VISC) sv = sv + (row ? vi_[o] : vj_[o]);
    }
    const float visc = VISC ? 0.5f * sv : 0.0f;
    const size_t q = base + p;
    if (row) {
      a.dv_i[3 * q] = -(h0 + l0);
      a.dv_i[3 * q + 1] = -(h1 + l1);
      a.dv_i[3 * q + 2] = -(h2 + l2);
      a.du_i[q] = coi[p] * st + visc;
    } else {
      a.dv_j[3 * q] = h0 + l0;
      a.dv_j[3 * q + 1] = h1 + l1;
      a.dv_j[3 * q + 2] = h2 + l2;
      a.du_j[q] = coj[p] * st + visc;
    }
  }
}

template <typename K>
int launch(K kernel, int P, size_t smem, cudaStream_t stream, const ForceArgs& args) {
  kernel<<<P, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

// shared memory of one CTA at capacity C (the layouts of the kernels above)
size_t sph_density_pair_smem(int C) {
  const int S = C | 1;
  return sizeof(float) * ((size_t)C * S + 14 * (size_t)C);
}

size_t sph_force_pair_smem(int C) {
  const int S = C | 1;
  return sizeof(float) * (8 * (size_t)C * S + 26 * (size_t)C);
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
                 dv_i, du_i, dv_j, du_j, C, alpha, neg_alpha, beta};
  const size_t smem = sph_force_pair_smem(C);
  cudaStream_t s = (cudaStream_t)stream;
  const bool visc = alpha > 0.0f;
  int rc;
  if (kernel == 0 && visc) {
    if ((rc = set_smem(force_pair_kernel<0, true>, smem))) return rc;
    return launch(force_pair_kernel<0, true>, P, smem, s, args);
  } else if (kernel == 0) {
    if ((rc = set_smem(force_pair_kernel<0, false>, smem))) return rc;
    return launch(force_pair_kernel<0, false>, P, smem, s, args);
  } else if (visc) {
    if ((rc = set_smem(force_pair_kernel<1, true>, smem))) return rc;
    return launch(force_pair_kernel<1, true>, P, smem, s, args);
  } else {
    if ((rc = set_smem(force_pair_kernel<1, false>, smem))) return rc;
    return launch(force_pair_kernel<1, false>, P, smem, s, args);
  }
}

}  // extern "C"
