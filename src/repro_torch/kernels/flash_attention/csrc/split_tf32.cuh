// Split-TF32 helpers shared by the f32 flash attention kernels, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu): 16-byte
// cp.async, the TF32 split x = big + small, mma.sync m16n8k8 in TF32 and its
// three-product f32-accurate form, the A fragment of a row-major tile with
// the k index over (2t, 2t + 1) pairs, and the base-2 scaled score with an
// optional soft-cap. Included inside each file's anonymous namespace.
#pragma once

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (+ what lies below small's 11 bits)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at f32 accuracy: the two cross terms, then big * big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

// A fragment of Q's 16 x 8 block at k-step kk for rows (g, g + 8) of `qrow`
// (row g's first float): the k index runs over (2t, 2t + 1)
__device__ __forceinline__ void q_fragment(const float* qrow, int ld, uint32_t (&fb)[4],
                                           uint32_t (&fs)[4]) {
  const float2 r0 = *reinterpret_cast<const float2*>(qrow);
  const float2 r8 = *reinterpret_cast<const float2*>(qrow + 8 * ld);
  split(r0.x, fb[0], fs[0]);
  split(r8.x, fb[1], fs[1]);
  split(r0.y, fb[2], fs[2]);
  split(r8.y, fb[3], fs[3]);
}

// a scaled score in base 2: x * scale * log2(e), soft-capped first if CAP
template <bool CAP>
__device__ __forceinline__ float score2(float x, float scale2, float scale,
                                        float cap) {
  if constexpr (CAP) return cap * tanhf(x * scale / cap) * 1.44269504f;
  else return x * scale2;
}

// a row's natural log-sum-exp from its base-2 online-softmax state (running
// max m, normaliser l of exp2(s - m)): (m + log2 l) ln 2; +inf for a row
// with no live key (l = 0), so that exp(s - lse) is 0 on all its keys
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * 0.69314718055994531f : INFINITY;
}
