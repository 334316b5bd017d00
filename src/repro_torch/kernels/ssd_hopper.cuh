// Helpers of the SSD scan's TMA + wgmma kernels, shared by the forward
// (ssd_scan/csrc/ssd_scan.cu: ssd_bf16_hopper) and its backward
// (ssd_scan/csrc/ssd_scan_bwd.cu: ssd_bwd_states_bf16_hopper,
// ssd_bwd_chunks_bf16_hopper): the mbarrier waits, the wgmma forms of a
// 64 x 64 f32 accumulator from bf16 operands, the split of f32 values into
// bf16 pieces and the 128-byte swizzle of a 64 x 64 bf16 tile. Included
// after hopper.cuh, through the -I of repro_torch/kernels/build.py's
// NVCC_FLAGS.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// the same, trapping after ~10 s: only the producer warps' waits are timed
// (ptxas of CUDA 12.9 fails with a segmentation fault on ssd_bf16_hopper
// when the consumers' waits carry the clock test, inlined or not); what
// they cover is in each kernel's header comment
__device__ __forceinline__ void mbar_wait_timed(uint32_t bar, uint32_t parity) {
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

// the consumer warpgroup's 128 threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

#define SSD_ACC32                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])
#define SSD_D32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"

// D (64 x 64, f32) {=, +=} A B, A (64 x 16) and B (16 x 64) bf16 in shared
// memory; TA, TB: 0 K-major, 1 MN-major (the transpose forms)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SSD_ACC32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) += A B, A bf16 in registers (a wgmma accumulator's
// layout, two 8-column blocks a k-step), B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SSD_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
#undef SSD_ACC32
#undef SSD_D32

// two f32 rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xFFFF0000u);
}

// (lo, hi) as NP bf16 pairs whose sum is (lo, hi) to within 2^-8NP: piece k
// rounds what the pieces before it leave
template <int NP>
__device__ __forceinline__ void pieces(float lo, float hi, uint32_t (&p)[NP]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    p[k] = pack_bf16(lo, hi);
    lo -= bf16_lo(p[k]);
    hi -= bf16_hi(p[k]);
  }
}

// 2^x on the SFU: ex2.approx.ftz, within 2 ulp (exp2f's own bound); a
// result under 2^-126 flushes to 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte column block `blk` of row `row` in a 64 x 64 bf16
// tile stored with the 128-byte swizzle (a TMA box, a wgmma operand)
__device__ __forceinline__ uint32_t sw128(int row, int blk) {
  return row * 128 + ((blk ^ (row & 7)) << 4);
}

// wgmma descriptors of a 64 x 64 bf16 tile at `addr` (1,024-byte aligned,
// 128-byte swizzle) and of its k-step kk (16 deep): K-major (k along a row)
// and MN-major (k down the rows)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int kk) {
  return sw128_desc(addr, 16, 1024) + 2 * kk;
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int kk) {
  return sw128_desc(addr, 64 * 128, 1024) + 128 * kk;
}

}  // namespace
