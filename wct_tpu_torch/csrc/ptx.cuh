// Thin wrappers around the PTX instructions the tensor-core kernels use
// (conv3x3_small.cu, junction.cu, encoder_head.cu, ns_sqrtm.cu,
// centered_gram.cu): asynchronous copies into shared memory, ldmatrix and
// stmatrix (sm_90), and the two mma.sync shapes (bf16 m16n8k16, tf32
// m16n8k8), both with f32 accumulators; the 3xTF32 step built on the latter;
// and bf16 packing. The port builds for sm_90a.
// The copies, ldmatrix and stmatrix are volatile, so that they keep their
// place between barriers; the mma's touch registers only and are left to the
// scheduler.

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wct {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1. src_bytes < 16 zero-fills the rest
// (0: all zeros; src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 8 bytes global -> shared through L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes = 8) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 4 bytes global -> shared through L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// Four 8x8 b16 matrices, each stored as 8 rows of 16 bytes (row addresses
// from lanes 8i .. 8i + 7 for matrix i), transposed: lane l receives elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of each.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// The inverse of ldsm_x4: lane l holds elements (l / 4, 2 (l % 4) ..) of each
// matrix, stored to the 16-byte rows addressed by lanes 8i .. 8i + 7.
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// The same, each matrix transposed on the way: lane l's pair (l / 4, 2 (l % 4)
// ..) goes to column l / 4 of rows 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ void stsm_x2_trans(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(r0), "r"(r1)
               : "memory");
}

// d += a * b, bf16 operands: a 16x16 (row), b 16x8 (col), d 16x8 f32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, tf32 operands (f32 bit patterns, low 13 mantissa bits ignored):
// a 16x8 (row), b 8x8 (col), d 16x8 f32.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half: the
// register form of an mma operand pair, and of two neighbouring channels of
// a channel-minor map.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 halves of a packed pair, exactly, as floats.
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// x rounded to tf32 (round to nearest, ties away), as an f32 bit pattern.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 22 significant bits, each half exact in tf32. The
// rounding is to_tf32's (to nearest, ties away from zero) done on the bit
// pattern, two integer operations instead of a conversion, which on this
// card measured faster in the 3xTF32 kernels.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// One k-step of 8 in 3xTF32 for one m-tile and NT n-tiles (fragments split
// by split_tf32): part = lo*hi + hi*lo + hi*hi, from zero. The caller folds
// part into its running sum with a rounded f32 add: the tensor cores
// truncate their own sums, and against the whole running sum that would
// bias it at every k-step.
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float (&part)[NT][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) part[n][r] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32_1688(part[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32_1688(part[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32_1688(part[n], ah, bh[n][0], bh[n][1]);
}

}  // namespace wct
