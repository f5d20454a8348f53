// Throughput probe for the warp-level tensor-core instruction mma.sync on
// sm_90a, operands in registers: no shared memory and no device memory in
// the timed loop. tools/profile_mma.py launches it and reports TFLOP/s; no
// cascade route runs it. It answers one question about the 3xTF32 kernels
// (ns_sqrtm, centered_gram, junction): how much of their distance from the
// data-sheet TF32 rate is the instruction's own, and how much the k-step
// around it.
//
// Modes (each warp runs kChains independent accumulators per step, so no
// step waits on the one before):
//   0: mma.sync.m16n8k8 tf32, 2048 FLOP an instruction;
//   1: mma.sync.m16n8k16 bf16, 4096 FLOP an instruction;
//   2: the kernels' 3xTF32 k-step on a 32 x 16 warp tile (2 m-tiles x 4
//      n-tiles): split each f32 operand into hi and lo (split_tf32), three
//      mma into a fresh partial per tile (mma_3xtf32), one f32 add per
//      element to fold it. 2048 useful FLOP per three mma. The f32 operands
//      change by one add each step, so no split is hoisted out of the loop;
//      the kernels load them from shared memory instead.

#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"

namespace {

using wct::mma_3xtf32;
using wct::mma_bf16_16816;
using wct::mma_tf32_1688;
using wct::split_tf32;

constexpr int kThreads = 256;
constexpr int kChains = 8;

template <int MODE>
__global__ void __launch_bounds__(kThreads) mma_rate_kernel(float* __restrict__ out, int iters) {
  const float seed = 1.f + 1e-3f * static_cast<float>(threadIdx.x & 31);
  float acc[kChains][4];
#pragma unroll
  for (int j = 0; j < kChains; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 1e-3f * j;  // distinct: no chain merges

  if constexpr (MODE == 0 || MODE == 1) {
    // tf32: the f32 bit pattern; bf16: two copies of the value's top half.
    const uint32_t x = MODE == 0 ? __float_as_uint(seed)
                                 : (__float_as_uint(seed) & 0xffff0000u) |
                                       (__float_as_uint(seed) >> 16);
    const uint32_t a[4] = {x, x, x, x};
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        if constexpr (MODE == 0) {
          mma_tf32_1688(acc[j], a, x, x);
        } else {
          mma_bf16_16816(acc[j], a, x, x);
        }
      }
    }
  } else {
    constexpr int kM = 2, kN = kChains / kM;
    float af[kM][4], bf[kN][2];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int r = 0; r < 4; ++r) af[m][r] = seed + 0.01f * (m * 4 + r);
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) bf[n][r] = seed - 0.01f * (n * 2 + r);
    for (int i = 0; i < iters; ++i) {
      uint32_t ah[kM][4], al[kM][4], bh[kN][2], bl[kN][2];
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(af[m][r], ah[m][r], al[m][r]);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) split_tf32(bf[n][r], bh[n][r], bl[n][r]);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        float part[kN][4];
        mma_3xtf32<kN>(part, ah[m], al[m], bh, bl);
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m * kN + n][r] += part[n][r];
      }
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int r = 0; r < 4; ++r) af[m][r] += 1e-7f;
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) bf[n][r] += 1e-7f;
    }
  }

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) s += acc[j][r];
  out[static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x] = s;
}

}  // namespace

// Plain C entry point (loaded with ctypes): `blocks` blocks of 256 threads,
// `iters` steps of kChains mma chains per warp in `mode` (0, 1 or 2, as
// above); `out` holds blocks * 256 floats. Launches on `stream` and does not
// synchronise. Returns the CUDA error code, 0 on success.
extern "C" int mma_rate(float* out, int blocks, int iters, int mode, void* stream) {
  if (blocks <= 0 || iters <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    mma_rate_kernel<0><<<blocks, kThreads, 0, s>>>(out, iters);
  } else if (mode == 1) {
    mma_rate_kernel<1><<<blocks, kThreads, 0, s>>>(out, iters);
  } else if (mode == 2) {
    mma_rate_kernel<2><<<blocks, kThreads, 0, s>>>(out, iters);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
