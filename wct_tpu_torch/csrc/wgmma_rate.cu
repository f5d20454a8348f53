// Throughput probe for Hopper's wgmma.mma_async in the RS form the junction
// kernel issues (A from registers, B from shared memory through a 128-byte
// swizzle descriptor; conv_wgmma.cuh), on sm_90a. tools/profile_mma.py
// launches it and reports TFLOP/s; no cascade route runs it. It answers how
// much of the junction's distance from the data-sheet rate is the
// instruction's own at N = 64 (the conv's 64 output channels).
//
// One block of two warpgroups per SM. Each warpgroup issues groups of four
// wgmma's on one accumulator, back to back (wait_group 1 after each commit,
// so one group runs while the next is issued), on constant A registers and
// a 16 KB B tile. Modes:
//   0: m64n64k16 bf16, 131,072 FLOP an instruction;
//   1: m64n64k8 tf32, 65,536 FLOP.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv_wgmma.cuh"

namespace {

using namespace wct;

constexpr int kRateThreads = 256;

template <int MODE>
__global__ void __launch_bounds__(kRateThreads, 1) wgmma_rate_kernel(float* __restrict__ out,
                                                                     int iters) {
  __shared__ __align__(1024) uint32_t b[4096];  // 16 KB: 128 rows of 128 bytes
  for (int i = threadIdx.x; i < 4096; i += kRateThreads)
    b[i] = 0x3c003c00u ^ static_cast<uint32_t>(i & 0x00ff00ff);  // small, nonzero
  __syncthreads();
  fence_proxy_async();  // the generic writes before the wgmma's asynchronous reads
  const uint32_t base = smem_addr(b);
  const uint32_t s = 0x3c00u + (threadIdx.x & 15);
  const uint32_t a[4] = {s | s << 16, s ^ 1u, s ^ 2u, s ^ 3u};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t desc = desc_sw128(base + 32 * j);
      if constexpr (MODE == 0)
        wgmma_bf16(acc, a, desc, 1);
      else
        wgmma_tf32(acc, a, desc, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sum += acc[i];
  out[blockIdx.x * kRateThreads + threadIdx.x] = sum;
}

}  // namespace

// mode 0 or 1 as above; out holds blocks * 256 floats. Returns the CUDA
// error of the launch.
extern "C" int wgmma_rate(int mode, float* out, int blocks, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: wgmma_rate_kernel<0><<<blocks, kRateThreads, 0, s>>>(out, iters); break;
    case 1: wgmma_rate_kernel<1><<<blocks, kRateThreads, 0, s>>>(out, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// FLOP of one wgmma in `mode`.
extern "C" long long wgmma_rate_flop(int mode) { return mode == 1 ? 65536LL : 131072LL; }
