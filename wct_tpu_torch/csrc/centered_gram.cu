// Channel mean and centred Gram of a feature map, two passes over x.
//
// Replaces the TPU kernel wct_tpu/ops/gram_pallas.py::centered_gram
// (_gram_kernel). On channel-major features x [B, C, N] (f32, or bf16 upcast as
// it is read) it computes per image
//
//   mean[c]    = sum over n of x[c, n] / N
//   gram[i, j] = sum over n of (x[i, n] - mean[i]) * (x[j, n] - mean[j])
//
// the un-normalised Gram; the caller divides by N - 1. Full f32 products
// (FFMA), as the TPU kernel's Precision.HIGHEST.
//
// Bound on an H100: at N = 262,144, C = 64 (relu1_1 at 512 px, f32) x is 67 MB
// per image, 0.020 ms to read once, and 2 * N * C^2 = 2.1e9 FLOP are 0.032 ms
// at 67 TFLOP/s: operations, though the two passes of this kernel read x twice
// (0.040 ms). The deeper levels (65,536 x 128 ... 4,096 x 512) have the same
// FLOP and fewer bytes.
//
// The TPU kernel walks its tiles in order on one core and carries the sums in
// scratch memory. Here blocks run in no order, so the sum over N is split:
//   1. mean_kernel: one block per (image, channel) row sums the row (each
//      thread a fixed stride, then a tree in shared memory) and divides by N.
//   2. gram_partial_kernel: a block owns a 64 x 64 tile of the Gram on one
//      split of `split` columns. It stages 32 columns of the two row tiles at a
//      time in shared memory, centred in registers on the way in (x - mean is
//      never written to device memory), columns past N and channels past C as
//      zeros, and a thread keeps a 4 x 4 block of the tile in registers. The
//      tile's partial goes to a workspace [B, S, C, C].
//   3. gram_reduce_kernel adds the S partials of each entry in the order
//      s = 0 .. S - 1.
// ReLU features repeat values (every zero gives the same x - mean), and a
// long f32 sum of equal terms rounds the same way at every step: its error
// grows with the count, not with its square root (5e-6 on a 262,144-term
// mean, measured; 2e-6 on a Gram with chains of 64 FMAs). So no plain f32 sum
// here is longer than 16 terms: the row sums and the folds of the Gram's
// running sums are compensated (Kahan), and the running sums are folded
// every 16 columns.
// No atomics anywhere, and S depends on N alone, so an image's result is the
// same bits alone and in any batch: the TPU kernel's reason to exist.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wct {

constexpr int kGramThreads = 256;
constexpr int kGT = 64;            // edge of a block's Gram tile, in channels
constexpr int kGK = 32;            // columns of x staged at a time
constexpr int kGPitch = kGT + 4;   // a multiple of 4: float4 reads stay aligned
constexpr int kFold = 16;          // columns per fold of the running sums

// sum += v with the rounding error of the add carried in comp (Kahan).
__device__ __forceinline__ void add_compensated(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// x [rows, N] -> mean [rows]; one block per row, grid (C, B).
template <typename T>
__global__ void __launch_bounds__(kGramThreads)
mean_kernel(const T* __restrict__ x, float* __restrict__ mean, int N) {
  __shared__ float red[kGramThreads];
  const size_t r = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const T* p = x + r * N;
  float s = 0.f, comp = 0.f;
  for (int n = threadIdx.x; n < N; n += kGramThreads) add_compensated(s, comp, load_f32(p + n));
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kGramThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) mean[r] = red[0] / (float)N;
}

// grid (tiles * tiles, S, B); work [B, S, C, C].
template <typename T>
__global__ void __launch_bounds__(kGramThreads)
gram_partial_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                    float* __restrict__ work, int C, int N, int split) {
  __shared__ __align__(16) float a_s[kGK * kGPitch];
  __shared__ __align__(16) float b_s[kGK * kGPitch];
  const int tiles = (C + kGT - 1) / kGT;
  const int ti = blockIdx.x / tiles, tj = blockIdx.x % tiles;
  const int s = blockIdx.y, S = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* xb = x + (size_t)b * C * N;
  const float* mb = mean + (size_t)b * C;
  const int n0 = s * split, n1 = min(n0 + split, N);
  const bool diag = ti == tj;

  // A thread stages column kk of channels c_ld, c_ld + 8, ... of both tiles.
  const int kk_ld = tid & 31, c_ld = tid >> 5;
  float mu_a[8], mu_b[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ca = ti * kGT + c_ld + 8 * p, cb = tj * kGT + c_ld + 8 * p;
    mu_a[p] = ca < C ? __ldg(mb + ca) : 0.f;
    mu_b[p] = cb < C ? __ldg(mb + cb) : 0.f;
  }

  float tot[4][4] = {}, comp[4][4] = {};
  for (int k0 = n0; k0 < n1; k0 += kGK) {
    __syncthreads();
    const int n = k0 + kk_ld;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int c = c_ld + 8 * p;
      const int ca = ti * kGT + c, cb = tj * kGT + c;
      float va = 0.f, vb = 0.f;
      if (n < n1) {
        if (ca < C) va = load_f32(xb + (size_t)ca * N + n) - mu_a[p];
        if (!diag && cb < C) vb = load_f32(xb + (size_t)cb * N + n) - mu_b[p];
      }
      a_s[kk_ld * kGPitch + c] = va;
      if (!diag) b_s[kk_ld * kGPitch + c] = vb;
    }
    __syncthreads();
    const float* bs = diag ? a_s : b_s;
#pragma unroll
    for (int f0 = 0; f0 < kGK; f0 += kFold) {
      float acc[4][4] = {};
#pragma unroll
      for (int kk = f0; kk < f0 + kFold; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(a_s + kk * kGPitch + 4 * ty);
        const float4 c = *reinterpret_cast<const float4*>(bs + kk * kGPitch + 4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], cv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) add_compensated(tot[r][q], comp[r][q], acc[r][q]);
    }
  }
  float* wb = work + ((size_t)b * S + s) * C * C;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ti * kGT + 4 * ty + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tj * kGT + 4 * tx + q;
      if (i < C && j < C) wb[(size_t)i * C + j] = tot[r][q] - comp[r][q];
    }
  }
}

// work [B, S, CC] -> gram [B, CC]; grid (ceil(CC / 256), B).
__global__ void __launch_bounds__(kGramThreads)
gram_reduce_kernel(const float* __restrict__ work, float* __restrict__ gram, int CC, int S) {
  const int idx = blockIdx.x * kGramThreads + threadIdx.x;
  if (idx >= CC) return;
  const float* p = work + (size_t)blockIdx.y * S * CC + idx;
  float s = 0.f, comp = 0.f;
  for (int k = 0; k < S; ++k) add_compensated(s, comp, __ldg(p + (size_t)k * CC));
  gram[(size_t)blockIdx.y * CC + idx] = s;
}

template <typename T>
int launch_gram(const T* x, float* mean, float* gram, float* work, int B, int C, int N,
                int split, cudaStream_t stream) {
  const int S = (N + split - 1) / split;
  const int tiles = (C + kGT - 1) / kGT;
  mean_kernel<T><<<dim3(C, B), kGramThreads, 0, stream>>>(x, mean, N);
  gram_partial_kernel<T>
      <<<dim3(tiles * tiles, S, B), kGramThreads, 0, stream>>>(x, mean, work, C, N, split);
  gram_reduce_kernel<<<dim3((C * C + kGramThreads - 1) / kGramThreads, B), kGramThreads, 0,
                       stream>>>(work, gram, C * C, S);
  return (int)cudaGetLastError();
}

}  // namespace wct

// x [B, C, N] f32 (is_bf16 = 0) or bf16 (1), contiguous -> mean [B, C],
// gram [B, C, C], both f32. work holds B * ceil(N / split) * C * C floats;
// split is a multiple of 32. Returns the CUDA error of the launches.
extern "C" int centered_gram_cn(const void* x, int is_bf16, float* mean, float* gram,
                                float* work, int B, int C, int N, int split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return wct::launch_gram(static_cast<const __nv_bfloat16*>(x), mean, gram, work, B, C, N,
                            split, s);
  return wct::launch_gram(static_cast<const float*>(x), mean, gram, work, B, C, N, split, s);
}
