// Channel mean and centred Gram of a feature map, two passes over x, the
// products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel wct_tpu/ops/gram_pallas.py::centered_gram
// (_gram_kernel). On channel-major features x [B, C, N] (f32, or bf16 upcast as
// it is read) it computes per image
//
//   mean[c]    = sum over n of x[c, n] / N
//   gram[i, j] = sum over n of (x[i, n] - mean[i]) * (x[j, n] - mean[j])
//
// the un-normalised Gram; the caller divides by N - 1. f32-class products, as
// the TPU kernel's Precision.HIGHEST.
//
// Bound on an H100: the distinct entries need N * C * (C + 1) FLOP per image,
// three times over on the TF32 tensor cores (3 x FLOP / 495 TFLOP/s); x is read
// once. At 512 px, batch 4, relu4_1 ... relu1_1 (N x C = 4,096 x 512 ...
// 262,144 x 64) each need 4.3 GFLOP, 0.026 ms at that rate (FFMA floor 0.064
// ms at 67 TFLOP/s), relu5_1 a quarter of that; the levels read 4 to 134 MB of
// bf16 (up to 0.040 ms at 3.35 TB/s): relu1_1 is bound by its bytes, the
// others by operations.
//
// The TPU kernel walks its tiles in order on one core and carries the sums in
// scratch memory. Here blocks run in no order, so the sum over N is split:
//   1. mean_kernel: one block per (image, channel) row sums the row (each
//      thread a fixed stride, then a tree in shared memory) and divides by N.
//   2. gram_partial_kernel: a block owns one 64 x 64 tile on or above the
//      diagonal (36 tiles at C = 512, 10 at 256, 3 at 128; on a diagonal
//      tile the warp below it idles) on one split of `split` columns. It
//      stages 32 columns of its two row tiles at a time
//      with 16-byte cp.async, double-buffered behind the products (plain loads
//      where N or the base leave rows unaligned), channels past C as zeros.
//      Fragments are centred in registers (x - mean is never stored), masked
//      past the split's last column, split into tf32 hi and lo, and each
//      k-step of 8 columns runs lo*hi + hi*lo + hi*hi into a fresh partial.
//      Both fragment patterns read rows of the staged tiles, so one pitch
//      keeps them free of bank conflicts. The tile's partial goes to a
//      workspace [B, S, C, C] at its place above the diagonal.
//   3. gram_reduce_kernel adds the S partials of each entry i <= j in the
//      order s = 0 .. S - 1 and writes it to (i, j) and (j, i): G is exactly
//      symmetric.
// ReLU features repeat values (every zero gives the same x - mean), and a
// long f32 sum of equal terms rounds the same way at every step: its error
// grows with the count, not with its square root (5e-6 on a 262,144-term
// mean, measured; 2e-6 on a Gram with chains of 64 FMAs). So no plain f32 sum
// here is longer than 16 terms: the row sums, the folds of each k-step's
// partial into the running sums and the reduction over splits are
// compensated (Kahan), and a partial holds 8 columns.
// No atomics anywhere, the tiles depend on C and S on N alone, so an image's
// result is the same bits alone and in any batch: the TPU kernel's reason to
// exist.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"

namespace wct {

constexpr int kGramThreads = 256;  // mean and reduce kernels
constexpr int kTileThreads = 128;  // the partial kernel: 2 x 2 warps of 32 x 32
constexpr int kGT = 64;            // edge of a block's Gram tile, in channels
constexpr int kGK = 32;            // columns of x staged at a time

// sum += v with the rounding error of the add carried in comp (Kahan).
__device__ __forceinline__ void add_compensated(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// grid (tiles * (tiles + 1) / 2, S, B); work [B, S, C, C]. kAsync: every row
// of x starts on 16 bytes, so tiles are staged with cp.async.
template <typename T, bool kAsync>
__global__ void __launch_bounds__(kTileThreads)
gram_partial_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                    float* __restrict__ work, int C, int N, int split) {
  // Row pitch of a staged tile in elements: 16-byte rows whose 32-bit word
  // pitch is 4 or 20 mod 32, so that lanes at rows g, columns t fall on
  // distinct banks (two bf16 lanes share a word).
  constexpr int P = sizeof(T) == 4 ? kGK + 4 : kGK + 8;
  constexpr int kEl = 16 / sizeof(T);    // elements per 16-byte chunk
  constexpr int kRowChunks = kGK / kEl;  // chunks per staged row
  __shared__ __align__(16) T stage[2][2][kGT * P];  // [buffer][tile i, tile j]

  const int tiles = (C + kGT - 1) / kGT;
  int ti = 0, rem = blockIdx.x;
  while (rem >= tiles - ti) {  // row ti holds tiles ti .. tiles - 1
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int s = blockIdx.y, S = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;  // the warp's rows in tile i, j
  // On a diagonal tile the warp at rows 32.., columns ..31 holds only
  // entries below the diagonal, which the reduction never reads.
  const bool below = diag && wr > wc;
  const T* xb = x + (size_t)b * C * N;
  const float* mb = mean + (size_t)b * C;
  const int n0 = s * split, n1 = min(n0 + split, N);

  // The means of the rows this thread's fragments read; 0 past C, where
  // the staged rows are zeros too.
  float mu_a[2][2], mu_b[4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ti * kGT + wr + 16 * m + g + 8 * h;
      mu_a[m][h] = c < C ? __ldg(mb + c) : 0.f;
    }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = tj * kGT + wc + 8 * n + g;
    mu_b[n] = c < C ? __ldg(mb + c) : 0.f;
  }

  // Columns k0 .. k0 + kGK of tile i (and of tile j off the diagonal);
  // past n1 or C the stage holds zeros.
  auto fill = [&](int buf, int k0) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      if (which == 1 && diag) break;
      const int c0 = (which == 0 ? ti : tj) * kGT;
      T* dst = stage[buf][which];
      if constexpr (kAsync) {
        const uint32_t base = wct::smem_addr(dst);
#pragma unroll
        for (int i = tid; i < kGT * kRowChunks; i += kTileThreads) {
          const int r = i / kRowChunks, q = i % kRowChunks;
          const int c = c0 + r, n = k0 + q * kEl;
          const bool ok = c < C && n < n1;
          const T* src = ok ? xb + (size_t)c * N + n : xb;
          wct::cp_async16(base + (r * P + q * kEl) * sizeof(T), src, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < kGT * kGK; i += kTileThreads) {
          const int r = i / kGK, k = i % kGK;
          const int c = c0 + r, n = k0 + k;
          dst[r * P + k] = c < C && n < n1 ? xb[(size_t)c * N + n] : T(0.f);
        }
      }
    }
  };

  float tot[2][4][4] = {}, comp[2][4][4] = {};
  const int steps = (n1 - n0 + kGK - 1) / kGK;
  fill(0, n0);
  if constexpr (kAsync) wct::cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    const int k0 = n0 + st * kGK, buf = st & 1;
    if (st + 1 < steps) fill(buf ^ 1, k0 + kGK);
    if constexpr (kAsync) {
      wct::cp_async_commit();
      wct::cp_async_wait<1>();
    }
    __syncthreads();
    const T* as = stage[buf][0];
    const T* bs = stage[buf][diag ? 0 : 1];
    const int live = n1 - k0;  // columns of this stage inside the split
#pragma unroll
    for (int k = 0; k < kGK; k += 8) {
      if (below) break;
      const bool ok0 = k + t < live, ok1 = k + t + 4 < live;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const T* p = bs + (wc + 8 * n + g) * P + k + t;
        wct::split_tf32(ok0 ? to_f32(p[0]) - mu_b[n] : 0.f, bh[n][0], bl[n][0]);
        wct::split_tf32(ok1 ? to_f32(p[4]) - mu_b[n] : 0.f, bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const T* p = as + (wr + 16 * m + g) * P + k + t;
        uint32_t ah[4], al[4];
        wct::split_tf32(ok0 ? to_f32(p[0]) - mu_a[m][0] : 0.f, ah[0], al[0]);
        wct::split_tf32(ok0 ? to_f32(p[8 * P]) - mu_a[m][1] : 0.f, ah[1], al[1]);
        wct::split_tf32(ok1 ? to_f32(p[4]) - mu_a[m][0] : 0.f, ah[2], al[2]);
        wct::split_tf32(ok1 ? to_f32(p[8 * P + 4]) - mu_a[m][1] : 0.f, ah[3], al[3]);
        float part[4][4];
        wct::mma_3xtf32<4>(part, ah, al, bh, bl);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) add_compensated(tot[m][n][r], comp[m][n][r], part[n][r]);
      }
    }
    __syncthreads();  // the next stage's copy reuses this buffer
  }

  float* wb = work + ((size_t)b * S + s) * C * C;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti * kGT + wr + 16 * m + g + 8 * (r >> 1);
        const int j = tj * kGT + wc + 8 * n + 2 * t + (r & 1);
        if (i < C && j < C && !below) wb[(size_t)i * C + j] = tot[m][n][r] - comp[m][n][r];
      }
}

// work [B, S, C, C] -> gram [B, C, C]; grid (ceil(C * C / 256), B). Entry
// i <= j sums its S partials and lands in (i, j) and (j, i).
__global__ void __launch_bounds__(kGramThreads)
gram_reduce_kernel(const float* __restrict__ work, float* __restrict__ gram, int C, int S) {
  const int idx = blockIdx.x * kGramThreads + threadIdx.x;
  const int i = idx / C, j = idx % C;
  if (i >= C || i > j) return;
  const size_t CC = (size_t)C * C;
  const float* p = work + (size_t)blockIdx.y * S * CC + idx;
  float s = 0.f, comp = 0.f;
  for (int k = 0; k < S; ++k) add_compensated(s, comp, __ldg(p + (size_t)k * CC));
  float* gb = gram + (size_t)blockIdx.y * CC;
  gb[(size_t)i * C + j] = s;
  gb[(size_t)j * C + i] = s;
}

template <typename T>
int launch_gram(const T* x, float* mean, float* gram, float* work, int B, int C, int N,
                int split, cudaStream_t stream) {
  const int S = (N + split - 1) / split;
  const int tiles = (C + kGT - 1) / kGT;
  const dim3 grid(tiles * (tiles + 1) / 2, S, B);
  const bool aligned = N % (16 / (int)sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  mean_kernel<T><<<dim3(C, B), kGramThreads, 0, stream>>>(x, mean, N);
  if (aligned) {
    gram_partial_kernel<T, true><<<grid, kTileThreads, 0, stream>>>(x, mean, work, C, N, split);
  } else {
    gram_partial_kernel<T, false><<<grid, kTileThreads, 0, stream>>>(x, mean, work, C, N, split);
  }
  gram_reduce_kernel<<<dim3((C * C + kGramThreads - 1) / kGramThreads, B), kGramThreads, 0,
                       stream>>>(work, gram, C, S);
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
