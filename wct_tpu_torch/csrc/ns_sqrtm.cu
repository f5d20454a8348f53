// Coupled Newton–Schulz matrix square root, fp32, batched, for sm_90a.
//
// Replaces the TPU kernel wct_tpu/ops/sqrtm.py::_sqrtm_pallas (body
// _ns_kernel). For each SPD matrix A [n, n] of a batch it computes
//
//   A  += reg * tr(A) / n * I
//   s   = ||A||_inf                      (largest absolute row sum)
//   Y0  = A / s,  Z0 = I
//   iters x { T = 1.5 I - 0.5 Z Y;  Y <- Y T;  Z <- T Z }   (Y, Z from the
//                                                             previous step)
//   sqrt = Y * sqrt(s)  (= A^1/2),   isqrt = Z / sqrt(s)  (= A^-1/2)
//
// No padding. The TPU wrapper pads n up to a multiple of 128 with a
// delta*I block (delta = tr(A)/n). That block is block-diagonal and leaves
// both tr/n and ||A||_inf unchanged, and matrix products keep the block
// structure, so the top-left n x n of its result is exactly this result.
//
// Bound on an H100: 2 * iters * 3 * n^3 FLOP per matrix, the count of
// wct_tpu/ops/sqrtm.py:208. At 512 px the five cascade levels
// (n = 512, 512, 256, 128, 64) need about 24 GFLOP per frame, about
// 0.36 ms at the H100 SXM's 67 TFLOP/s fp32 (non-tensor) data-sheet peak
// (0.47 ms at the PCIe card's 51 TFLOP/s). The bytes (one read of A, one
// write of each output) are far below that line: the kernel is bound by
// operations.
//
// Design, simple first: a batched fp32 SIMT GEMM (FFMA, fp32 accumulator,
// the batch in gridDim.z) with the fused epilogue
// out = alpha * (A B) + beta * I, so T is one launch and Y T, T Z are one
// more (both problems share a grid). Two tile shapes: 64 x 64 with a
// 4 x 4 micro-tile per thread and k-slices of 16 for any n; 128 x 128
// with an 8 x 8 micro-tile, float4 loads and double-buffered k-slices of
// 8 for n a multiple of 128 from 256 up (half the shared-memory reads per
// FMA of the small tile, which stays bound by them). A prologue
// kernel does the trace, shift, norm and scaling, one block per matrix,
// with fixed summation orders and no atomics, so results are
// deterministic; a last kernel applies the sqrt(s) scaling. fp32 only: a
// single bf16 pass stalls the iteration near 2 % (sqrtm.py:71-76), and
// TF32 keeps too few bits for the same reason.
//
// What it leaves on the table: FFMA reaches at best the fp32 peak, while
// 3xTF32 or wgmma-based splits could use the tensor cores; at n = 64 and
// small batches the grid has one block per matrix, far fewer than the
// 132 SMs; Y, Z and T go through device memory (L2) at every step, where
// a single resident block (n <= 128) or a cluster (n = 512) could keep
// them on chip. Those are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kK = 16;         // k-slice depth
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMicro = 4;      // each thread owns a 4 x 4 micro-tile
constexpr int kPad = 4;        // keeps float4 alignment, softens bank conflicts

// Up to two independent problems per launch (Y T and T Z).
struct GemmBatch {
  const float* a[2];
  const float* b[2];
  float* c[2];
};

// c[p] = alpha * (a[p] @ b[p]) + beta * I, per matrix; blockIdx.z runs
// over (problem, matrix) pairs.
__global__ void __launch_bounds__(kThreads)
ns_gemm(GemmBatch g, int n, int batch, float alpha, float beta) {
  const int p = blockIdx.z / batch;
  const size_t off = static_cast<size_t>(blockIdx.z % batch) * n * n;
  const float* __restrict__ A = g.a[p] + off;
  const float* __restrict__ B = g.b[p] + off;
  float* __restrict__ C = g.c[p] + off;

  __shared__ __align__(16) float As[kK][kTile + kPad];  // As[k][m] = A[m][k]
  __shared__ __align__(16) float Bs[kK][kTile + kPad];  // Bs[k][c] = B[k][c]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kK) {
#pragma unroll
    for (int t = 0; t < (kTile * kK) / kThreads; ++t) {
      const int i = tid + t * kThreads;
      const int m = i / kK, k = i % kK;
      const int r = row0 + m, c = k0 + k;
      As[k][m] = (r < n && c < n) ? A[static_cast<size_t>(r) * n + c] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < (kK * kTile) / kThreads; ++t) {
      const int i = tid + t * kThreads;
      const int k = i / kTile, c = i % kTile;
      const int r = k0 + k, cc = col0 + c;
      Bs[k][c] = (r < n && cc < n) ? B[static_cast<size_t>(r) * n + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * kMicro]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * kMicro]);
      const float a[kMicro] = {av.x, av.y, av.z, av.w};
      const float b[kMicro] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = row0 + ty * kMicro + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = col0 + tx * kMicro + j;
      if (c < n) C[static_cast<size_t>(r) * n + c] = alpha * acc[i][j] + (r == c ? beta : 0.f);
    }
  }
}

constexpr int kBigTile = 128;  // output tile edge of the large-n GEMM
constexpr int kBigK = 8;       // its k-slice depth

// The same product for n a multiple of 128: a 128 x 128 tile, an 8 x 8
// micro-tile per thread (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, the
// same split for columns, so shared-memory reads are conflict-free
// float4s), float4 global loads, and two shared-memory buffers so the
// next k-slice loads while this one computes. Each output still sums
// k = 0 .. n-1 in order with fmaf, so it gives the same bits as ns_gemm.
__global__ void __launch_bounds__(kThreads)
ns_gemm_128(GemmBatch g, int n, int batch, float alpha, float beta) {
  const int p = blockIdx.z / batch;
  const size_t off = static_cast<size_t>(blockIdx.z % batch) * n * n;
  const float* __restrict__ A = g.a[p] + off;
  const float* __restrict__ B = g.b[p] + off;
  float* __restrict__ C = g.c[p] + off;

  __shared__ __align__(16) float As[2][kBigK][kBigTile];  // As[.][k][m] = A[m][k]
  __shared__ __align__(16) float Bs[2][kBigK][kBigTile];  // Bs[.][k][c] = B[k][c]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBigTile;
  const int col0 = blockIdx.x * kBigTile;
  // Each thread loads one float4 of A (row am, columns ak..ak+3) and one
  // of B (row bk, columns bc..bc+3) per k-slice.
  const int am = tid / 2, ak = (tid % 2) * 4;
  const int bk = tid / 32, bc = (tid % 32) * 4;
  const float* a_src = A + static_cast<size_t>(row0 + am) * n + ak;
  const float* b_src = B + static_cast<size_t>(bk) * n + col0 + bc;

  float4 a_ld = *reinterpret_cast<const float4*>(a_src);
  float4 b_ld = *reinterpret_cast<const float4*>(b_src);
  As[0][ak + 0][am] = a_ld.x;
  As[0][ak + 1][am] = a_ld.y;
  As[0][ak + 2][am] = a_ld.z;
  As[0][ak + 3][am] = a_ld.w;
  *reinterpret_cast<float4*>(&Bs[0][bk][bc]) = b_ld;
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int buf = 0;
  for (int k0 = 0; k0 < n; k0 += kBigK) {
    const bool more = k0 + kBigK < n;
    if (more) {
      a_ld = *reinterpret_cast<const float4*>(a_src + k0 + kBigK);
      b_ld = *reinterpret_cast<const float4*>(b_src + static_cast<size_t>(k0 + kBigK) * n);
    }
#pragma unroll
    for (int k = 0; k < kBigK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      // The other buffer was last read before the previous barrier.
      const int nb = buf ^ 1;
      As[nb][ak + 0][am] = a_ld.x;
      As[nb][ak + 1][am] = a_ld.y;
      As[nb][ak + 2][am] = a_ld.z;
      As[nb][ak + 3][am] = a_ld.w;
      *reinterpret_cast<float4*>(&Bs[nb][bk][bc]) = b_ld;
      __syncthreads();
      buf = nb;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      float4 v;
      v.x = alpha * acc[i][h * 4 + 0] + (r == c + 0 ? beta : 0.f);
      v.y = alpha * acc[i][h * 4 + 1] + (r == c + 1 ? beta : 0.f);
      v.z = alpha * acc[i][h * 4 + 2] + (r == c + 2 ? beta : 0.f);
      v.w = alpha * acc[i][h * 4 + 3] + (r == c + 3 ? beta : 0.f);
      *reinterpret_cast<float4*>(&C[static_cast<size_t>(r) * n + c]) = v;
    }
  }
}

// One block per matrix: shift by reg * tr / n, take the inf-norm, write
// Y0 = A / norm, Z0 = I and the norm. Warp-per-row sums with a fixed
// shuffle tree; the trace is a serial sum in row order.
__global__ void __launch_bounds__(kThreads)
ns_prologue(const float* __restrict__ a, float* __restrict__ y, float* __restrict__ z,
            float* __restrict__ norm, int n, float reg) {
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t off = static_cast<size_t>(blockIdx.x) * nn;
  const float* A = a + off;
  __shared__ float s_shift;
  __shared__ float s_norm;
  __shared__ float warp_max[kThreads / 32];

  if (threadIdx.x == 0) {
    float tr = 0.f;
    for (int i = 0; i < n; ++i) tr += A[static_cast<size_t>(i) * n + i];
    s_shift = reg * tr / n;
  }
  __syncthreads();
  const float shift = s_shift;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float wmax = 0.f;
  for (int r = warp; r < n; r += kThreads / 32) {
    float s = 0.f;
    for (int c = lane; c < n; c += 32) {
      s += fabsf(A[static_cast<size_t>(r) * n + c] + (r == c ? shift : 0.f));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    wmax = fmaxf(wmax, s);
  }
  if (lane == 0) warp_max[warp] = wmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    s_norm = m;
    norm[blockIdx.x] = m;
  }
  __syncthreads();
  const float nm = s_norm;
  for (size_t i = threadIdx.x; i < nn; i += kThreads) {
    const int r = static_cast<int>(i / n), c = static_cast<int>(i % n);
    const bool diag = r == c;
    y[off + i] = (A[i] + (diag ? shift : 0.f)) / nm;
    z[off + i] = diag ? 1.f : 0.f;
  }
}

// sqrt = Y * sqrt(norm), isqrt = Z / sqrt(norm); blockIdx.y is the matrix.
__global__ void ns_finish(const float* __restrict__ y, const float* __restrict__ z,
                          const float* __restrict__ norm, float* __restrict__ sq,
                          float* __restrict__ isq, int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t off = static_cast<size_t>(blockIdx.y) * nn;
  const float s = sqrtf(norm[blockIdx.y]);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < nn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    sq[off + i] = y[off + i] * s;
    isq[off + i] = z[off + i] / s;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). `work` holds 5 * batch * n * n
// + batch floats, allocated by the caller. Launches on `stream` and does
// not synchronise. Returns the first cudaGetLastError() code, 0 on success.
extern "C" int ns_sqrtm_f32(const float* a, float* sq, float* isq, float* work, int batch,
                            int n, int iters, float reg, void* stream) {
  if (batch <= 0 || 2 * batch > 65535 || n <= 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nn = static_cast<size_t>(batch) * n * n;
  float* y[2] = {work, work + nn};
  float* z[2] = {work + 2 * nn, work + 3 * nn};
  float* t = work + 4 * nn;
  float* norm = work + 5 * nn;

  ns_prologue<<<batch, kThreads, 0, s>>>(a, y[0], z[0], norm, n, reg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // The 128-tile GEMM where n allows it and gives enough tiles; the
  // general one (any n, masked edges) elsewhere.
  const bool big = n % kBigTile == 0 && n >= 2 * kBigTile;
  const int tiles = big ? n / kBigTile : (n + kTile - 1) / kTile;
  auto gemm = [&](const GemmBatch& g, int problems, float alpha, float beta) {
    const dim3 grid(tiles, tiles, problems * batch);
    if (big) {
      ns_gemm_128<<<grid, kThreads, 0, s>>>(g, n, batch, alpha, beta);
    } else {
      ns_gemm<<<grid, kThreads, 0, s>>>(g, n, batch, alpha, beta);
    }
    return cudaGetLastError();
  };
  int cur = 0;
  for (int it = 0; it < iters; ++it) {
    const int nxt = 1 - cur;
    const GemmBatch gt = {{z[cur], nullptr}, {y[cur], nullptr}, {t, nullptr}};
    err = gemm(gt, 1, -0.5f, 1.5f);
    if (err != cudaSuccess) return static_cast<int>(err);
    const GemmBatch gyz = {{y[cur], t}, {t, z[cur]}, {y[nxt], z[nxt]}};
    err = gemm(gyz, 2, 1.f, 0.f);
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = nxt;
  }

  const int blocks = static_cast<int>((static_cast<size_t>(n) * n + 255) / 256);
  ns_finish<<<dim3(blocks < 1024 ? blocks : 1024, batch), 256, 0, s>>>(y[cur], z[cur], norm,
                                                                       sq, isq, n);
  return static_cast<int>(cudaGetLastError());
}
