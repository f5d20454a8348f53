// Coupled Newton–Schulz matrix square root, fp32 in and out, batched, for
// sm_90a, with its products on the tensor cores in 3xTF32.
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
// Products. Every product runs on mma.sync.m16n8k8 in 3xTF32: each f32
// operand is split, as its fragment is loaded, into hi = tf32(x) and
// lo = tf32(x - hi), and a k-step of 8 adds lo*hi + hi*lo + hi*hi into a
// fresh partial that one rounded f32 add folds into the running sum (the
// tensor cores truncate their own sums; against the whole running sum that
// would bias every k-step). Shapes are chosen from n alone, never from the
// batch, and no sum uses atomics, so a matrix gives the same bits alone and
// in any batch.
//
// Two routes, chosen from n through cp = padded_edge(n), the edge the kernel
// works on (ns_sqrtm_workspace_floats tells the caller what the route needs):
//   - cp = 64 or 128 (n <= 128): ns_resident, one launch per call. Y, Z and T
//     live in shared memory for all iterations (3 * cp^2 floats: 48 KB or
//     192 KB), with a row swizzle that keeps both fragment patterns free of
//     bank conflicts. The prologue (trace, shift, inf-norm, scaling) and the
//     finishing scale are folded in: A is read once, each output written
//     once. At cp = 128 a cluster of 4 blocks shares one matrix (faster than
//     one block or two on this card, and within 2 % of eight on half the
//     SMs: PERF.md): each block keeps full copies of Y, Z, T, computes its
//     band of rows and writes it into every copy through distributed shared
//     memory. At cp = 64 one block holds it.
//   - cp > 128, n rounded up to a multiple of 32: two prologue launches (row
//     sums, then the norm and scaling, each spread over many blocks), one
//     launch for T and one for Y T and T Z per iteration, and a finishing
//     launch. ns_gemm_tc tiles each product in 64 x 64 (cp >= 384) or
//     32 x 32 output tiles, so a batch of 4 gives 256 blocks per product at
//     n = 256 and at n = 512; operands are staged with 16-byte cp.async,
//     double-buffered.
// Padding is zero in Y and Z outside the n x n block (T gets 1.5 on its
// padded diagonal), which keeps every product block-diagonal: the padding
// never mixes into the result.
//
// Bound on an H100: 2 * iters * 3 * n^3 FLOP per matrix (the count of
// wct_tpu/ops/sqrtm.py:208), each done three times on the TF32 tensor cores:
// at 512 px the five cascade levels (n = 512, 512, 256, 128, 64) at batch 4
// need 96.6 GFLOP, 0.585 ms at 3 x FLOP / 495 TFLOP/s (the H100 SXM's dense
// TF32 data-sheet rate); the fp32 FFMA floor (FLOP / 67 TFLOP/s) is 1.44 ms.
// The bytes (one read of A, one write of each output) are far below either.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

using wct::cp_async16;
using wct::cp_async_commit;
using wct::cp_async_wait;
using wct::mma_3xtf32;
using wct::split_tf32;

// One k-step of 8 for one m-tile and NT n-tiles, folded into acc.
template <int NT>
__device__ __forceinline__ void mma3_kstep(float (&acc)[NT][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2]) {
  float part[NT][4];
  mma_3xtf32<NT>(part, ah, al, bh, bl);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] += part[n][r];
}

// sum over lanes of v, in a fixed tree.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// reg * tr(A) / n, by one warp: lane l sums the diagonal entries l, l + 32,
// ..., then a fixed tree. ld is A's row pitch.
__device__ __forceinline__ float warp_shift(const float* A, int n, int ld, float reg) {
  float tr = 0.f;
  for (int i = threadIdx.x % 32; i < n; i += 32) tr += A[static_cast<size_t>(i) * ld + i];
  return reg * warp_sum(tr) / n;
}

// sum over c of |A[r, c] + shift (r == c)|, by one warp.
__device__ __forceinline__ float warp_abs_row(const float* A, int r, int n, int ld, float shift) {
  float s = 0.f;
  for (int c = threadIdx.x % 32; c < n; c += 32) {
    s += fabsf(A[static_cast<size_t>(r) * ld + c] + (r == c ? shift : 0.f));
  }
  return warp_sum(s);
}

// ---- Resident route: n <= 128, one launch ----

// Index of (r, c) in a cp x cp matrix in shared memory. The XOR moves
// columns by 4 * perm(r & 7), perm = 0 2 4 6 1 3 5 7, so that an A fragment
// (lanes at rows g, columns t) and a B fragment (lanes at rows t, columns g)
// both hit 32 distinct banks. It stays inside an aligned group of 32
// columns and keeps pairs of columns adjacent.
template <int CP>
__device__ __forceinline__ int sw(int r, int c) {
  return r * CP + (c ^ (((r & 3) << 3) | (((r >> 2) & 1) << 2)));
}

template <int K>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (K == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

constexpr int kNT = 2;  // n-tiles (8 columns each) per warp on the resident route

template <int CP, int K>
__host__ __device__ constexpr int resident_threads() {
  return 32 * (CP / K / 16) * (CP / (8 * kNT));
}

// acc = A[r0 .. r0 + 16, :] @ B[:, n0 .. n0 + 8 kNT] for one warp.
template <int CP>
__device__ __forceinline__ void warp_product(const float* A, const float* B, int r0, int n0,
                                             int g, int t, float (&acc)[kNT][4]) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < CP; k0 += 8) {
    uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      split_tf32(B[sw<CP>(k0 + t, n0 + 8 * n + g)], bh[n][0], bl[n][0]);
      split_tf32(B[sw<CP>(k0 + t + 4, n0 + 8 * n + g)], bh[n][1], bl[n][1]);
    }
    const int r = r0 + g;
    uint32_t ah[4], al[4];
    split_tf32(A[sw<CP>(r, k0 + t)], ah[0], al[0]);
    split_tf32(A[sw<CP>(r + 8, k0 + t)], ah[1], al[1]);
    split_tf32(A[sw<CP>(r, k0 + t + 4)], ah[2], al[2]);
    split_tf32(A[sw<CP>(r + 8, k0 + t + 4)], ah[3], al[3]);
    mma3_kstep<kNT>(acc, ah, al, bh, bl);
  }
}

// dst[r, c] = alpha * acc + beta * (r == c) for the warp's tile, into the
// block's own copy of dst and, in a cluster, into every other block's.
template <int CP, int K>
__device__ __forceinline__ void warp_store(float* dst, const float (&acc)[kNT][4], int r0, int n0,
                                           int g, int t, float alpha, float beta) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float* d = dst;
    if constexpr (K > 1) d = cg::this_cluster().map_shared_rank(dst, q);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h, c = n0 + 8 * n + 2 * t;
        float2 v;
        v.x = alpha * acc[n][2 * h] + (r == c ? beta : 0.f);
        v.y = alpha * acc[n][2 * h + 1] + (r == c + 1 ? beta : 0.f);
        *reinterpret_cast<float2*>(d + sw<CP>(r, c)) = v;
      }
  }
}

// One matrix per cluster of K blocks (grid batch * K). Block `rank` owns
// rows rank * CP / K ..; its warps tile them 16 rows x 8 kNT columns each.
template <int CP, int K>
__global__ void __launch_bounds__(resident_threads<CP, K>())
ns_resident(const float* __restrict__ a, float* __restrict__ sq, float* __restrict__ isq, int n,
            int iters, float reg) {
  extern __shared__ float4 smem4[];
  float* Y = reinterpret_cast<float*>(smem4);
  float* Z = Y + CP * CP;
  float* T = Z + CP * CP;
  int rank = 0;
  if constexpr (K > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const size_t off = static_cast<size_t>(blockIdx.x / K) * n * n;

  // Prologue from shared memory: A staged row-major in T, the shift, the
  // inf-norm (warp per row), then Y0 = (A + shift I) / norm and Z0 = I.
  __shared__ float s_shift, s_norm, s_max[resident_threads<CP, K>() / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  constexpr int kWarps = resident_threads<CP, K>() / 32;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) T[(i / n) * CP + i % n] = a[off + i];
  __syncthreads();
  if (warp == 0) {
    const float sh = warp_shift(T, n, CP, reg);
    if (lane == 0) s_shift = sh;
  }
  __syncthreads();
  const float shift = s_shift;
  float wmax = 0.f;
  for (int r = warp; r < n; r += kWarps) wmax = fmaxf(wmax, warp_abs_row(T, r, n, CP, shift));
  if (lane == 0) s_max[warp] = wmax;
  __syncthreads();
  if (warp == 0) {
    const float m = warp_max(lane < kWarps ? s_max[lane] : 0.f);
    if (lane == 0) s_norm = m;
  }
  __syncthreads();
  const float nm = s_norm;
  for (int i = threadIdx.x; i < CP * CP; i += blockDim.x) {
    const int r = i / CP, c = i % CP;
    const bool in = r < n && c < n;
    Y[sw<CP>(r, c)] = in ? (T[r * CP + c] + (r == c ? shift : 0.f)) / nm : 0.f;
    Z[sw<CP>(r, c)] = in && r == c ? 1.f : 0.f;
  }
  cluster_sync<K>();  // also: every block of the cluster has started

  constexpr int kRows = CP / K, kBandCols = CP / (8 * kNT);
  const int r0 = rank * kRows + (warp / kBandCols) * 16, n0 = (warp % kBandCols) * 8 * kNT;
  float acc[kNT][4];
  for (int it = 0; it < iters; ++it) {
    warp_product<CP>(Z, Y, r0, n0, g, t, acc);
    warp_store<CP, K>(T, acc, r0, n0, g, t, -0.5f, 1.5f);
    cluster_sync<K>();
    warp_product<CP>(Y, T, r0, n0, g, t, acc);
    __syncthreads();  // this block is done reading its rows of Y; no other block reads them
    warp_store<CP, K>(Y, acc, r0, n0, g, t, 1.f, 0.f);
    warp_product<CP>(T, Z, r0, n0, g, t, acc);
    cluster_sync<K>();  // every block is done reading Z
    warp_store<CP, K>(Z, acc, r0, n0, g, t, 1.f, 0.f);
    cluster_sync<K>();
  }

  const float s = sqrtf(nm);
  for (int i = threadIdx.x; i < kRows * CP; i += blockDim.x) {
    const int r = rank * kRows + i / CP, c = i % CP;
    if (r < n && c < n) {
      const size_t o = off + static_cast<size_t>(r) * n + c;
      sq[o] = Y[sw<CP>(r, c)] * s;
      isq[o] = Z[sw<CP>(r, c)] / s;
    }
  }
}

template <int CP, int K>
cudaError_t launch_resident(const float* a, float* sq, float* isq, int batch, int n, int iters,
                            float reg, cudaStream_t stream) {
  constexpr int smem = 3 * CP * CP * static_cast<int>(sizeof(float));
  auto kernel = ns_resident<CP, K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * K);
  cfg.blockDim = dim3(resident_threads<CP, K>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, sq, isq, n, iters, reg);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- Tiled route: n > 128 ----

// Up to two independent problems per launch (Y T and T Z).
struct GemmBatch {
  const float* a[2];
  const float* b[2];
  float* c[2];
};

constexpr int kGemmThreads = 128;  // 2 x 2 warps
constexpr int kKS = 32;            // k-slice staged per step

// c[p] = alpha * (a[p] @ b[p]) + beta * I on cp x cp matrices, cp a
// multiple of TILE; blockIdx.z runs over (problem, matrix) pairs. Each warp
// owns a (TILE / 2)^2 quarter of the output tile. A slices sit row-major
// with a pitch of 4 mod 32 floats, B slices with 8 mod 32: both fragment
// patterns are free of bank conflicts.
template <int TILE>
__global__ void __launch_bounds__(kGemmThreads)
ns_gemm_tc(GemmBatch gb, int cp, int batch, float alpha, float beta) {
  constexpr int PA = kKS + 4, PB = TILE + 8;
  constexpr int WMT = TILE / 32, WNT = TILE / 16;  // m- and n-tiles per warp
  __shared__ __align__(16) float As[2][TILE * PA];
  __shared__ __align__(16) float Bs[2][kKS * PB];

  const int p = blockIdx.z / batch;
  const size_t off = static_cast<size_t>(blockIdx.z % batch) * cp * cp;
  const float* __restrict__ A = gb.a[p] + off;
  const float* __restrict__ B = gb.b[p] + off;
  float* __restrict__ C = gb.c[p] + off;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * (TILE / 2), wc = (warp & 1) * (TILE / 2);

  auto stage = [&](int buf, int k0) {
    const uint32_t as = wct::smem_addr(As[buf]), bs = wct::smem_addr(Bs[buf]);
#pragma unroll
    for (int i = tid; i < TILE * kKS / 4; i += kGemmThreads) {
      const int r = i / (kKS / 4), c4 = i % (kKS / 4);
      cp_async16(as + (r * PA + 4 * c4) * 4, A + static_cast<size_t>(row0 + r) * cp + k0 + 4 * c4);
    }
#pragma unroll
    for (int i = tid; i < kKS * TILE / 4; i += kGemmThreads) {
      const int r = i / (TILE / 4), c4 = i % (TILE / 4);
      cp_async16(bs + (r * PB + 4 * c4) * 4, B + static_cast<size_t>(k0 + r) * cp + col0 + 4 * c4);
    }
  };

  float acc[WMT][WNT][4];
#pragma unroll
  for (int m = 0; m < WMT; ++m)
#pragma unroll
    for (int n = 0; n < WNT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;

  const int steps = cp / kKS;
  stage(0, 0);
  cp_async_commit();
  for (int kb = 0; kb < steps; ++kb) {
    if (kb + 1 < steps) stage((kb + 1) & 1, (kb + 1) * kKS);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = As[kb & 1];
    const float* bs = Bs[kb & 1];
#pragma unroll
    for (int k = 0; k < kKS; k += 8) {
      uint32_t bh[WNT][2], bl[WNT][2];
#pragma unroll
      for (int n = 0; n < WNT; ++n) {
        const float* b = bs + (k + t) * PB + wc + 8 * n + g;
        split_tf32(b[0], bh[n][0], bl[n][0]);
        split_tf32(b[4 * PB], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int m = 0; m < WMT; ++m) {
        const float* a = as + (wr + 16 * m + g) * PA + k + t;
        uint32_t ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8 * PA], ah[1], al[1]);
        split_tf32(a[4], ah[2], al[2]);
        split_tf32(a[8 * PA + 4], ah[3], al[3]);
        mma3_kstep<WNT>(acc[m], ah, al, bh, bl);
      }
    }
    __syncthreads();  // the next step's copy reuses this buffer
  }

#pragma unroll
  for (int m = 0; m < WMT; ++m)
#pragma unroll
    for (int n = 0; n < WNT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wr + 16 * m + g + 8 * h, c = col0 + wc + 8 * n + 2 * t;
        float2 v;
        v.x = alpha * acc[m][n][2 * h] + (r == c ? beta : 0.f);
        v.y = alpha * acc[m][n][2 * h + 1] + (r == c + 1 ? beta : 0.f);
        *reinterpret_cast<float2*>(C + static_cast<size_t>(r) * cp + c) = v;
      }
}

constexpr int kRowsPerBlock = 32;  // ns_rowsum: 8 warps x 4 rows

// |row| sums of A + shift I for 32 rows per block, grid (ceil(n / 32),
// batch); every block takes the trace itself (the same bits in each), and
// the first also stores the shift.
__global__ void __launch_bounds__(256)
ns_rowsum(const float* __restrict__ a, float* __restrict__ rowsum, float* __restrict__ shift,
          int n, int cp, float reg) {
  const float* A = a + static_cast<size_t>(blockIdx.y) * n * n;
  __shared__ float s_shift;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    const float sh = warp_shift(A, n, n, reg);
    if (lane == 0) s_shift = sh;
  }
  __syncthreads();
  const float sh = s_shift;
  if (blockIdx.x == 0 && threadIdx.x == 0) shift[blockIdx.y] = sh;
#pragma unroll
  for (int q = 0; q < kRowsPerBlock / 8; ++q) {
    const int r = blockIdx.x * kRowsPerBlock + q * 8 + warp;
    if (r < n) {
      const float s = warp_abs_row(A, r, n, n, sh);
      if (lane == 0) rowsum[static_cast<size_t>(blockIdx.y) * cp + r] = s;
    }
  }
}

// norm = max of the row sums; Y0 = (A + shift I) / norm and Z0 = I padded
// to cp, grid (ceil(cp^2 / 2048), batch); the first block stores the norm.
__global__ void __launch_bounds__(256)
ns_scale(const float* __restrict__ a, const float* __restrict__ rowsum,
         const float* __restrict__ shift, float* __restrict__ norm, float* __restrict__ y,
         float* __restrict__ z, int n, int cp) {
  const int b = blockIdx.y;
  __shared__ float s_max[8], s_norm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m = 0.f;
  for (int r = threadIdx.x; r < n; r += blockDim.x) m = fmaxf(m, rowsum[static_cast<size_t>(b) * cp + r]);
  m = warp_max(m);
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    const float v = warp_max(lane < 8 ? s_max[lane] : 0.f);
    if (lane == 0) s_norm = v;
  }
  __syncthreads();
  const float nm = s_norm, sh = shift[b];
  if (blockIdx.x == 0 && threadIdx.x == 0) norm[b] = nm;
  const float* A = a + static_cast<size_t>(b) * n * n;
  const size_t off = static_cast<size_t>(b) * cp * cp;
  const int i0 = blockIdx.x * 2048;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = i0 + q * 256 + threadIdx.x;
    if (i >= cp * cp) break;
    const int r = i / cp, c = i % cp;
    const bool in = r < n && c < n;
    y[off + i] = in ? (A[static_cast<size_t>(r) * n + c] + (r == c ? sh : 0.f)) / nm : 0.f;
    z[off + i] = in && r == c ? 1.f : 0.f;
  }
}

// sqrt = Y * sqrt(norm), isqrt = Z / sqrt(norm), cropped to n x n;
// blockIdx.y is the matrix.
__global__ void ns_finish(const float* __restrict__ y, const float* __restrict__ z,
                          const float* __restrict__ norm, float* __restrict__ sq,
                          float* __restrict__ isq, int n, int cp) {
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t out = static_cast<size_t>(blockIdx.y) * nn;
  const size_t in = static_cast<size_t>(blockIdx.y) * cp * cp;
  const float s = sqrtf(norm[blockIdx.y]);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < nn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / n, c = i % n;
    sq[out + i] = y[in + r * cp + c] * s;
    isq[out + i] = z[in + r * cp + c] / s;
  }
}

// The edge the kernel works on for an n x n matrix: 64 or 128 on the
// resident route, else n rounded up to a multiple of 32, the tiled route's
// smallest tile.
int padded_edge(int n) { return n <= 64 ? 64 : n <= 128 ? 128 : (n + 31) / 32 * 32; }

size_t workspace_floats(int batch, int cp) {
  const size_t b = static_cast<size_t>(batch), c = static_cast<size_t>(cp);
  return cp <= 128 ? 0 : 5 * b * c * c + b * (c + 2);
}

cudaError_t launch_tiled(const float* a, float* sq, float* isq, float* work, int batch, int n,
                         int cp, int iters, float reg, cudaStream_t s) {
  const size_t nn = static_cast<size_t>(batch) * cp * cp;
  float* y[2] = {work, work + nn};
  float* z[2] = {work + 2 * nn, work + 3 * nn};
  float* t = work + 4 * nn;
  float* norm = work + 5 * nn;
  float* shift = norm + batch;
  float* rowsum = shift + batch;

  ns_rowsum<<<dim3((n + kRowsPerBlock - 1) / kRowsPerBlock, batch), 256, 0, s>>>(a, rowsum, shift,
                                                                              n, cp, reg);
  ns_scale<<<dim3((cp * cp + 2047) / 2048, batch), 256, 0, s>>>(a, rowsum, shift, norm, y[0],
                                                               z[0], n, cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool big = cp >= 384 && cp % 64 == 0;
  auto gemm = [&](const GemmBatch& gb, int problems, float alpha, float beta) {
    const int tile = big ? 64 : 32;
    const dim3 grid(cp / tile, cp / tile, problems * batch);
    if (big) {
      ns_gemm_tc<64><<<grid, kGemmThreads, 0, s>>>(gb, cp, batch, alpha, beta);
    } else {
      ns_gemm_tc<32><<<grid, kGemmThreads, 0, s>>>(gb, cp, batch, alpha, beta);
    }
    return cudaGetLastError();
  };
  int cur = 0;
  for (int it = 0; it < iters; ++it) {
    const int nxt = 1 - cur;
    const GemmBatch gt = {{z[cur], nullptr}, {y[cur], nullptr}, {t, nullptr}};
    err = gemm(gt, 1, -0.5f, 1.5f);
    if (err != cudaSuccess) return err;
    const GemmBatch gyz = {{y[cur], t}, {t, z[cur]}, {y[nxt], z[nxt]}};
    err = gemm(gyz, 2, 1.f, 0.f);
    if (err != cudaSuccess) return err;
    cur = nxt;
  }

  const int blocks = static_cast<int>((static_cast<size_t>(n) * n + 255) / 256);
  ns_finish<<<dim3(blocks < 1024 ? blocks : 1024, batch), 256, 0, s>>>(y[cur], z[cur], norm, sq,
                                                                       isq, n, cp);
  return cudaGetLastError();
}

}  // namespace

// Floats of device workspace for `batch` matrices of edge n: none on the
// resident route; on the tiled route Y and Z twice and T at the padded edge,
// and per matrix a norm, a shift and its row sums (launch_tiled's layout).
// -1 for an empty batch or matrix.
extern "C" long long ns_sqrtm_workspace_floats(int batch, int n) {
  if (batch <= 0 || n <= 0) return -1;
  return static_cast<long long>(workspace_floats(batch, padded_edge(n)));
}

// Plain C entry point (loaded with ctypes). `work` holds
// ns_sqrtm_workspace_floats(batch, n) floats (null where that is 0).
// Launches on `stream` and does not synchronise. Returns the first CUDA
// error code, 0 on success.
extern "C" int ns_sqrtm_f32(const float* a, float* sq, float* isq, float* work, int batch, int n,
                            int iters, float reg, void* stream) {
  if (batch <= 0 || 2 * batch > 65535 || n <= 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = padded_edge(n);
  if (cp == 64) return static_cast<int>(launch_resident<64, 1>(a, sq, isq, batch, n, iters, reg, s));
  if (cp == 128) {
    return static_cast<int>(launch_resident<128, 4>(a, sq, isq, batch, n, iters, reg, s));
  }
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_tiled(a, sq, isq, work, batch, n, cp, iters, reg, s));
}
