// Coupled Newton–Schulz matrix square root, fp32 in and out, batched, for
// sm_90a, with its products on wgmma in 3xTF32.
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
// Products. wgmma.m64n64k8 in its SS form (conv_wgmma.cuh): a warpgroup
// computes D [64 x 64] = P [64 x K] . Q^T from two K-major operands in shared
// memory, so X . W reads the rows of X and the rows of W^T. Each product is
// 3xTF32: both operands come as hi = tf32(x) and lo = tf32(x - hi), and a
// k-step of 8 adds lo.hi, hi.lo, then hi.hi into a partial opened with
// scale-d 0; after kFoldSteps k-steps (wgmma.wait_group) the partial is
// folded into the running f32 sum with a rounded add (the tensor cores
// truncate their own sums). A partial of one k-step keeps the kernel within
// twice the plain loop's distance from float64 on every case; longer ones
// did not at n = 128 .. 512 (PERF.md).
//
// Each element is split once. A product's epilogue writes its result in the
// form the next products read: its rows and the rows of its transpose, each
// as a hi and a lo plane in the 128-byte-swizzled K-major layout (pk below),
// so every operand of every product is a run of 16 KB tiles that a bulk copy
// moves into a ring in shared memory, unchanged. (Writing f32 forms instead
// and splitting each staged slice in shared memory, one slice ahead of the
// wgmma's, halves the bytes but measured no faster at n = 512 and slower
// below: PERF.md.) Per step a matrix is read as
//   T = 1.5 I - 0.5 Z . (Y^T)^T:  rows of Z,  rows of Y^T
//   Y' = Y . (T^T)^T:             rows of Y,  rows of T^T
//   Z' = T . (Z^T)^T:             rows of T,  rows of Z^T
// so each of Y, Z and T is kept in both forms. The Y' and Z' products run
// together: Y' overwrites Y^T and Z' overwrites Z in place (neither is read
// there), and Y' and Z'^T go to second buffers. The last step's epilogue
// writes the f32 outputs, scaled, instead.
//
// Three routes, chosen from n alone through cp, the edge the kernel works on
// (n rounded up to 64); ns_sqrtm_workspace_floats tells the caller what a
// route needs:
//   - cp = 64 (n <= 64): ns_resident, one block per matrix with Y, Z and T in
//     shared memory for all iterations, on mma.sync in 3xTF32 with each
//     fragment split as it is read. It measured faster than ns_cluster at
//     cp = 64 (PERF.md), so it stays.
//   - cp = 128: ns_cluster, one launch per call. A cluster of 8 blocks of
//     one warpgroup holds one matrix: block r < 4 owns quadrant r of every
//     product, computes T there, then Y'; block r + 4 computes Z' on the
//     same quadrant alongside. Operands pass through L2 (the workspace), and
//     a cluster barrier (release / acquire, with proxy fences for the bulk
//     copies) separates T from Y' and Z', and one step from the next. Every
//     block computes the shift and the norm from A itself, in the same order.
//   - cp > 128: two prologue launches (row sums; the norm, Y0 and Z0 in
//     their packed forms), then one launch for T and one for Y' and Z' per
//     iteration. Blocks of 2 warpgroups own 128 x 64 output tiles at
//     cp % 128 == 0 and cp >= 384, else blocks of one warpgroup own 64 x 64;
//     each stages k-slices of 32 through a ring of 2 or 4 slots. The gaps between
//     the launches cost a few per cent of a call (PERF.md), so there is one
//     launch per product and no grid-wide barrier.
// Padding is zero in Y and Z outside the n x n block (T gets 1.5 on its
// padded diagonal), which keeps every product block-diagonal: the padding
// never mixes into the result. Shapes and sum orders follow n alone, never
// the batch, and no sum uses atomics, so a matrix gives the same bits alone
// and in any batch.
//
// Bound on an H100: 2 * iters * 3 * n^3 FLOP per matrix (the count of
// wct_tpu/ops/sqrtm.py:208), each done three times on the TF32 tensor cores:
// at 512 px the five cascade levels (n = 512, 512, 256, 128, 64) at batch 4
// need 96.6 GFLOP, 0.585 ms at 3 x FLOP / 495 TFLOP/s (the H100 SXM's dense
// TF32 data-sheet rate). The bytes (one read of A, one write of each output)
// are far below it; the operand forms live in L2 where they fit. Measured
// (PERF.md), a k-slice's chain holds a block back: the wait for its copy,
// its wgmma's reading both operands from shared memory three times over,
// the folds and the slot's hand-back; taking A from registers (the RS
// form) measured no faster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "conv_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using wct::bulk_copy;
using wct::desc_sw128;
using wct::mma_3xtf32;
using wct::split_tf32;
using wct::mbar_expect_tx;
using wct::mbar_init;
using wct::mbar_wait;
using wct::round_tf32;
using wct::smem_addr;
using wct::wgmma_commit;
using wct::wgmma_fence;
using wct::wgmma_tf32_ss;
using wct::wgmma_wait;

constexpr int kFoldSteps = 1;       // k-steps of 8 per partial (PERF.md: 1, 2, 4 tried)
constexpr int kSliceSteps = 4;      // k-steps per staged k-slice of 32
constexpr int kTileBytes = 16384;   // one packed 64 x 32 tile: hi plane, then lo
constexpr int kTileFloats = kTileBytes / 4;
constexpr int kPlaneFloats = kTileFloats / 2;
static_assert(kSliceSteps % kFoldSteps == 0, "a partial never spans two k-slices");

// Float offset of element (i, j) in the packed form of a cp x cp matrix: the
// hi plane (lo at + kPlaneFloats) of tile (i / 64, j / 32), the tiles in row
// order; inside a plane, row i % 64 of 128 bytes, eight rows to a 1 KB atom,
// the 16-byte chunk c of row r stored at chunk c ^ (r % 8): the layout a
// desc_sw128 descriptor reads (tests/test_torch_ns_gram_layout.py).
__device__ __forceinline__ size_t pk(int i, int j, int cp) {
  const int r = i & 63, k = j & 31;
  const size_t tile = static_cast<size_t>(i >> 6) * (cp >> 5) + (j >> 5);
  return tile * kTileFloats + (r >> 3) * 256 + (r & 7) * 32 +
         ((((k >> 2) ^ (r & 7)) << 2) | (k & 3));
}

__device__ __forceinline__ void split_store(float* hi, float v) {
  const uint32_t h = round_tf32(v);
  hi[0] = __uint_as_float(h);
  hi[kPlaneFloats] = __uint_as_float(round_tf32(v - __uint_as_float(h)));
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

// Y0 = (A + shift I) / norm and Z0 = I at (r, c) of the padded edge, into the
// rows and the transposed rows of each (both forms of Z0 are I).
__device__ __forceinline__ void write_y0_z0(const float* A, int r, int c, int n, int cp, float sh,
                                            float nm, float* yr, float* yt, float* zr, float* zt) {
  const bool in = r < n && c < n;
  const float y = in ? (A[static_cast<size_t>(r) * n + c] + (r == c ? sh : 0.f)) / nm : 0.f;
  const float z = in && r == c ? 1.f : 0.f;
  split_store(yr + pk(r, c, cp), y);
  split_store(yt + pk(c, r, cp), y);
  split_store(zr + pk(r, c, cp), z);
  split_store(zt + pk(c, r, cp), z);
}

// Where an epilogue puts D = alpha * P . Q^T + beta * I: both packed forms of
// D (row, tr), or (out non-null) the f32 output cropped to n x n, times or
// (inv) over sqrt(norm).
struct Dest {
  float* row;
  float* tr;
  float* out;
  int inv;
};

// Ring slots per block shape: 2 for 128 x 64 tiles (so that two blocks fit an
// SM's shared memory and cover each other's waits), 4 for 64 x 64 (a deeper
// prefetch); PERF.md has the turns that chose them.
template <int WG, int NC>
__host__ __device__ constexpr int stages() {
  return WG == 2 ? 2 : 4;
}

// The ring: kStages slots of (WG + NC) tiles, WG A tiles (rows of P) then NC B
// tiles (rows of Q), with a "full" barrier each and a count of the
// warpgroups done with its current position. Stream position q lives in
// slot q % kStages; its use of the slot is the (q / kStages)-th.
template <int WG, int NC>
struct Ring {
  static constexpr int kStages = stages<WG, NC>();
  static constexpr int kSlotBytes = (WG + NC) * kTileBytes;
  unsigned char* slots;
  uint64_t* full;
  int* done;

  __device__ __forceinline__ uint32_t slot(int q) const {
    return smem_addr(slots + (q % kStages) * kSlotBytes);
  }

  // One thread: k-slice s of P's row blocks ra .. ra + WG and of Q's row blocks
  // rq .. rq + NC into the slot of position q.
  __device__ __forceinline__ void issue(int q, const float* P, const float* Q, int ra, int rq,
                                        int s, int cp) const {
    const uint32_t bar = smem_addr(full + q % kStages), dst = slot(q);
    mbar_expect_tx(bar, kSlotBytes);
    const int slices = cp >> 5;
#pragma unroll
    for (int a = 0; a < WG; ++a)
      bulk_copy(dst + a * kTileBytes, P + (static_cast<size_t>(ra + a) * slices + s) * kTileFloats,
                kTileBytes, bar);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      bulk_copy(dst + (WG + c) * kTileBytes,
                Q + (static_cast<size_t>(rq + c) * slices + s) * kTileFloats, kTileBytes, bar);
  }
};

// acc[c] = the warpgroup's 64 rows of P . Q^T, columns 64 c .. of the block's
// tile, over the cp / 32 k-slices at stream positions q0 ..; the block's A
// tiles are P's row blocks ra .., its B tiles Q's row blocks rq ... Thread 0
// has issued the first min(kStages, slices) positions; a warpgroup done with
// a slot meets at its named barrier, and the last one out refills it.
template <int WG, int NC>
__device__ __forceinline__ void product(float (&acc)[NC][32], const Ring<WG, NC>& ring, int q0,
                                        const float* P, const float* Q, int ra, int rq, int cp) {
  const int wg = threadIdx.x >> 7, slices = cp >> 5;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  for (int s = 0; s < slices; ++s) {
    const int q = q0 + s;
    mbar_wait(smem_addr(ring.full + q % ring.kStages), (q / ring.kStages) & 1);
    const uint32_t a = ring.slot(q) + wg * kTileBytes;
    // One partial per kFoldSteps k-steps, two in turn: group g's wgmma's run
    // while group g - 1's partial is folded; the slice ends drained.
    constexpr int kGroups = kSliceSteps / kFoldSteps;
    float part[2][NC][32];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      wgmma_fence();
#pragma unroll
      for (int j = g * kFoldSteps; j < (g + 1) * kFoldSteps; ++j)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint32_t b = ring.slot(q) + (WG + c) * kTileBytes;
          const int first = j > g * kFoldSteps;
          wgmma_tf32_ss(part[g & 1][c], desc_sw128(a + 8192 + 32 * j), desc_sw128(b + 32 * j),
                        first);
          wgmma_tf32_ss(part[g & 1][c], desc_sw128(a + 32 * j), desc_sw128(b + 8192 + 32 * j), 1);
          wgmma_tf32_ss(part[g & 1][c], desc_sw128(a + 32 * j), desc_sw128(b + 32 * j), 1);
        }
      wgmma_commit();
      if (g > 0) {
        wgmma_wait<1>();
#pragma unroll
        for (int c = 0; c < NC; ++c) wct::fold(acc[c], part[(g - 1) & 1][c]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) wct::fold(acc[c], part[(kGroups - 1) & 1][c]);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((threadIdx.x & 127) == 0 && s + ring.kStages < slices) {
      if (WG == 1 || (atomicAdd(ring.done + q % ring.kStages, 1) & 1) == 1)
        ring.issue(q + ring.kStages, P, Q, ra, rq, s + ring.kStages, cp);
    }
  }
}

// The warpgroup's D rows i0 + 0 .. 63, columns j0 + 0 .. 64 NC, to `dst`.
template <int NC>
__device__ __forceinline__ void epilogue(const float (&acc)[NC][32], int i0, int j0, float alpha,
                                         float beta, const Dest& dst, float norm, int n, int cp) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const float s = sqrtf(norm);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 16 * w + g + 8 * h, j = j0 + 64 * c + 8 * nt + 2 * t;
        const float v0 = alpha * acc[c][4 * nt + 2 * h] + (i == j ? beta : 0.f);
        const float v1 = alpha * acc[c][4 * nt + 2 * h + 1] + (i == j + 1 ? beta : 0.f);
        if (dst.out != nullptr) {
          if (i < n) {
            float* o = dst.out + static_cast<size_t>(i) * n + j;
            if (j < n) o[0] = dst.inv ? v0 / s : v0 * s;
            if (j + 1 < n) o[1] = dst.inv ? v1 / s : v1 * s;
          }
          continue;
        }
        const uint32_t h0 = round_tf32(v0), h1 = round_tf32(v1);
        const size_t o = pk(i, j, cp);
        *reinterpret_cast<float2*>(dst.row + o) = make_float2(__uint_as_float(h0), __uint_as_float(h1));
        *reinterpret_cast<float2*>(dst.row + o + kPlaneFloats) =
            make_float2(__uint_as_float(round_tf32(v0 - __uint_as_float(h0))),
                        __uint_as_float(round_tf32(v1 - __uint_as_float(h1))));
        split_store(dst.tr + pk(j, i, cp), v0);
        split_store(dst.tr + pk(j + 1, i, cp), v1);
      }
}

template <int WG, int NC>
__host__ __device__ constexpr int ring_smem() {
  return stages<WG, NC>() * (WG + NC) * kTileBytes + 1024;  // + alignment slack
}

// Carve the ring out of dynamic shared memory (1 KB-aligned slots, by pointer
// arithmetic on the array) and initialise its barriers; the caller syncs.
template <int WG, int NC>
__device__ __forceinline__ Ring<WG, NC> make_ring(unsigned char* smem, uint64_t* full, int* done) {
  Ring<WG, NC> ring{smem + (-smem_addr(smem) & 1023u), full, done};
  if (threadIdx.x == 0) {
    for (int s = 0; s < Ring<WG, NC>::kStages; ++s) {
      mbar_init(smem_addr(full + s), 1);
      done[s] = 0;
    }
  }
  return ring;
}

// ---- Resident route: n <= 64, one launch ----

// Index of (r, c) in a cp x cp matrix in shared memory. The XOR moves
// columns by 4 * perm(r & 7), perm = 0 2 4 6 1 3 5 7, so that an A fragment
// (lanes at rows g, columns t) and a B fragment (lanes at rows t, columns g)
// both hit 32 distinct banks. It stays inside an aligned group of 32
// columns and keeps pairs of columns adjacent.
template <int CP>
__device__ __forceinline__ int sw(int r, int c) {
  return r * CP + (c ^ (((r & 3) << 3) | (((r >> 2) & 1) << 2)));
}

constexpr int kNT = 2;  // n-tiles (8 columns each) per warp on the resident route

template <int CP>
__host__ __device__ constexpr int resident_threads() {
  return 32 * (CP / 16) * (CP / (8 * kNT));
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

// dst[r, c] = alpha * acc + beta * (r == c) for the warp's tile.
template <int CP>
__device__ __forceinline__ void warp_store(float* dst, const float (&acc)[kNT][4], int r0, int n0,
                                           int g, int t, float alpha, float beta) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h, c = n0 + 8 * n + 2 * t;
      float2 v;
      v.x = alpha * acc[n][2 * h] + (r == c ? beta : 0.f);
      v.y = alpha * acc[n][2 * h + 1] + (r == c + 1 ? beta : 0.f);
      *reinterpret_cast<float2*>(dst + sw<CP>(r, c)) = v;
    }
}

// One matrix per block (grid batch); its warps tile the matrix 16 rows x
// 8 kNT columns each.
template <int CP>
__global__ void __launch_bounds__(resident_threads<CP>())
ns_resident(const float* __restrict__ a, float* __restrict__ sq, float* __restrict__ isq, int n,
            int iters, float reg) {
  extern __shared__ float4 smem4[];
  float* Y = reinterpret_cast<float*>(smem4);
  float* Z = Y + CP * CP;
  float* T = Z + CP * CP;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;

  // Prologue from shared memory: A staged row-major in T, the shift, the
  // inf-norm (warp per row), then Y0 = (A + shift I) / norm and Z0 = I.
  __shared__ float s_shift, s_norm, s_max[resident_threads<CP>() / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  constexpr int kWarps = resident_threads<CP>() / 32;
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
  __syncthreads();

  constexpr int kBandCols = CP / (8 * kNT);
  const int r0 = (warp / kBandCols) * 16, n0 = (warp % kBandCols) * 8 * kNT;
  float acc[kNT][4];
  for (int it = 0; it < iters; ++it) {
    warp_product<CP>(Z, Y, r0, n0, g, t, acc);
    warp_store<CP>(T, acc, r0, n0, g, t, -0.5f, 1.5f);
    __syncthreads();
    warp_product<CP>(Y, T, r0, n0, g, t, acc);
    __syncthreads();  // every warp is done reading Y
    warp_store<CP>(Y, acc, r0, n0, g, t, 1.f, 0.f);
    warp_product<CP>(T, Z, r0, n0, g, t, acc);
    __syncthreads();  // every warp is done reading Z
    warp_store<CP>(Z, acc, r0, n0, g, t, 1.f, 0.f);
    __syncthreads();
  }

  const float s = sqrtf(nm);
  for (int i = threadIdx.x; i < CP * CP; i += blockDim.x) {
    const int r = i / CP, c = i % CP;
    if (r < n && c < n) {
      const size_t o = off + static_cast<size_t>(r) * n + c;
      sq[o] = Y[sw<CP>(r, c)] * s;
      isq[o] = Z[sw<CP>(r, c)] / s;
    }
  }
}

template <int CP>
cudaError_t launch_resident(const float* a, float* sq, float* isq, int batch, int n, int iters,
                            float reg, cudaStream_t stream) {
  constexpr int smem = 3 * CP * CP * static_cast<int>(sizeof(float));
  auto kernel = ns_resident<CP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch, resident_threads<CP>(), smem, stream>>>(a, sq, isq, n, iters, reg);
  return cudaGetLastError();
}

// ---- Cluster route: 64 < n <= 128, one launch ----

// The packed forms of one matrix in the workspace, in this order.
enum Form { kYr0, kYr1, kYt, kZr, kZt0, kZt1, kTr, kTt, kForms };

// Every write of the cluster before every bulk copy after: release / acquire
// at cluster scope, the generic-proxy writes fenced against the asynchronous
// proxy on both sides.
__device__ __forceinline__ void cluster_exchange() {
  __threadfence();
  wct::fence_proxy_async_global();
  cg::this_cluster().sync();
  wct::fence_proxy_async_global();
}

// One matrix per cluster of 2 NQ^2 blocks of one warpgroup, cp = 64 NQ.
template <int NQ>
__global__ void __launch_bounds__(128)
ns_cluster(const float* __restrict__ a, float* __restrict__ sq, float* __restrict__ isq,
           float* __restrict__ work, int n, int iters, float reg) {
  constexpr int cp = 64 * NQ, kQuads = NQ * NQ, K = 2 * kQuads;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[4];
  __shared__ int done[4];
  __shared__ float s_shift, s_max[4];
  const Ring<1, 1> ring = make_ring<1, 1>(reinterpret_cast<unsigned char*>(smem4), full, done);

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / K, quad = rank % kQuads, bi = quad / NQ, bj = quad % NQ;
  const bool second = rank >= kQuads;  // computes Z' where the first half computes Y'
  const float* A = a + static_cast<size_t>(b) * n * n;
  const size_t form = 2 * static_cast<size_t>(cp) * cp;
  float* f = work + static_cast<size_t>(b) * kForms * form;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 0) {
    const float sh = warp_shift(A, n, n, reg);
    if (lane == 0) s_shift = sh;
  }
  __syncthreads();  // also: the ring's barriers are initialised
  const float sh = s_shift;
  float wmax = 0.f;
  for (int r = warp; r < n; r += 4) wmax = fmaxf(wmax, warp_abs_row(A, r, n, n, sh));
  if (lane == 0) s_max[warp] = wmax;
  __syncthreads();
  const float nm = fmaxf(fmaxf(s_max[0], s_max[1]), fmaxf(s_max[2], s_max[3]));

  if (!second) {
    for (int e = threadIdx.x; e < 64 * 64; e += 128) {
      const int r = 64 * bi + e / 64, c = 64 * bj + e % 64;
      if (iters == 0) {
        if (r < n && c < n) {
          const size_t o = static_cast<size_t>(b) * n * n + static_cast<size_t>(r) * n + c;
          const float y = (A[static_cast<size_t>(r) * n + c] + (r == c ? sh : 0.f)) / nm;
          sq[o] = y * sqrtf(nm);
          isq[o] = (r == c ? 1.f : 0.f) / sqrtf(nm);
        }
      } else {
        write_y0_z0(A, r, c, n, cp, sh, nm, f + kYr0 * form, f + kYt * form, f + kZr * form,
                    f + kZt0 * form);
      }
    }
  }
  if (iters == 0) return;
  cluster_exchange();

  const size_t out = static_cast<size_t>(b) * n * n;
  float acc[1][32];
  int q = 0, cur = 0;
  for (int it = 0; it < iters; ++it) {
    const bool last = it + 1 == iters;
    if (!second) {  // T = 1.5 I - 0.5 Z . Y
      const float* P = f + kZr * form;
      const float* Q = f + kYt * form;
      if (threadIdx.x == 0)
        for (int s = 0; s < ring.kStages && s < cp / 32; ++s) ring.issue(q + s, P, Q, bi, bj, s, cp);
      product<1, 1>(acc, ring, q, P, Q, bi, bj, cp);
      q += cp / 32;
      epilogue<1>(acc, 64 * bi, 64 * bj, -0.5f, 1.5f,
                  Dest{f + kTr * form, f + kTt * form, nullptr, 0}, nm, n, cp);
    }
    cluster_exchange();
    // Y' = Y . T (first half) and Z' = T . Z (second half).
    const float* P = f + (second ? kTr : kYr0 + cur) * form;
    const float* Q = f + (second ? kZt0 + cur : kTt) * form;
    if (threadIdx.x == 0)
      for (int s = 0; s < ring.kStages && s < cp / 32; ++s) ring.issue(q + s, P, Q, bi, bj, s, cp);
    product<1, 1>(acc, ring, q, P, Q, bi, bj, cp);
    q += cp / 32;
    Dest dst = second ? Dest{f + kZr * form, f + (kZt0 + 1 - cur) * form, nullptr, 1}
                      : Dest{f + (kYr0 + 1 - cur) * form, f + kYt * form, nullptr, 0};
    if (last) dst.out = (second ? isq : sq) + out;
    epilogue<1>(acc, 64 * bi, 64 * bj, 1.f, 0.f, dst, nm, n, cp);
    if (!last) cluster_exchange();
    cur ^= 1;
  }
}

template <int NQ>
cudaError_t launch_cluster(const float* a, float* sq, float* isq, float* work, int batch, int n,
                           int iters, float reg, cudaStream_t stream) {
  constexpr int smem = ring_smem<1, 1>();
  constexpr int K = 2 * NQ * NQ;
  auto kernel = ns_cluster<NQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * K);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, sq, isq, work, n, iters, reg);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- One launch per product: n > 128 ----

// Up to two independent products per launch (Y' and Z'); blockIdx.z runs over
// (problem, matrix) pairs.
struct Products {
  const float* p[2];
  const float* q[2];
  Dest dst[2];
};

// A block of WG warpgroups owns rows 64 WG blockIdx.y .. and columns
// 64 NC blockIdx.x .. of one product of one matrix.
template <int WG, int NC>
__global__ void __launch_bounds__(128 * WG)
ns_product(Products pr, const float* __restrict__ norm, int batch, int n, int cp, float alpha,
           float beta) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[4];
  __shared__ int done[4];
  const Ring<WG, NC> ring = make_ring<WG, NC>(reinterpret_cast<unsigned char*>(smem4), full, done);
  const int p = blockIdx.z / batch, b = blockIdx.z % batch;
  const size_t form = 2 * static_cast<size_t>(cp) * cp;
  const float* P = pr.p[p] + b * form;
  const float* Q = pr.q[p] + b * form;
  const int ra = blockIdx.y * WG, rq = blockIdx.x * NC;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < ring.kStages && s < cp / 32; ++s) ring.issue(s, P, Q, ra, rq, s, cp);
  float acc[NC][32];
  product<WG, NC>(acc, ring, 0, P, Q, ra, rq, cp);
  Dest dst = pr.dst[p];
  if (dst.out != nullptr) {
    dst.out += static_cast<size_t>(b) * n * n;
  } else {
    dst.row += b * form;
    dst.tr += b * form;
  }
  epilogue<NC>(acc, 64 * (ra + (threadIdx.x >> 7)), 64 * rq, alpha, beta, dst,
               norm[b], n, cp);
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

// norm = max of the row sums; Y0 and Z0 in both packed forms over the padded
// edge, one 32 x 32 block of (r, c) per block, grid ((cp / 32)^2, batch), the
// transposed forms written from shared memory so that both forms' stores are
// coalesced; the first block stores the norm. With no iterations, the
// outputs instead.
__global__ void __launch_bounds__(256)
ns_scale(const float* __restrict__ a, const float* __restrict__ rowsum,
         const float* __restrict__ shift, float* __restrict__ norm, float* __restrict__ yr,
         float* __restrict__ yt, float* __restrict__ zr, float* __restrict__ zt,
         float* __restrict__ sq, float* __restrict__ isq, int n, int cp, int iters) {
  const int b = blockIdx.y;
  __shared__ float s_max[8], s_norm, tile[32][33];
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
  const size_t off = 2 * static_cast<size_t>(b) * cp * cp;
  const int r0 = blockIdx.x / (cp / 32) * 32, c0 = blockIdx.x % (cp / 32) * 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + warp + 8 * q, c = c0 + lane;
    const bool in = r < n && c < n;
    const float y = in ? (A[static_cast<size_t>(r) * n + c] + (r == c ? sh : 0.f)) / nm : 0.f;
    if (iters == 0) {
      if (in) {
        const size_t o = static_cast<size_t>(b) * n * n + static_cast<size_t>(r) * n + c;
        sq[o] = y * sqrtf(nm);
        isq[o] = (r == c ? 1.f : 0.f) / sqrtf(nm);
      }
      continue;
    }
    tile[warp + 8 * q][lane] = y;
    split_store(yr + off + pk(r, c, cp), y);
    split_store(zr + off + pk(r, c, cp), in && r == c ? 1.f : 0.f);
  }
  if (iters == 0) return;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // Y0^T (c, r) = Y0 (r, c)
    const int c = c0 + warp + 8 * q, r = r0 + lane;
    split_store(yt + off + pk(c, r, cp), tile[lane][warp + 8 * q]);
    split_store(zt + off + pk(c, r, cp), r < n && c < n && r == c ? 1.f : 0.f);
  }
}

// The edge the kernel works on for an n x n matrix: n rounded up to 64.
int padded_edge(int n) { return (n + 63) / 64 * 64; }

size_t workspace_floats(int batch, int cp) {
  const size_t b = static_cast<size_t>(batch), c = static_cast<size_t>(cp);
  if (cp == 64) return 0;
  return 2 * kForms * b * c * c + (cp > 128 ? b * (c + 2) : 0);
}

template <int WG, int NC>
cudaError_t launch_products(const Products& pr, int problems, const float* norm, int batch, int n,
                            int cp, float alpha, float beta, cudaStream_t s) {
  constexpr int smem = ring_smem<WG, NC>();
  auto kernel = ns_product<WG, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cp / (64 * NC), cp / (64 * WG), problems * batch);
  kernel<<<grid, 128 * WG, smem, s>>>(pr, norm, batch, n, cp, alpha, beta);
  return cudaGetLastError();
}

cudaError_t launch_tiled(const float* a, float* sq, float* isq, float* work, int batch, int n,
                         int cp, int iters, float reg, cudaStream_t s) {
  const size_t form = 2 * static_cast<size_t>(batch) * cp * cp;
  float* f[kForms];
  for (int k = 0; k < kForms; ++k) f[k] = work + k * form;
  float* norm = work + kForms * form;
  float* shift = norm + batch;
  float* rowsum = shift + batch;

  ns_rowsum<<<dim3((n + kRowsPerBlock - 1) / kRowsPerBlock, batch), 256, 0, s>>>(a, rowsum, shift,
                                                                              n, cp, reg);
  ns_scale<<<dim3((cp / 32) * (cp / 32), batch), 256, 0, s>>>(
      a, rowsum, shift, norm, f[kYr0], f[kYt], f[kZr], f[kZt0], sq, isq, n, cp, iters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool big = cp >= 384 && cp % 128 == 0;
  auto products = [&](const Products& pr, int problems, float alpha, float beta) {
    return big ? launch_products<2, 1>(pr, problems, norm, batch, n, cp, alpha, beta, s)
               : launch_products<1, 1>(pr, problems, norm, batch, n, cp, alpha, beta, s);
  };
  int cur = 0;
  for (int it = 0; it < iters; ++it) {
    const bool last = it + 1 == iters;
    const Products pt = {{f[kZr], nullptr}, {f[kYt], nullptr},
                         {Dest{f[kTr], f[kTt], nullptr, 0}, Dest{}}};
    err = products(pt, 1, -0.5f, 1.5f);
    if (err != cudaSuccess) return err;
    Products pyz = {{f[kYr0 + cur], f[kTr]}, {f[kTt], f[kZt0 + cur]},
                    {Dest{f[kYr0 + 1 - cur], f[kYt], nullptr, 0},
                     Dest{f[kZr], f[kZt0 + 1 - cur], nullptr, 1}}};
    if (last) {
      pyz.dst[0].out = sq;
      pyz.dst[1].out = isq;
    }
    err = products(pyz, 2, 1.f, 0.f);
    if (err != cudaSuccess) return err;
    cur = 1 - cur;
  }
  return cudaSuccess;
}

}  // namespace

// Floats of device workspace for `batch` matrices of edge n: none on the
// resident route; else the eight packed forms of each matrix at the padded
// edge (ns_cluster's and launch_tiled's layout) and, on the tiled route, per
// matrix a norm, a shift and its row sums. -1 for an empty batch or matrix.
extern "C" long long ns_sqrtm_workspace_floats(int batch, int n) {
  if (batch <= 0 || n <= 0) return -1;
  return static_cast<long long>(workspace_floats(batch, padded_edge(n)));
}

// Plain C entry point (loaded with ctypes). `work` holds
// ns_sqrtm_workspace_floats(batch, n) floats (null where that is 0). Launches on `stream` and does
// not synchronise. Returns the first CUDA error code, 0 on success.
extern "C" int ns_sqrtm_f32(const float* a, float* sq, float* isq, float* work, int batch, int n,
                            int iters, float reg, void* stream) {
  if (batch <= 0 || 2 * batch > 65535 || n <= 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = padded_edge(n);
  if (cp == 64) return static_cast<int>(launch_resident<64>(a, sq, isq, batch, n, iters, reg, s));
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (cp == 128) {
    return static_cast<int>(launch_cluster<2>(a, sq, isq, work, batch, n, iters, reg, s));
  }
  return static_cast<int>(launch_tiled(a, sq, isq, work, batch, n, cp, iters, reg, s));
}
