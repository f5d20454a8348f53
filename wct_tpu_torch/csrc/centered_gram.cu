// Channel mean and centred Gram of a feature map, two passes over x, the
// products on wgmma in 3xTF32.
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
// once by the function. At 512 px, batch 4, relu4_1 ... relu1_1 (N x C = 4,096
// x 512 ... 262,144 x 64) each need 4.3 GFLOP, 0.026 ms at that rate, relu5_1 a
// quarter of that; relu1_1 reads 134 MB of bf16 (0.040 ms at 3.35 TB/s), so it
// is bound by its bytes, the others by operations. The two passes read x
// twice: at relu1_1 their own floor is twice the bytes bound.
//
// Two launches. The TPU kernel walks its tiles in order on one core and
// carries the sums in scratch memory; here blocks run in no order, so:
//   1. mean_kernel: one block per (image, channel) row sums the row in chunks
//      of 8 (thread t takes chunks t, t + 256, ...; 16-byte loads where rows
//      are aligned, the same order where not), then a fixed tree; it also
//      zeroes the counters of launch 2.
//   2. gram_kernel: one warpgroup per block owns a 64 x 64 tile on or above
//      the diagonal (36 tiles at C = 512, 10 at 256, 3 at 128, 1 at 64) over
//      one split of `split` columns of N. For C <= 32 (grouped WCT hands
//      [B G, C / G, N]) a tile holds the rows of 64 / C images and keeps only
//      each image's own block. Column slices of 32 of the tile's 64 rows
//      arrive in a ring of raw_stages stages, each tile one TMA copy of a 64 x 32
//      box of x seen as [B C, N] (its 128- or 64-byte swizzle keeps the
//      reads below free of bank conflicts), on mbarriers; plain loads where
//      rows are not 16-byte aligned.
//      Each element is centred (x - mean, f32) and split once into hi =
//      tf32(v) and lo = tf32(v - hi), written into hi and lo planes in the
//      128-byte-swizzled K-major layout wgmma reads, one slice ahead of the
//      wgmma's: the centred values exist only there and in registers. (The
//      centring pass and the SS form's reads of both planes bound a block,
//      with shared-memory traffic and issue at two blocks an SM; taking A
//      straight from the staged box into registers, the RS form, measured
//      no faster: PERF.md.) Both operands are rows of x, so D =
//      A . B^T is the Gram tile, lo.hi + hi.lo + hi.hi per k-step of 8 into
//      a partial opened with scale-d 0; every kFoldSteps k-steps the partial
//      is folded into the running sums, compensated. A diagonal tile reads
//      one set of planes for both operands; every warp works on it.
//      With one split the block writes G; else it writes its partial to a
//      workspace. The splits' partials are added in a fixed order: in groups
//      of kGroupSplits (s = 16 g .. 16 g + 15), each by the last block of
//      its group to finish (a counter), then the groups in order g = 0, 1,
//      ... by the last group to finish, which writes the entries i <= j to
//      (i, j) and (j, i): G is exactly symmetric.
// ReLU features repeat values (every zero gives the same x - mean), and a
// long f32 sum of equal terms rounds the same way at every step: its error
// grows with the count, not with its square root (5e-6 on a 262,144-term
// mean, measured; 2e-6 on a Gram with chains of 64 FMAs). So every long f32
// sum here is compensated (Kahan): the row sums, the folds of each partial
// into the running sums and the sum over splits; a partial holds
// 8 kFoldSteps columns (PERF.md: its distance from float64).
// No sum depends on the batch or on which block finishes last, and the tiles
// depend on C and the splits on N alone, so an image's result is the same
// bits alone and in any batch: the TPU kernel's reason to exist.

#include <cuda_bf16.h>

#include <cstdint>

#include "conv_wgmma.cuh"
#include "tma.cuh"

namespace {

using wct::desc_sw128;
using wct::mbar_expect_tx;
using wct::mbar_init;
using wct::mbar_wait;
using wct::round_tf32;
using wct::smem_addr;

constexpr int kMeanThreads = 256;
constexpr int kGramThreads = 128;  // one warpgroup
constexpr int kGT = 64;            // rows of a tile
constexpr int kGK = 32;            // columns of a slice (128 bytes of tf32)
constexpr int kFoldSteps = 4;      // k-steps of 8 per partial (PERF.md: 1, 2, 4 tried)
constexpr int kGroupSplits = 16;   // splits summed together before the sum over groups

// Groups of kGroupSplits splits in a sum over S splits.
__host__ __device__ constexpr int groups_of(int S) { return (S + kGroupSplits - 1) / kGroupSplits; }
constexpr int kPlanes = 2 * 16384; // a buffer of two tiles' hi and lo planes (two buffers)
static_assert(kGK / 8 % kFoldSteps == 0, "a partial never spans two slices");

// Stages of the ring of raw slices: what keeps two blocks to an SM beside the
// plane buffers.
template <typename T>
__host__ __device__ constexpr int raw_stages() {
  return sizeof(T) == 4 ? 3 : 5;
}

// Bytes of one staged tile (a TMA box of 64 rows x 32 columns) and of a stage.
template <typename T>
__host__ __device__ constexpr int raw_box() {
  return kGT * kGK * static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int raw_stage() {
  return 2 * raw_box<T>();
}

// Byte offset of the 16-byte chunk c of row r in a box as the TMA copy wrote
// it: rows of 128 bytes (f32) with the 128-byte swizzle, or of 64 bytes (bf16)
// with the 64-byte one (the chunk bits [4, 7) or [4, 6) XOR-ed with [7, 10)
// or [7, 9) of the offset).
template <typename T>
__device__ __forceinline__ int raw_at(int r, int c) {
  if constexpr (sizeof(T) == 4) return r * 128 + ((c ^ (r & 7)) << 4);
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// sum += v with the rounding error of the add carried in comp (Kahan); the
// sum is sum - comp.
__device__ __forceinline__ void add_compensated(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Eight elements from 16-byte-aligned p (f32: two 16-byte loads), as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = wct::bf16_lo(w[i]);
    v[2 * i + 1] = wct::bf16_hi(w[i]);
  }
}

// x [rows, N] -> mean [rows]; one block per row, thread t summing chunks of 8
// columns t, t + 256, ... in order, four in flight. vec: N % 8 == 0 and x
// 16-byte aligned (the same chunks and order either way). The blocks also
// zero the n_counters counters of launch 2.
template <typename T>
__global__ void __launch_bounds__(kMeanThreads)
mean_kernel(const T* __restrict__ x, float* __restrict__ mean, int* __restrict__ counters,
            int n_counters, int N, int vec) {
  __shared__ float red[kMeanThreads];
  const size_t r = blockIdx.x;
  for (int i = blockIdx.x * kMeanThreads + threadIdx.x; i < n_counters; i += gridDim.x * kMeanThreads)
    counters[i] = 0;
  const T* p = x + r * N;
  float s = 0.f, comp = 0.f;
  const int chunks = (N + 7) / 8;
  for (int c0 = threadIdx.x; c0 < chunks; c0 += 4 * kMeanThreads) {
    float v[4][8];  // four chunks in flight, summed in order
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n0 = 8 * (c0 + u * kMeanThreads);
      if (vec && n0 < N) {
        load8(p + n0, v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = n0 + e < N ? load_f32(p + n0 + e) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (8 * (c0 + u * kMeanThreads) + e < N) add_compensated(s, comp, v[u][e]);
  }
  red[threadIdx.x] = s - comp;
  __syncthreads();
  for (int h = kMeanThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) mean[r] = red[0] / static_cast<float>(N);
}

// Where row r of a tile comes from: image z, channel tile * 64 + r (dense),
// or, packed (C <= 32), image z * (64 / C) + r / C, channel r % C. Either way
// the tile's rows are rows first(tile) .. + 64 of x seen as [B C, N].
struct Rows {
  int B, C, packed, z;
  __device__ __forceinline__ int image(int r) const { return packed ? z * (kGT / C) + r / C : z; }
  __device__ __forceinline__ int channel(int tile, int r) const {
    return packed ? r % C : tile * kGT + r;
  }
  __device__ __forceinline__ bool valid(int tile, int r) const {
    return channel(tile, r) < C && image(r) < B && (!packed || r < kGT / C * C);
  }
  __device__ __forceinline__ size_t index(int tile, int r) const {
    return static_cast<size_t>(image(r)) * C + channel(tile, r);
  }
  __device__ __forceinline__ int first(int tile) const {
    return packed ? z * (kGT / C) * C : z * C + tile * kGT;
  }
};

// Float offset of (r, k) in a 64 x 32 plane: rows of 128 bytes, eight to a 1 KB
// atom, the 16-byte chunk c of row r at chunk c ^ (r % 8) (desc_sw128's layout).
__device__ __forceinline__ int plane_at(int r, int chunk) {
  return (r >> 3) * 256 + (r & 7) * 32 + ((chunk ^ (r & 7)) << 2);
}

// grid (S, tile pairs, image groups); work holds [jobs, S, 32, 128] partials
// (S > 1), counters one per job. kTma: N % (16 / sizeof(T)) == 0 and x
// 16-byte aligned, so `map` describes x as [B C, N] in boxes of 64 x 32.
template <typename T, bool kTma>
__global__ void __launch_bounds__(kGramThreads)
gram_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ x,
            const float* __restrict__ mean, float* __restrict__ gram, float* __restrict__ work,
            int* __restrict__ counters, int B, int C, int N, int split, int packed) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[raw_stages<T>()];
  __shared__ int s_last;
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  float* planes = reinterpret_cast<float*>(base + (-smem_addr(base) & 1023u));
  unsigned char* raw = reinterpret_cast<unsigned char*>(planes) + 2 * kPlanes;

  const int tiles = packed ? 1 : (C + kGT - 1) / kGT;
  int ti = 0, rem = blockIdx.y;
  while (rem >= tiles - ti) {  // row ti holds tiles ti .. tiles - 1
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int s = blockIdx.x, S = gridDim.x;
  const Rows rows{B, C, packed, static_cast<int>(blockIdx.z)};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = s * split, n1 = min(n0 + split, N), slices = (n1 - n0 + kGK - 1) / kGK;

  // This thread centres row tid / 2 of each tile, columns 16 (tid % 2) ...
  const int cr = tid >> 1, ch = tid & 1;
  const T* src[2];
  float mu[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int tile = u ? tj : ti;
    const bool ok = rows.valid(tile, cr);
    src[u] = ok ? x + rows.index(tile, cr) * N : nullptr;
    mu[u] = ok ? __ldg(mean + rows.index(tile, cr)) : 0.f;
  }

  // Thread 0: slice q (columns n0 + 32 q ..) of each tile into raw slot
  // q % raw_stages, one box per tile (the box's columns past the split are masked
  // below, past N and past x's rows the copy writes zeros).
  auto issue = [&](int q) {
    const uint32_t bar = smem_addr(full + q % raw_stages<T>());
    const uint32_t dst = smem_addr(raw + (q % raw_stages<T>()) * raw_stage<T>());
    mbar_expect_tx(bar, (diag ? 1 : 2) * raw_box<T>());
    wct::tma_load_2d(dst, &map, n0 + q * kGK, rows.first(ti), bar);
    if (!diag) wct::tma_load_2d(dst + raw_box<T>(), &map, n0 + q * kGK, rows.first(tj), bar);
  };

  if constexpr (kTma) {
    if (tid == 0)
      for (int q = 0; q < raw_stages<T>(); ++q) mbar_init(smem_addr(full + q), 1);
    __syncthreads();
    if (tid == 0)
      for (int q = 0; q < raw_stages<T>() && q < slices; ++q) issue(q);
  }

  // Every thread: wait for slice q and centre and split it into plane buffer
  // buf (A planes, then B's), hi and lo per tile.
  auto centre = [&](int q, int buf) {
    const int k0 = n0 + q * kGK, live = n1 - k0;
    const unsigned char* slot = raw + (q % raw_stages<T>()) * raw_stage<T>();
    if constexpr (kTma) mbar_wait(smem_addr(full + q % raw_stages<T>()), (q / raw_stages<T>()) & 1);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && diag) break;
      float v[16];
      if constexpr (kTma) {
        const unsigned char* box = slot + u * raw_box<T>();
#pragma unroll
        for (int c8 = 0; c8 < 2; ++c8) {
          float w[8];
          if constexpr (sizeof(T) == 4) {
            const float4 a = *reinterpret_cast<const float4*>(box + raw_at<T>(cr, 4 * ch + 2 * c8));
            const float4 b = *reinterpret_cast<const float4*>(box + raw_at<T>(cr, 4 * ch + 2 * c8 + 1));
            w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
            w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
          } else {
            const uint4 a = *reinterpret_cast<const uint4*>(box + raw_at<T>(cr, 2 * ch + c8));
            const uint32_t ww[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) w[2 * i] = wct::bf16_lo(ww[i]), w[2 * i + 1] = wct::bf16_hi(ww[i]);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) v[8 * c8 + e] = w[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int k = 16 * ch + e;
          v[e] = src[u] != nullptr && k < live ? load_f32(src[u] + k0 + k) : 0.f;
        }
      }
      float* plane = planes + buf * (kPlanes / 4) + u * 4096;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float4 hi, lo;
        float* h = &hi.x;
        float* l = &lo.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 16 * ch + 4 * cc + e;
          const float c = src[u] != nullptr && k < live ? v[4 * cc + e] - mu[u] : 0.f;
          const uint32_t hb = round_tf32(c);
          h[e] = __uint_as_float(hb);
          l[e] = __uint_as_float(round_tf32(c - __uint_as_float(hb)));
        }
        const int at = plane_at(cr, 4 * ch + cc);
        *reinterpret_cast<float4*>(plane + at) = hi;
        *reinterpret_cast<float4*>(plane + 2048 + at) = lo;
      }
    }
    wct::fence_proxy_async();  // the planes' generic writes before wgmma's reads
  };
  // Thread 0, after the barrier that follows slice q's centring: its slot
  // takes slice q + raw_stages<T>().
  auto refill = [&](int q) {
    if constexpr (kTma) {
      if (tid == 0 && q + raw_stages<T>() < slices) {
        wct::fence_proxy_async();  // the slot's generic reads before the copy's writes
        issue(q + raw_stages<T>());
      }
    }
  };

  // While slice q's wgmma's run on one plane buffer, slice q + 1 is centred
  // into the other.
  constexpr int kGroups = kGK / 8 / kFoldSteps;
  float acc[32], comp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = comp[i] = 0.f;
  centre(0, 0);
  __syncthreads();
  refill(0);
  for (int q = 0; q < slices; ++q) {
    const uint32_t pa = smem_addr(planes) + (q & 1) * kPlanes, pb = pa + (diag ? 0 : 16384);
    float part[kGroups][32];
    wct::wgmma_fence();
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int j = g * kFoldSteps; j < (g + 1) * kFoldSteps; ++j) {
        const int first = j > g * kFoldSteps;
        wct::wgmma_tf32_ss(part[g], desc_sw128(pa + 8192 + 32 * j), desc_sw128(pb + 32 * j), first);
        wct::wgmma_tf32_ss(part[g], desc_sw128(pa + 32 * j), desc_sw128(pb + 8192 + 32 * j), 1);
        wct::wgmma_tf32_ss(part[g], desc_sw128(pa + 32 * j), desc_sw128(pb + 32 * j), 1);
      }
      wct::wgmma_commit();
    }
    if (q + 1 < slices) {
      centre(q + 1, (q + 1) & 1);
      __syncthreads();  // slice q + 1 centred: its slot is free
      refill(q + 1);
    }
    wct::wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      wct::fence_regs(part[g]);
#pragma unroll
      for (int i = 0; i < 32; ++i) add_compensated(acc[i], comp[i], part[g][i]);
    }
    __syncthreads();  // slice q's planes read by every warp
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] -= comp[i];

  const int pairs = gridDim.y, job = blockIdx.z * pairs + blockIdx.y;
  if (S > 1) {
    // Partial s goes to slot s; the last block of group s / kGroupSplits to
    // finish sums the group's slots in order into the group's first slot,
    // and the last group to finish sums those in order.
    float* wp = work + static_cast<size_t>(job) * S * 4096;
    int* cnt = counters + job * (groups_of(S) + 1);
    const int grp = s / kGroupSplits, g0 = grp * kGroupSplits, gn = min(kGroupSplits, S - g0);
    auto slot = [&](int k, int i) { return wp + (static_cast<size_t>(k) * 32 + i) * 128 + tid; };
    auto last_in = [&](int* counter, int n) {
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(counter, 1) == n - 1;
      __syncthreads();
      __threadfence();
      return s_last != 0;
    };
    auto sum_slots = [&](int k0, int n, int step) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = comp[i] = 0.f;
      for (int k = 0; k < n; ++k)
#pragma unroll
        for (int i = 0; i < 32; ++i) add_compensated(acc[i], comp[i], __ldcg(slot(k0 + k * step, i)));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] -= comp[i];
    };
#pragma unroll
    for (int i = 0; i < 32; ++i) __stcg(slot(s, i), acc[i]);
    if (!last_in(cnt + grp, gn)) return;
    sum_slots(g0, gn, 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) __stcg(slot(g0, i), acc[i]);
    if (!last_in(cnt + groups_of(S), groups_of(S))) return;
    sum_slots(0, groups_of(S), kGroupSplits);
  }

  // D fragment: warp w, lane (g, t) holds rows 16 w + g + 8 h, columns
  // 8 nt + 2 t + e at acc[4 nt + 2 h + e].
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = 16 * warp + g + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + 2 * t + (i & 1);
    if (!rows.valid(ti, r) || !rows.valid(tj, c)) continue;
    if (packed && r / C != c / C) continue;  // another image's block
    const int ci = rows.channel(ti, r), cj = rows.channel(tj, c);
    if (ci > cj) continue;
    float* gb = gram + static_cast<size_t>(rows.image(r)) * C * C;
    gb[static_cast<size_t>(ci) * C + cj] = acc[i];
    gb[static_cast<size_t>(cj) * C + ci] = acc[i];
  }
}

// The tile pairs and image groups of launch 2, from C and B.
struct Plan {
  int packed, pairs, groups;
};

Plan plan(int B, int C) {
  if (C <= 32) {
    const int per = kGT / C;
    return {1, 1, (B + per - 1) / per};
  }
  const int tiles = (C + kGT - 1) / kGT;
  return {0, tiles * (tiles + 1) / 2, B};
}

// x as a [rows, N] tensor map in boxes of 64 rows x 32 columns, swizzled as
// raw_at reads them (tma.cuh).
template <typename T>
cudaError_t encode_map(CUtensorMap* map, const T* x, int rows, int N) {
  return wct::encode_2d(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      sizeof(T), x, rows, N, kGK, kGT,
      sizeof(T) == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <typename T>
int launch_gram(const T* x, float* mean, float* gram, float* work, int B, int C, int N, int split,
                cudaStream_t stream) {
  const Plan p = plan(B, C);
  const int S = (N + split - 1) / split, jobs = p.pairs * p.groups;
  int* counters = reinterpret_cast<int*>(work + static_cast<size_t>(S > 1 ? S : 0) * jobs * 4096);
  const int n_counters = S > 1 ? jobs * (groups_of(S) + 1) : 0;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  mean_kernel<T><<<B * C, kMeanThreads, 0, stream>>>(x, mean, counters, n_counters, N,
                                                     aligned && N % 8 == 0);
  const dim3 grid(S, p.pairs, p.groups);
  CUtensorMap map = {};
  if (aligned && N % (16 / static_cast<int>(sizeof(T))) == 0) {
    const cudaError_t err = encode_map(&map, x, B * C, N);
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int smem = 1024 + 2 * kPlanes + raw_stages<T>() * raw_stage<T>();
    auto kernel = gram_kernel<T, true>;
    const cudaError_t e2 =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    kernel<<<grid, kGramThreads, smem, stream>>>(map, x, mean, gram, work, counters, B, C, N,
                                                 split, p.packed);
  } else {
    constexpr int smem = 1024 + 2 * kPlanes;
    auto kernel = gram_kernel<T, false>;
    const cudaError_t e2 =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    gram_kernel<T, false><<<grid, kGramThreads, smem, stream>>>(map, x, mean, gram, work, counters,
                                                                B, C, N, split, p.packed);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of device workspace for x [B, C, N] in splits of `split` columns:
// with more than one split, each tile's partials per split and its counters
// (one per group of kGroupSplits splits, one over the groups); else none.
extern "C" long long centered_gram_workspace_floats(int B, int C, int N, int split) {
  if (B <= 0 || C <= 0 || N <= 0 || split <= 0) return -1;
  const Plan p = plan(B, C);
  const long long S = (N + split - 1) / split, jobs = static_cast<long long>(p.pairs) * p.groups;
  return S > 1 ? S * jobs * 4096 + jobs * (groups_of(static_cast<int>(S)) + 1) : 0;
}

// x [B, C, N] f32 (is_bf16 = 0) or bf16 (1), contiguous -> mean [B, C],
// gram [B, C, C], both f32. work holds centered_gram_workspace_floats(B, C,
// N, split) floats; split is a multiple of 32. Returns the CUDA error of the
// launches.
extern "C" int centered_gram_cn(const void* x, int is_bf16, float* mean, float* gram,
                                float* work, int B, int C, int N, int split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_gram(static_cast<const __nv_bfloat16*>(x), mean, gram, work, B, C, N, split, s);
  return launch_gram(static_cast<const float*>(x), mean, gram, work, B, C, N, split, s);
}
