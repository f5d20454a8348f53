// The tensor-core stages that junction.cu and encoder_head.cu share: the
// weight ring, the k-step of a 64->64 conv, and the encoder stages
// rgb -> e1 (3->64, FFMA) -> conv1_2 + ReLU + 2x2 max pool (64->64 on the
// tensor cores), for both operand types. The TPU kernels compute in the
// operand type of their input (wct_tpu/ops/junction_pallas.py:386, :556), so
// each stage is a template on T = float or bf16:
//
//   float  The maps are planar [c][y][x]. A k-step takes 8 input channels on
//          mma.sync.m16n8k8 in 3xTF32: each f32 operand splits into
//          hi = tf32(x) and lo = tf32(x - hi), and lo*hi + hi*lo + hi*hi go
//          into a fresh partial that a rounded f32 add folds into the sum
//          (the tensor cores truncate their own sums, which over a conv's 216
//          mma's would bias the running sum; ptx.cuh). The A values are read
//          from shared memory one by one and split there; the B fragments come
//          split from the host (ops/junction.py::_tc_frags).
//   bf16   The maps are channel-minor [pixel][kPitch]: a pixel's 64 channels
//          and 8 of padding, 144 bytes, so that the 8 row addresses of one
//          ldmatrix fall in 8 bank groups. A k-step takes 16 input channels
//          on mma.sync.m16n8k16 (bf16 x bf16 -> f32), one pass: ldmatrix.x4
//          brings a 16-pixel x 16-channel A fragment from any 16 pixels (one
//          row address per lane, so a tap's shifted window costs nothing),
//          the B fragments come in mma order from the host
//          (ops/junction.py::_tc_frags_bf16). The products are exact and the
//          sum is f32; the output rounds to bf16 once, after bias and ReLU,
//          as the TPU kernels do (junction_pallas.py::_cs_conv). Each k-step
//          still goes into a fresh partial, as in f32, although the output's
//          own rounding (2^-9) is far coarser than f32's: the tensor cores'
//          truncated sums, against one accumulator over a conv's 36 mma's,
//          flip enough bf16 roundings that the junction's chain (conv0's
//          O(255) weights after the rgb rounding) carried them to 0.23 % of
//          its outputs beyond one bf16 ulp of a float64 evaluation of the
//          same rule, where cuDNN's f32 chain is 0.17 % beyond it; with the
//          partials the kernel is 0.04 % beyond it (H100, PERF.md), for 17 %
//          more time.
//
// In both, a warp owns 16-pixel m-tiles and all 8 n-tiles (64 output
// channels), so an A fragment feeds 8 mma's and a k-step's B fragments (16
// bytes per lane and n-tile pair) feed every m-tile of the warp. The 64->3 and
// 3->64 stages stay FFMA on f32 values (upcast bf16 ones, so the products stay
// exact); the rgb map between them is f32 holding bf16 values under bf16.
//
// The weights stream through a ring of three slots with cp.async: while the
// block runs the mma's of one chunk, the next two are in flight. A chunk is
// four k-steps (f32: half a tap, 32 channels, 16 KB; bf16: a tap, 8 KB).
//
// The summation order of every output is fixed (taps, then channels in
// k-steps, each mma's own order inside; the FFMA stages as conv_tiles.cuh),
// there are no atomics, and nothing depends on the batch: an image gives the
// same bits alone and in any batch.

#pragma once
#include <type_traits>

#include "conv_tiles.cuh"
#include "ptx.cuh"

namespace wct {

using bf16 = __nv_bfloat16;

template <typename T>
struct Tc;

template <>
struct Tc<float> {
  static constexpr int kKStep = 8;            // input channels of one mma k-step
  static constexpr int kChunks = 18;          // chunks of a 64->64 conv: 9 taps x 2 halves
  static constexpr int kChunkBytes = 16384;   // 4 k-steps x 8 n-tiles x 32 lanes x 16 B
};

template <>
struct Tc<bf16> {
  static constexpr int kKStep = 16;
  static constexpr int kChunks = 9;           // one tap
  static constexpr int kChunkBytes = 8192;    // 4 k-steps x 4 n-tile pairs x 32 lanes x 16 B
};

constexpr int kStepsPerChunk = 4;
constexpr int kSlots = 3;
constexpr int kPitch = 72;  // bf16 channel-minor maps: elements per pixel

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// Bytes of a 64-channel map of `pixels` pixels in shared memory.
template <typename T>
__host__ __device__ constexpr int map_bytes(int pixels) {
  return is_f32<T>() ? kCh * pixels * 4 : pixels * kPitch * 2;
}

// Channels c, c + 1 of pixel `pix` of a map whose planes hold `plane` pixels.
__device__ __forceinline__ void store_pair(float* map, int plane, int pix, int c, float v0,
                                           float v1) {
  map[c * plane + pix] = v0;
  map[(c + 1) * plane + pix] = v1;
}

__device__ __forceinline__ void store_pair(bf16* map, int, int pix, int c, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(map + pix * kPitch + c) = pack_bf16(v0, v1);
}

__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_value(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// v as the operand type would hold it (bf16: rounded to nearest even).
template <typename T>
__device__ __forceinline__ float as_operand(float v) {
  return is_f32<T>() ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// The halo fix of conv_tiles.cuh for a channel-minor map [S * S][kPitch]:
// whole pixels (their 8 16-byte channel groups) at a time.
__device__ __forceinline__ void fix_halo(bf16* buf, int S, int oy, int ox, int H, int W) {
  uint4* u = reinterpret_cast<uint4*>(buf);
  constexpr int kU = kPitch / 8;
  __syncthreads();
  if (oy < 0 || oy + S > H) {
    for (int i = threadIdx.x; i < S * S * 8; i += kThreads) {
      const int px = i / 8, k = i % 8, gy = oy + px / S;
      if (gy < 0 || gy >= H) u[px * kU + k] = u[(px + (reflect(gy, H) - gy) * S) * kU + k];
    }
    __syncthreads();
  }
  if (ox < 0 || ox + S > W) {
    for (int i = threadIdx.x; i < S * S * 8; i += kThreads) {
      const int px = i / 8, k = i % 8, gx = ox + px % S;
      if (gx < 0 || gx >= W) u[px * kU + k] = u[(px + reflect(gx, W) - gx) * kU + k];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void fix_halo(float* buf, int S, int oy, int ox, int H, int W) {
  fix_halo(buf, kCh, S, oy, ox, H, W);
}

// ------------------------------------------------------------ weight ring

// A kernel's weights in stream order: n_a chunks of a first 64->64 conv, one
// chunk of the FFMA stages' f32 weights (s0, then s1; float counts multiples
// of 4), n_b chunks of a second 64->64 conv.
struct WeightStream {
  const unsigned char* a;
  int n_a;
  const float* s0;
  int n_s0;
  const float* s1;
  int n_s1;
  const unsigned char* b;
  int n_b;
};

// Put stream position q in flight in its slot. Every thread commits one group
// per call, loads or not, so that wait_group counts positions.
template <int kSlotBytes, int kChunkBytes>
__device__ __forceinline__ void fetch_slot(int q, unsigned char* ring, const WeightStream& ws) {
  const uint32_t dst = smem_addr(ring + (q % kSlots) * kSlotBytes);
  const unsigned char* src = nullptr;
  if (q < ws.n_a) {
    src = ws.a + (size_t)q * kChunkBytes;
  } else if (q == ws.n_a) {
    const int n0 = ws.n_s0 / 4, n1 = ws.n_s1 / 4;  // 16-byte copies
    for (int i = threadIdx.x; i < n0 + n1; i += kThreads)
      cp_async16(dst + i * 16, i < n0 ? ws.s0 + 4 * i : ws.s1 + 4 * (i - n0));
  } else if (q - ws.n_a - 1 < ws.n_b) {
    src = ws.b + (size_t)(q - ws.n_a - 1) * kChunkBytes;
  }
  if (src != nullptr)
    for (int i = threadIdx.x; i < kChunkBytes / 16; i += kThreads) cp_async16(dst + i * 16, src + 16 * i);
  cp_async_commit();
}

// Wait for stream position q, make it visible to the block, and put q + 2 in
// flight in the slot that q - 1 used (every warp is past it: the barrier).
template <int kSlotBytes, int kChunkBytes>
__device__ __forceinline__ const unsigned char* take_slot(int q, unsigned char* ring,
                                                          const WeightStream& ws) {
  cp_async_wait<1>();
  __syncthreads();
  fetch_slot<kSlotBytes, kChunkBytes>(q + 2, ring, ws);
  return ring + (q % kSlots) * kSlotBytes;
}

// ---------------------------------------------------------------- k-steps

// One k-step of 8 input channels for NM m-tiles x 8 n-tiles in 3xTF32. a_at(mt,
// e) is the shared-memory float at row g + 8 (e & 1), channel t + 4 (e >> 1) of
// m-tile mt (g = lane / 4, t = lane % 4); step holds this k-step's B fragments.
template <int NM, typename AAt>
__device__ __forceinline__ void mma_kstep(float (&acc)[NM][8][4], const float* step, int lane,
                                          int live, AAt a_at) {
  uint32_t bh[8][2], bl[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float4 v = *reinterpret_cast<const float4*>(step + (nt * 32 + lane) * 4);
    bh[nt][0] = __float_as_uint(v.x); bh[nt][1] = __float_as_uint(v.y);
    bl[nt][0] = __float_as_uint(v.z); bl[nt][1] = __float_as_uint(v.w);
  }
#pragma unroll
  for (int mt = 0; mt < NM; ++mt) {
    if (mt >= live) break;
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = a_at(mt, e);
      ah[e] = to_tf32(a);
      al[e] = to_tf32(a - __uint_as_float(ah[e]));
    }
    // Four n-tiles at a time, pass by pass, so that four independent mma's
    // stand between two on one partial.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part[4][4] = {};
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_tf32_1688(part[n], al, bh[4 * h + n][0], bh[4 * h + n][1]);
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_tf32_1688(part[n], ah, bl[4 * h + n][0], bl[4 * h + n][1]);
#pragma unroll
      for (int n = 0; n < 4; ++n) mma_tf32_1688(part[n], ah, bh[4 * h + n][0], bh[4 * h + n][1]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][4 * h + n][r] += part[n][r];
    }
  }
}

// One k-step of 16 input channels for NM m-tiles x 8 n-tiles in bf16, one
// pass. a_addr(mt) is the shared-memory address of this lane's ldmatrix row
// of m-tile mt: pixel lane % 16 of the m-tile, channels 8 (lane / 16) .. + 7
// of the k-step; step holds the k-step's B fragments.
template <int NM, typename AAddr>
__device__ __forceinline__ void mma_kstep(float (&acc)[NM][8][4], const bf16* step, int lane,
                                          int live, AAddr a_addr) {
  uint32_t b[8][2];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint4 v = *reinterpret_cast<const uint4*>(step + (p * 32 + lane) * 8);
    b[2 * p][0] = v.x; b[2 * p][1] = v.y;
    b[2 * p + 1][0] = v.z; b[2 * p + 1][1] = v.w;
  }
#pragma unroll
  for (int mt = 0; mt < NM; ++mt) {
    if (mt >= live) break;
    uint32_t a[4];
    ldsm_x4(a_addr(mt), a[0], a[1], a[2], a[3]);
    // A fresh partial per k-step, folded in with a rounded f32 add, as in
    // the f32 form: the tensor cores truncate their sums (header note).
    float part[8][4] = {};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_bf16_16816(part[nt], a, b[nt][0], b[nt][1]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] += part[nt][r];
  }
}

// ----------------------------------------------------------------- stages

// rgb [3][20][20] (halo fixed) -> e1 [18 x 18] = relu(conv0∘conv1_1), the
// folded 3->64 conv, FFMA. ws holds its weights [3][9][64]; be1 is global.
template <typename T>
__device__ __forceinline__ void stage_e1(const float* rgb, T* e1, const float* ws,
                                         const float* __restrict__ be1) {
  const int lane = threadIdx.x & 31, co0 = (threadIdx.x >> 5) * 8;
  constexpr int kTiles = kE1S / 2;
  float bias[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) bias[c] = __ldg(be1 + co0 + c);
  for (int t0 = 0; t0 < kTiles * kTiles; t0 += 32) {
    const int t = t0 + lane;
    const bool ok = t < kTiles * kTiles;
    const int ty = ok ? t / kTiles : 0, tx = ok ? t % kTiles : 0;
    const int base[1] = {2 * ty * kRgbS + 2 * tx};
    float acc[1][2][2][8] = {};
    conv_accumulate<1>(rgb, kRgbS * kRgbS, kRgbS, 3, ws + co0, base, acc);
    if (!ok) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int pix = (2 * ty + r) * kE1S + 2 * tx + p;
#pragma unroll
        for (int c = 0; c < 8; c += 2)
          store_pair(e1, kE1S * kE1S, pix, co0 + c, fmaxf(acc[0][r][p][c] + bias[c], 0.f),
                     fmaxf(acc[0][r][p][c + 1] + bias[c + 1], 0.f));
      }
  }
}

// e1 [18 x 18] (halo fixed) -> relu(conv1_2) on the 16x16 tile -> 2x2 max pool
// -> out_b [64][h][w] (one image's pooled map), rows 8 by.., cols 8 bx...
// conv1_2's weights are stream positions q0 .. q0 + Tc<T>::kChunks - 1. Warp w
// owns tile rows 2w and 2w + 1 (m-tiles 0 and 1): the pool's vertical max is
// in registers, its horizontal max one shuffle away (lane ^ 4). Under bf16
// the max of the rounded values is the rounded max.
template <typename T, int kSlotBytes>
__device__ __forceinline__ void stage_e2_pool(const T* e1, unsigned char* ring,
                                              const WeightStream& ws, int q0,
                                              const float* __restrict__ be2, T* __restrict__ out_b,
                                              int h, int w, int by, int bx) {
  constexpr int kChunkBytes = Tc<T>::kChunkBytes, kPerTap = Tc<T>::kChunks / 9;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[2][8][4] = {};
  for (int c = 0; c < Tc<T>::kChunks; ++c) {
    const int tap = c / kPerTap, dy = tap / 3, dx = tap % 3;
    const int ch0 = (c % kPerTap) * kStepsPerChunk * Tc<T>::kKStep;
    const T* slot = reinterpret_cast<const T*>(take_slot<kSlotBytes, kChunkBytes>(q0 + c, ring, ws));
#pragma unroll
    for (int j = 0; j < kStepsPerChunk; ++j) {
      const T* step = slot + j * kChunkBytes / kStepsPerChunk / sizeof(T);
      if constexpr (is_f32<T>()) {
        const float* a_base = e1 + (ch0 + 8 * j + t) * kE1S * kE1S + (2 * warp + dy) * kE1S + g + dx;
        mma_kstep<2>(acc, step, lane, 2, [&](int mt, int e) {
          return a_base[(e >> 1) * 4 * kE1S * kE1S + mt * kE1S + 8 * (e & 1)];
        });
      } else {
        const uint32_t a_base = smem_addr(
            e1 + ((2 * warp + dy) * kE1S + (lane & 15) + dx) * kPitch + ch0 + 16 * j + 8 * (lane >> 4));
        mma_kstep<2>(acc, step, lane, 2,
                     [&](int mt) { return a_base + mt * kE1S * kPitch * (uint32_t)sizeof(T); });
      }
    }
  }
  const int oy = (kT / 2) * by + warp;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // e: column g + 8 (e >> 1), channel 8 nt + 2 t + (e & 1)
      const float bias = __ldg(be2 + 8 * nt + 2 * t + (e & 1));
      float v = fmaxf(fmaxf(acc[0][nt][e] + bias, 0.f), fmaxf(acc[1][nt][e] + bias, 0.f));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      if ((g & 1) == 0) {
        const int ox = (kT / 2) * bx + (g >> 1) + 4 * (e >> 1);
        store_value(out_b + ((size_t)(8 * nt + 2 * t + (e & 1)) * h + oy) * w + ox, v);
      }
    }
}

// A kernel's dynamic shared memory and its resident blocks per SM at
// kThreads threads, after allowing it that shared memory.
template <typename K>
int kernel_plan(K kernel, int smem, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}

}  // namespace wct
