// The stages that junction.cu and encoder_head.cu share around their 64->64
// convs (which run on wgmma, conv_wgmma.cuh): the operand types' constants and
// map layouts, the halo fix, and the encoder's 3->64 stage rgb -> e1 =
// relu(conv0∘conv1_1), for both operand types. The TPU kernels compute in the
// operand type of their input (wct_tpu/ops/junction_pallas.py:386, :556), so
// each stage is a template on T = float or bf16:
//
//   float  The maps are planar [c][y][x]; the 3->64 stage runs FFMA
//          (stage_e1, on conv_tiles.cuh's inner loop).
//   bf16   The maps are channel-minor [pixel][kPitch]: a pixel's 64 channels
//          and 8 of padding, 144 bytes, so that the 8 row addresses of one
//          ldmatrix fall in 8 bank groups. The 3->64 stage runs on
//          mma.sync.m16n8k16 (stage_e1_mma; B fragments from the host,
//          ops/junction.py::_e1_frags_bf16). Products are exact and sums f32;
//          the output rounds to bf16 once, after bias and ReLU, as the TPU
//          kernels do (junction_pallas.py::_cs_conv).
//
// The rgb map that feeds the 3->64 stage is f32 in both (under bf16 it holds
// bf16 values). The summation order of every output is fixed (conv_tiles.cuh;
// the mma's own order inside), there are no atomics, and nothing depends on
// the batch: an image gives the same bits alone and in any batch.

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
  static constexpr int kKStep = 8;            // input channels of one wgmma k-step
  static constexpr int kChunks = 18;          // chunks of a 64->64 conv: 9 taps x 2 halves
  static constexpr int kChunkBytes = 16384;   // 64 rows x 32 channels, tf32 hi then lo
};

template <>
struct Tc<bf16> {
  static constexpr int kKStep = 16;
  static constexpr int kChunks = 9;           // one tap
  static constexpr int kChunkBytes = 8192;    // 64 rows x 64 channels
};

constexpr int kStepsPerChunk = 4;
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

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// v as the operand type would hold it (bf16: rounded to nearest even).
template <typename T>
__device__ __forceinline__ float as_operand(float v) {
  return is_f32<T>() ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// The halo fix of conv_tiles.cuh for a channel-minor map [R * S][kPitch]
// (R rows of S pixels): whole pixels (their 8 16-byte channel groups) at a time.
__device__ __forceinline__ void fix_halo(bf16* buf, int R, int S, int oy, int ox, int H, int W) {
  uint4* u = reinterpret_cast<uint4*>(buf);
  constexpr int kU = kPitch / 8;
  __syncthreads();
  if (oy < 0 || oy + R > H) {
    for (int i = threadIdx.x; i < R * S * 8; i += kThreads) {
      const int px = i / 8, k = i % 8, gy = oy + px / S, src = reflect(gy, H);
      if ((gy < 0 || gy >= H) && src >= max(oy, 0))
        u[px * kU + k] = u[(px + (src - gy) * S) * kU + k];
    }
    __syncthreads();
  }
  if (ox < 0 || ox + S > W) {
    for (int i = threadIdx.x; i < R * S * 8; i += kThreads) {
      const int px = i / 8, k = i % 8, gx = ox + px % S;
      if (gx < 0 || gx >= W) u[px * kU + k] = u[(px + reflect(gx, W) - gx) * kU + k];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void fix_halo(float* buf, int R, int S, int oy, int ox, int H, int W) {
  fix_halo(buf, kCh, R, S, oy, ox, H, W);
}

// ----------------------------------------------------------------- stages

// rgb [3][kRows + 2][20] (halo fixed) -> e1 [kRows x 18] = relu(conv0∘conv1_1),
// the folded 3->64 conv, FFMA. ws holds its weights [3][9][64]; be1 is global.
template <typename T, int kRows = kE1S>
__device__ __forceinline__ void stage_e1(const float* rgb, T* e1, const float* ws,
                                         const float* __restrict__ be1) {
  const int lane = threadIdx.x & 31, co0 = (threadIdx.x >> 5) * 8;
  constexpr int kTilesX = kE1S / 2, kTiles = (kRows / 2) * kTilesX;
  float bias[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) bias[c] = __ldg(be1 + co0 + c);
  for (int t0 = 0; t0 < kTiles; t0 += 32) {
    const int t = t0 + lane;
    const bool ok = t < kTiles;
    const int ty = ok ? t / kTilesX : 0, tx = ok ? t % kTilesX : 0;
    const int base[1] = {2 * ty * kRgbS + 2 * tx};
    float acc[1][2][2][8] = {};
    conv_accumulate<1>(rgb, (kRows + 2) * kRgbS, kRgbS, 3, ws + co0, base, acc);
    if (!ok) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int pix = (2 * ty + r) * kE1S + 2 * tx + p;
#pragma unroll
        for (int c = 0; c < 8; c += 2)
          store_pair(e1, kRows * kE1S, pix, co0 + c, fmaxf(acc[0][r][p][c] + bias[c], 0.f),
                     fmaxf(acc[0][r][p][c + 1] + bias[c + 1], 0.f));
      }
  }
}

// bf16: the same stage on mma.sync.m16n8k16: rgb [3][kRows + 2][20] (halo
// fixed) -> e1 [kRows x 18] channel-minor. kRows x 18 pixels in m-tiles of 16,
// warp w m-tiles w, w + 8, ...; A gathered per element, k = 9 ci + tap; wf the
// B fragments [2 k-steps][8 n-tiles][32 lanes][2 words] (K = 27 zero-padded to
// 32; ops/junction.py::_e1_frags_bf16).
constexpr int kE1FragWords = 2 * 8 * 32 * 2;  // 4,096 bytes

template <int kRows = kE1S>
__device__ __forceinline__ void stage_e1_mma(const float* rgb, bf16* e1, const uint32_t* wf,
                                             const float* __restrict__ be1) {
  constexpr int kPix = kRows * kE1S, kTiles = (kPix + 15) / 16, kPlane = (kRows + 2) * kRgbS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t b[2][8][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint2 v = *reinterpret_cast<const uint2*>(wf + ((s * 8 + nt) * 32 + lane) * 2);
      b[s][nt][0] = v.x;
      b[s][nt][1] = v.y;
    }
  int koff[2][4];  // rgb offset of k = 16 s + 2 t + {0, 1, 8, 9}; -1 past 27
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 16 * s + 2 * t + (q & 1) + 8 * (q >> 1);
      koff[s][q] = k < 27 ? (k / 9) * kPlane + ((k % 9) / 3) * kRgbS + k % 3 : -1;
    }
  for (int mt = warp; mt < kTiles; mt += 8) {
    int pix[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = min(mt * 16 + g + 8 * r, kPix - 1);
      pix[r] = (p / kE1S) * kRgbS + p % kE1S;
    }
    float acc[8][4] = {};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float v[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[r][q] = koff[s][q] < 0 ? 0.f : rgb[koff[s][q] + pix[r]];
      const uint32_t a[4] = {pack_bf16(v[0][0], v[0][1]), pack_bf16(v[1][0], v[1][1]),
                             pack_bf16(v[0][2], v[0][3]), pack_bf16(v[1][2], v[1][3])};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_bf16_16816(acc[nt], a, b[s][nt][0], b[s][nt][1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = mt * 16 + g + 8 * r;
      if (p >= kPix) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = 8 * nt + 2 * t;
        store_pair(e1, kPix, p, co, fmaxf(acc[nt][2 * r] + __ldg(be1 + co), 0.f),
                   fmaxf(acc[nt][2 * r + 1] + __ldg(be1 + co + 1), 0.f));
      }
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
