// Shared device code of the junction kernels (junction.cu, encoder_head.cu,
// and conv_tc.cuh, which builds their tensor-core stages on it;
// decoder_tail.cu takes its constants and reflect): 3x3 reflect convolutions
// over image tiles held in shared memory, fp32 FFMA, planar maps.
//
// A block owns a tile of the full-resolution image (16 x 16; the head's 32
// rows x 16) and runs the whole chain of convolutions on it, each
// intermediate living in shared
// memory with the halo the later stages need (stage k rows/cols of halo:
// e1 1, rgb 2, m 3, u 4). Every conv of the chain reflect-pads ITS OWN input,
// and a conv computed on an extended domain is not the reflection of its
// output. So each stage computes its whole haloed region, and on tiles that
// touch the image border `fix_halo` then overwrites the out-of-image rows and
// columns with the in-tile reflected ones (row -k takes row +k) before the
// next stage reads them. Only distance-1 positions are ever read by an
// in-image output; the rest of the halo is overwritten all the same, so no
// stage reads a value that was never written.
//
// `conv_accumulate` is the FFMA inner loop of the 3->64 stage: a warp owns 8
// output channels (its weight reads are warp-uniform shared-memory
// broadcasts), a lane owns NT tiles of 2x2 pixels, so one weight fetch feeds
// 4*NT pixels and one 2x4 input patch feeds 3 taps. Weights are stored
// [ci][tap][co]. The summation order of every output is fixed (ci, then dy,
// then dx), there are no atomics, and nothing depends on the batch size: an
// image's result is the same bits alone and in any batch.

#pragma once
#include <cuda_runtime.h>

namespace wct {

constexpr int kThreads = 256;  // 8 warps; warp w owns output channels 8w..8w+7
constexpr int kT = 16;         // tile edge at full resolution
constexpr int kCh = 64;
constexpr int kTapStride = 9 * kCh;      // floats per input channel in [ci][tap][co]
constexpr int kRgbS = kT + 4;            // rgb region edge (halo 2)
constexpr int kE1S = kT + 2;             // e1 region edge (halo 1)
constexpr int kRgbFloats = 3 * kRgbS * kRgbS;

__device__ __forceinline__ int reflect(int g, int n) {
  return g < 0 ? -g : (g >= n ? 2 * (n - 1) - g : g);
}

// acc[k][r][p][c] += sum over ci < nci, dy, dx of
//   in[ci][base[k] + (r + dy) * pitch + p + dx] * w[ci][dy * 3 + dx][c]
// `in` and `w` are shared memory; `w` already points at the warp's first
// output channel. plane, pitch and base[] are even (8-byte aligned float2).
template <int NT>
__device__ __forceinline__ void conv_accumulate(
    const float* __restrict__ in, int plane, int pitch, int nci,
    const float* __restrict__ w, const int (&base)[NT], float (&acc)[NT][2][2][8]) {
  for (int ci = 0; ci < nci; ++ci) {
    const float* ip = in + ci * plane;
    const float* wp = w + ci * kTapStride;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float wr[3][8];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float4 a = *reinterpret_cast<const float4*>(wp + (dy * 3 + dx) * kCh);
        const float4 b = *reinterpret_cast<const float4*>(wp + (dy * 3 + dx) * kCh + 4);
        wr[dx][0] = a.x; wr[dx][1] = a.y; wr[dx][2] = a.z; wr[dx][3] = a.w;
        wr[dx][4] = b.x; wr[dx][5] = b.y; wr[dx][6] = b.z; wr[dx][7] = b.w;
      }
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const float* r0 = ip + base[k] + dy * pitch;
        float x[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 p = *reinterpret_cast<const float2*>(r0 + r * pitch);
          const float2 q = *reinterpret_cast<const float2*>(r0 + r * pitch + 2);
          x[r][0] = p.x; x[r][1] = p.y; x[r][2] = q.x; x[r][3] = q.y;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int c = 0; c < 8; ++c)
                acc[k][r][p][c] = fmaf(x[r][p + dx], wr[dx][c], acc[k][r][p][c]);
      }
    }
  }
}

// buf [nch][R][S] covers image rows oy..oy+R-1 and columns ox..ox+S-1. Rows
// and columns outside the image take the value at their reflection (which lies
// inside both the image and the region). Rows first, then columns, so corners
// come out as the reflection in both. A region that reaches further below the
// image than its reflection (a tile taller than what is left of the image)
// keeps those rows as they are: no output of the image reads them. Starts and
// ends with a barrier.
__device__ __forceinline__ void fix_halo(float* buf, int nch, int R, int S, int oy, int ox,
                                         int H, int W) {
  __syncthreads();
  if (oy < 0 || oy + R > H) {
    for (int i = threadIdx.x; i < nch * R * S; i += kThreads) {
      const int gy = oy + (i / S) % R, src = reflect(gy, H);
      if ((gy < 0 || gy >= H) && src >= max(oy, 0)) buf[i] = buf[i + (src - gy) * S];
    }
    __syncthreads();
  }
  if (ox < 0 || ox + S > W) {
    for (int i = threadIdx.x; i < nch * R * S; i += kThreads) {
      const int gx = ox + i % S;
      if (gx < 0 || gx >= W) buf[i] = buf[i + reflect(gx, W) - gx];
    }
    __syncthreads();
  }
}

}  // namespace wct
