// The fused cascade junction: decoder tail -> encoder head, one launch.
//
// Replaces the TPU kernel wct_tpu/ops/junction_pallas.py::junction
// (_junction_kernel). On d [B, 64, h, w] (NCHW, f32) it computes
//
//   u   = 2x nearest upsample of d                    [64, 2h, 2w]
//   m   = relu(conv3x3(u;  wd1, bd1))                 [64, H, W]   decoder 64->64
//   rgb = conv3x3(m; wd2, bd2), clipped to [0,1] if `clip`   [3, H, W]
//   e1  = relu(conv3x3(rgb; we1, be1))                [64, H, W]   conv0 folded into conv1_1
//   deep:     out = maxpool2(relu(conv3x3(e1; we2, be2)))    [64, h, w]
//   shallow:  out = e1                                        [64, H, W]
//
// every conv reflect-padding its own input (conv_tiles.cuh says how the tile
// borders keep that exact). No intermediate touches device memory: the
// unfused chain writes and reads five full-resolution 64-channel maps.
//
// Bound on an H100: operations. 2*H*W*9*(64*64 + 64*3 + 3*64 + 64*64) FLOP per
// image, 40.5 GFLOP at 512 px, against 268 MB of d read and 268 MB written at
// batch 4: 2.4 ms of fp32 FFMA against 0.04 ms of memory traffic. So the design
// spends its effort on FMAs per shared-memory read (conv_tiles.cuh), not on
// bytes. What it costs: a 16x16 tile recomputes halos (m on 22x22 for 16x16 of
// output: 1.45x the FMAs of the two 64->64 convs together), and the shared
// memory of one SM holds exactly one tile's chain in f32:
//
//   bufM  m [64][22][22]                                   123,904 B
//   bufE  e1 [64][18][18]; before e1 exists it holds the
//         d tile [64][12][12] and the staged u chunk [8][24][24]   82,944 B
//   rgb   [3][20][20]                                        4,800 B
//   ws    staged weights: 8 input channels [8][9][64], or the
//         whole 64->3 or 3->64 conv                          18,432 B
//   reflect+upsample index tables                               192 B
//
// u is never stored whole: per 8-channel chunk the block expands the d tile
// into u [8][24][24] through the tables (reflect at full resolution, then
// >> 1), which keeps the inner loop free of index arithmetic.
//
// Grid (W/16, H/16, B), 256 threads, one block per SM.

#include "conv_tiles.cuh"

namespace wct {

constexpr int kMS = kT + 6;   // m region edge (halo 3)
constexpr int kUS = kT + 8;   // u region edge (halo 4)
constexpr int kDS = kUS / 2;  // d tile edge
constexpr int kMFloats = kCh * kMS * kMS;
constexpr int kDFloats = kCh * kDS * kDS;
constexpr int kJunctionSmem =
    (kMFloats + kE1Floats + kRgbFloats + kWsFloats) * 4 + 2 * kUS * 4;
static_assert(kDFloats + kChunk * kUS * kUS <= kE1Floats, "d tile and u chunk share bufE");
static_assert(kJunctionSmem <= 232448, "one block's shared memory on sm_90");

// m [64][22][22] (halo fixed) -> rgb [3][20][20] = conv 64->3 (+clip). ws holds
// the weights [64][9][4] (co padded to 4) and, behind them, 1200 floats of
// scratch. 100 2x2 pixel tiles x 2 halves of the input channels = 200 threads;
// the halves are added in a fixed order.
__device__ __forceinline__ void stage_rgb(const float* m, float* rgb, float* ws,
                                          const float* __restrict__ bd2, int clip) {
  constexpr int kTiles = kRgbS / 2;  // 10
  const int tid = threadIdx.x;
  const int half = tid / (kTiles * kTiles), pt = tid % (kTiles * kTiles);
  const int ty = pt / kTiles, tx = pt % kTiles;
  float* scratch = ws + kCh * 9 * 4;
  float acc[2][2][3] = {};
  if (half < 2) {
    const float* ip = m + 2 * ty * kMS + 2 * tx;
    for (int ci = half * (kCh / 2); ci < (half + 1) * (kCh / 2); ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float4 wv[3];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          wv[dx] = *reinterpret_cast<const float4*>(ws + (ci * 9 + dy * 3 + dx) * 4);
        float x[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* rp = ip + ci * kMS * kMS + (dy + r) * kMS;
          const float2 p = *reinterpret_cast<const float2*>(rp);
          const float2 q = *reinterpret_cast<const float2*>(rp + 2);
          x[r][0] = p.x; x[r][1] = p.y; x[r][2] = q.x; x[r][3] = q.y;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              acc[r][p][0] = fmaf(x[r][p + dx], wv[dx].x, acc[r][p][0]);
              acc[r][p][1] = fmaf(x[r][p + dx], wv[dx].y, acc[r][p][1]);
              acc[r][p][2] = fmaf(x[r][p + dx], wv[dx].z, acc[r][p][2]);
            }
      }
    }
    if (half == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int c = 0; c < 3; ++c) scratch[pt * 12 + (r * 2 + p) * 3 + c] = acc[r][p][c];
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float v = acc[r][p][c] + scratch[pt * 12 + (r * 2 + p) * 3 + c] + __ldg(bd2 + c);
          if (clip) v = fminf(fmaxf(v, 0.f), 1.f);
          rgb[c * kRgbS * kRgbS + (2 * ty + r) * kRgbS + 2 * tx + p] = v;
        }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
junction_kernel(const float* __restrict__ d, const float* __restrict__ wd1,
                const float* __restrict__ bd1, const float* __restrict__ wd2,
                const float* __restrict__ bd2, const float* __restrict__ we1,
                const float* __restrict__ be1, const float* __restrict__ we2,
                const float* __restrict__ be2, float* __restrict__ out, int h, int w,
                int deep, int clip) {
  extern __shared__ float4 smem4[];
  float* bufM = reinterpret_cast<float*>(smem4);
  float* bufE = bufM + kMFloats;
  float* rgb = bufE + kE1Floats;
  float* ws = rgb + kRgbFloats;
  int* ly = reinterpret_cast<int*>(ws + kWsFloats);
  int* lx = ly + kUS;
  float* dt = bufE;            // d tile [64][12][12]
  float* us = bufE + kDFloats; // u chunk [8][24][24]

  const int tid = threadIdx.x, lane = tid & 31, co0 = (tid >> 5) * 8;
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const int H = 2 * h, W = 2 * w;
  // d rows 8*by-2 .. 8*by+9 and columns 8*bx-2 .. 8*bx+9 feed u rows and
  // columns 16*b-4 .. 16*b+19 after the reflection at full resolution.
  const int dy0 = (kT / 2) * by - 2, dx0 = (kT / 2) * bx - 2;
  if (tid < kUS) ly[tid] = (reflect(kT * by - 4 + tid, H) >> 1) - dy0;
  if (tid >= 32 && tid < 32 + kUS) lx[tid - 32] = (reflect(kT * bx - 4 + tid - 32, W) >> 1) - dx0;
  const float* d_b = d + (size_t)b * kCh * h * w;
  for (int i = tid; i < kDFloats; i += kThreads) {
    const int c = i / (kDS * kDS), y = dy0 + (i / kDS) % kDS, x = dx0 + i % kDS;
    dt[i] = (y >= 0 && y < h && x >= 0 && x < w) ? __ldg(d_b + ((size_t)c * h + y) * w + x) : 0.f;
  }

  // ---- decoder conv 64->64 + relu on the upsampled tile: m, 22x22 ----
  {
    constexpr int kTiles = kMS / 2;  // 11
    int base[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = lane + 32 * k;
      const int tc = t < kTiles * kTiles ? t : 0;
      base[k] = 2 * (tc / kTiles) * kUS + 2 * (tc % kTiles);
    }
    float acc[4][2][2][8] = {};
    for (int c0 = 0; c0 < kCh; c0 += kChunk) {
      __syncthreads();
      copy4(ws, wd1 + c0 * kTapStride, kWsFloats);
      for (int i = tid; i < kChunk * kUS * kUS; i += kThreads) {
        const int c = i / (kUS * kUS), y = (i / kUS) % kUS, x = i % kUS;
        us[i] = dt[(c0 + c) * kDS * kDS + ly[y] * kDS + lx[x]];
      }
      __syncthreads();
      conv_accumulate<4>(us, kUS * kUS, kUS, kChunk, ws + co0, base, acc);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = lane + 32 * k;
      if (t >= kTiles * kTiles) continue;
      const int ty = t / kTiles, tx = t % kTiles;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float bias = __ldg(bd1 + co0 + c);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            bufM[(co0 + c) * kMS * kMS + (2 * ty + r) * kMS + 2 * tx + p] =
                fmaxf(acc[k][r][p][c] + bias, 0.f);
      }
    }
  }
  fix_halo(bufM, kCh, kMS, kT * by - 3, kT * bx - 3, H, W);

  // ---- decoder conv 64->3 (linear, optional clip): rgb, 20x20 ----
  copy4(ws, wd2, kCh * 9 * 4);
  __syncthreads();
  stage_rgb(bufM, rgb, ws, bd2, clip);
  fix_halo(rgb, 3, kRgbS, kT * by - 2, kT * bx - 2, H, W);

  // ---- encoder conv0∘conv1_1 + relu: e1, 18x18 ----
  copy4(ws, we1, 3 * kTapStride);
  __syncthreads();
  stage_e1(rgb, bufE, ws, be1);
  if (!deep) {  // the relu1_1 features of the tile are the output
    __syncthreads();
    float* out_b = out + (size_t)b * kCh * H * W;
    for (int i = tid; i < kCh * kT * kT; i += kThreads) {
      const int c = i / (kT * kT), y = (i / kT) % kT, x = i % kT;
      out_b[((size_t)c * H + kT * by + y) * W + kT * bx + x] =
          bufE[c * kE1S * kE1S + (y + 1) * kE1S + x + 1];
    }
    return;
  }
  fix_halo(bufE, kCh, kE1S, kT * by - 1, kT * bx - 1, H, W);

  // ---- encoder conv1_2 + relu + 2x2 max pool ----
  stage_e2_pool(bufE, ws, we2, be2, out + (size_t)b * kCh * h * w, h, w, by, bx);
}

}  // namespace wct

// d [B, 64, h, w] -> out [B, 64, h, w] (deep) or [B, 64, 2h, 2w] (shallow).
// Weights: wd1, we2 [64][9][64] and we1 [3][9][64] as [ci][tap][co];
// wd2 [64][9][4] with co padded to 4. Returns the CUDA error of the launch.
extern "C" int junction_f32(const float* d, const float* wd1, const float* bd1,
                            const float* wd2, const float* bd2, const float* we1,
                            const float* be1, const float* we2, const float* be2,
                            float* out, int B, int h, int w, int deep, int clip,
                            void* stream) {
  cudaError_t err = cudaFuncSetAttribute(wct::junction_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wct::kJunctionSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(2 * w / wct::kT, 2 * h / wct::kT, B);
  wct::junction_kernel<<<grid, wct::kThreads, wct::kJunctionSmem, (cudaStream_t)stream>>>(
      d, wd1, bd1, wd2, bd2, we1, be1, we2, be2, out, h, w, deep, clip);
  return (int)cudaGetLastError();
}
