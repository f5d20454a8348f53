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
// image, 40.5 GFLOP at 512 px; at batch 4, 162 GFLOP against 268 MB of d read
// and 268 MB written (0.16 ms). The two 64->64 convs are 96 % of the FLOP and
// run on the tensor cores in 3xTF32: each f32 operand is split into
// hi = tf32(x) and lo = tf32(x - hi), and mma.sync.m16n8k8 (tf32 -> f32) adds
// lo*hi + hi*lo + hi*hi, which keeps about f32's accuracy where one TF32 pass
// keeps three digits. Three passes at the TF32 rate, 3 * 162 GFLOP /
// 495 TFLOP/s = 0.98 ms, is the bound this design runs under (fp32 FFMA's was
// 2.42 ms). The 64->3 and 3->64 stages (4 %) stay FFMA.
//
// Each conv is an implicit GEMM over the block's tile: M = the pixels of the
// stage's region in raster order, N = 64 output channels (8 n-tiles), K = 9
// taps x 64 input channels, tap-major. Warp w owns m-tiles w, w+8, ... of the
// region and all of N, so an A value is loaded from shared memory and split
// once and feeds 8 n-tiles; its B fragments (the weights, split into hi and lo
// on the host and laid out in fragment order) come from shared memory, 16
// bytes per lane and n-tile. m's A values are read from the d tile through the
// upsample tables, so u is never stored.
//
// The weights stream through a ring of three 16 KB slots with cp.async (four
// k-steps of 8 channels per slot: the next two slots are in flight behind the
// mma's), and the shared memory this needs comes from e1 living where m was
// (m is dead once rgb exists):
//
//   bufM  m [64][22][22], later e1 [64][18][18]               123,904 B
//   dt    the d tile [64][12][12], plane padded to 148 floats  37,888 B
//         (later the 64->3 stage's partial sums, 4,800 B)
//   rgb   [3][20][20]                                           4,800 B
//   ring  3 x 16 KB: m's weights, then wd2 and we1, then
//         conv1_2's weights                                    49,152 B
//   reflect+upsample index tables                                 192 B
//                                                               215,936 B
//
// Accuracy: the tensor cores sum each mma's products and accumulator with
// truncation, so an accumulator that takes all 216 mma's of a conv (72 k-steps
// x 3 passes) drifts toward zero by up to an ulp of the running sum per mma;
// through the 64->3 and conv0 stages (O(255) weights) that reached 8e-5 of the
// output's max against plain. Each k-step's three passes therefore go into a
// fresh partial that a rounded f32 add folds into the sum: the kernel then
// stays within 1.7e-5 of a float64 evaluation at every case chip_smoke.py
// checks, where cuDNN's f32 chain is up to 4.5e-5 off, for about a fifth
// more time.
//
// What bounds it: the tensor cores in three passes, plus the halo (m on 22x22
// for 16x16 of output costs 1.45x the MMAs of the two convs on the tile
// alone), the partials' adds, and 255 registers a thread. Each k-step's A and
// B come from shared memory, and one 16x16 tile's f32 chain fills the SM's
// shared memory, so one block of 8 warps runs per SM and nothing hides its
// loads but its own ring. The FFMA stages and each block's first loads take
// the rest.
//
// The summation order of every output is fixed (taps, then input channels in
// steps of 8, each a partial of lo*hi, hi*lo, hi*hi in each mma's own order),
// there are no atomics, and nothing depends on the batch: an image gives the
// same bits alone and in any batch. Operands are f32; a bf16-operand form
// (ROADMAP queue 1 item 5c) would take bf16 mma's on the same tiling.
//
// Grid (W/16, H/16, B), 256 threads, one block per SM.

#include "conv_tiles.cuh"
#include "ptx.cuh"

namespace wct {

constexpr int kMS = kT + 6;   // m region edge (halo 3)
constexpr int kUS = kT + 8;   // u region edge (halo 4)
constexpr int kDS = kUS / 2;  // d tile edge
constexpr int kDPlane = kDS * kDS + 4;  // 148: A loads of 4 channels hit 4 bank groups
constexpr int kMPix = kMS * kMS;        // 484 pixels of m: 31 m-tiles of 16
constexpr int kMTiles = (kMPix + 15) / 16;
constexpr int kMFloats = kCh * kMPix;
constexpr int kDFloats = kCh * kDPlane;
constexpr int kSlotFloats = 4096;       // 16 KB: 4 k-steps x 8 n-tiles x 32 lanes x 4
constexpr int kSlots = 3;
constexpr int kConvChunks = 18;         // 9 taps x 2 halves of 32 input channels
constexpr int kJunctionSmem =
    (kMFloats + kDFloats + kRgbFloats + kSlots * kSlotFloats) * 4 + 2 * kUS * 4;
static_assert(kE1Floats <= kMFloats, "e1 lives where m was");
static_assert(kCh * 9 * 4 + 3 * kTapStride <= kSlotFloats, "wd2 and we1 share one slot");
static_assert(kRgbFloats <= kDFloats, "the 64->3 partial sums fit the d tile");
static_assert(kJunctionSmem <= 232448, "one block's shared memory on sm_90");

// m [64][22][22] (halo fixed) -> rgb [3][20][20] = conv 64->3 (+clip). ws holds
// the weights [64][9][4] (co padded to 4); scratch takes 1200 floats. 100 2x2
// pixel tiles x 2 halves of the input channels = 200 threads; the halves are
// added in a fixed order.
__device__ __forceinline__ void stage_rgb(const float* m, float* rgb, const float* ws,
                                          float* scratch, const float* __restrict__ bd2, int clip) {
  constexpr int kTiles = kRgbS / 2;  // 10
  const int tid = threadIdx.x;
  const int half = tid / (kTiles * kTiles), pt = tid % (kTiles * kTiles);
  const int ty = pt / kTiles, tx = pt % kTiles;
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

// The weight stream, one 16 KB slot per position q: m's conv (q < 18, tap q/2,
// input channels 32 (q%2) ..), then wd2 [64][9][4] and we1 [3][9][64] (q = 18),
// then conv1_2 (19 <= q < 37, deep only). Every thread commits one group per
// call, loads or not, so that wait_group counts positions.
__device__ __forceinline__ void fetch_slot(int q, float* ring, const float* __restrict__ wd1f,
                                           const float* __restrict__ wd2,
                                           const float* __restrict__ we1,
                                           const float* __restrict__ we2f, int deep) {
  const uint32_t dst = smem_addr(ring + (q % kSlots) * kSlotFloats);
  const float* src = nullptr;
  if (q < kConvChunks) {
    src = wd1f + (size_t)q * kSlotFloats;
  } else if (q == kConvChunks) {
    constexpr int n2 = kCh * 9 * 4 / 4, n3 = 3 * kTapStride / 4;  // 16-byte copies
    for (int i = threadIdx.x; i < n2 + n3; i += kThreads)
      cp_async16(dst + i * 16, i < n2 ? wd2 + 4 * i : we1 + 4 * (i - n2));
  } else if (deep && q < 2 * kConvChunks + 1) {
    src = we2f + (size_t)(q - kConvChunks - 1) * kSlotFloats;
  }
  if (src != nullptr)
    for (int i = threadIdx.x; i < kSlotFloats / 4; i += kThreads) cp_async16(dst + i * 16, src + 4 * i);
  cp_async_commit();
}

// Wait for stream position q, make it visible to the block, and put q + 2 in
// flight in the slot that q - 1 used (every warp is past it: the barrier).
__device__ __forceinline__ const float* take_slot(int q, float* ring, const float* __restrict__ wd1f,
                                                  const float* __restrict__ wd2,
                                                  const float* __restrict__ we1,
                                                  const float* __restrict__ we2f, int deep) {
  cp_async_wait<1>();
  __syncthreads();
  fetch_slot(q + 2, ring, wd1f, wd2, we1, we2f, deep);
  return ring + (q % kSlots) * kSlotFloats;
}

// One k-step of 8 input channels for NM m-tiles x 8 n-tiles in 3xTF32. a_at(mt,
// e) is the shared-memory float at row g + 8 (e & 1), channel t + 4 (e >> 1) of
// m-tile mt (g = lane / 4, t = lane % 4); slot holds this k-step's B fragments.
template <int NM, typename AAt>
__device__ __forceinline__ void mma_kstep_3xtf32(float (&acc)[NM][8][4], const float* slot,
                                                 int lane, int live, AAt a_at) {
  uint32_t bh[8][2], bl[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float4 v = *reinterpret_cast<const float4*>(slot + (nt * 32 + lane) * 4);
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
    // The k-step's three passes go into a fresh partial, added to the sum
    // with a rounded f32 add: the tensor cores truncate their own sums,
    // which against the whole running sum would bias it at every k-step.
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

__global__ void __launch_bounds__(kThreads, 1)
junction_kernel(const float* __restrict__ d, const float* __restrict__ wd1f,
                const float* __restrict__ bd1, const float* __restrict__ wd2,
                const float* __restrict__ bd2, const float* __restrict__ we1,
                const float* __restrict__ be1, const float* __restrict__ we2f,
                const float* __restrict__ be2, float* __restrict__ out, int h, int w,
                int deep, int clip) {
  extern __shared__ float4 smem4[];
  float* bufM = reinterpret_cast<float*>(smem4);
  float* bufE = bufM;  // e1 replaces m
  float* dt = bufM + kMFloats;
  float* rgb = dt + kDFloats;
  float* ring = rgb + kRgbFloats;
  int* ly = reinterpret_cast<int*>(ring + kSlots * kSlotFloats);
  int* lx = ly + kUS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const int H = 2 * h, W = 2 * w;
  // d rows 8*by-2 .. 8*by+9 and columns 8*bx-2 .. 8*bx+9 feed u rows and
  // columns 16*b-4 .. 16*b+19 after the reflection at full resolution.
  const int dy0 = (kT / 2) * by - 2, dx0 = (kT / 2) * bx - 2;
  if (tid < kUS) ly[tid] = (reflect(kT * by - 4 + tid, H) >> 1) - dy0;
  if (tid >= 32 && tid < 32 + kUS) lx[tid - 32] = (reflect(kT * bx - 4 + tid - 32, W) >> 1) - dx0;
  {
    // The d tile, 8 bytes (2 columns) per copy; dx0 and w are even, so a pair
    // is in the map or out whole. Pairs outside are zero and never read.
    const float* d_b = d + (size_t)b * kCh * h * w;
    const uint32_t base = smem_addr(dt);
    for (int i = tid; i < kCh * kDS * (kDS / 2); i += kThreads) {
      const int c = i / (kDS * kDS / 2), y = (i / (kDS / 2)) % kDS, x = 2 * (i % (kDS / 2));
      const int gy = dy0 + y, gx = dx0 + x;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      cp_async8(base + (c * kDPlane + y * kDS + x) * 4,
                in ? d_b + ((size_t)c * h + gy) * w + gx : d_b, in ? 8 : 0);
    }
  }
  fetch_slot(0, ring, wd1f, wd2, we1, we2f, deep);  // with the d tile
  fetch_slot(1, ring, wd1f, wd2, we1, we2f, deep);

  // ---- decoder conv 64->64 + relu on the upsampled tile: m, 22x22 ----
  {
    constexpr int kNM = (kMTiles + 7) / 8;  // 4 (warp 7: 3)
    const int live = (kMTiles - warp + 7) / 8;
    float acc[kNM][8][4] = {};
    int pyx[kNM][2];  // (row << 8) | column of each of the lane's pixels in m
#pragma unroll
    for (int mt = 0; mt < kNM; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = min((warp + 8 * mt) * 16 + g + 8 * r, kMPix - 1);
        pyx[mt][r] = (p / kMS) << 8 | p % kMS;
      }
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      int off[kNM][2];  // d-tile offset of each of the lane's rows, this tap
#pragma unroll
      for (int mt = 0; mt < kNM; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          off[mt][r] = ly[(pyx[mt][r] >> 8) + dy] * kDS + lx[(pyx[mt][r] & 255) + dx];
      for (int half = 0; half < 2; ++half) {
        const float* slot = take_slot(2 * tap + half, ring, wd1f, wd2, we1, we2f, deep);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* a_base = dt + (32 * half + 8 * j + t) * kDPlane;
          mma_kstep_3xtf32<kNM>(acc, slot + j * 8 * 32 * 4, lane, live,
                                [&](int mt, int e) { return a_base[(e >> 1) * 4 * kDPlane + off[mt][e & 1]]; });
        }
      }
    }
    // acc[mt][nt][2r + e]: pixel 16 (warp + 8 mt) + g + 8 r, channel 8 nt + 2 t + e.
#pragma unroll
    for (int mt = 0; mt < kNM; ++mt) {
      if (mt >= live) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = (warp + 8 * mt) * 16 + g + 8 * r;
        if (p >= kMPix) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = 8 * nt + 2 * t + e;
            bufM[co * kMPix + p] = fmaxf(acc[mt][nt][2 * r + e] + __ldg(bd1 + co), 0.f);
          }
      }
    }
  }
  fix_halo(bufM, kCh, kMS, kT * by - 3, kT * bx - 3, H, W);

  // ---- decoder conv 64->3 (linear, optional clip): rgb, 20x20 ----
  const float* ws = take_slot(kConvChunks, ring, wd1f, wd2, we1, we2f, deep);
  stage_rgb(bufM, rgb, ws, dt, bd2, clip);
  fix_halo(rgb, 3, kRgbS, kT * by - 2, kT * bx - 2, H, W);

  // ---- encoder conv0∘conv1_1 + relu: e1, 18x18 (over m, which is dead) ----
  stage_e1(rgb, bufE, ws + kCh * 9 * 4, be1);
  if (!deep) {  // the relu1_1 features of the tile are the output
    __syncthreads();
    float* out_b = out + (size_t)b * kCh * H * W;
    for (int i = tid; i < kCh * kT * kT; i += kThreads) {
      const int c = i / (kT * kT), y = (i / kT) % kT, x = i % kT;
      out_b[((size_t)c * H + kT * by + y) * W + kT * bx + x] =
          bufE[c * kE1S * kE1S + (y + 1) * kE1S + x + 1];
    }
    cp_async_wait<0>();  // nothing of the stream is left in flight at exit
    return;
  }
  fix_halo(bufE, kCh, kE1S, kT * by - 1, kT * bx - 1, H, W);

  // ---- encoder conv1_2 + relu + 2x2 max pool ----
  // Warp w owns tile rows 2w and 2w+1 (m-tiles 0 and 1): the pool's vertical
  // max is in registers, its horizontal max one shuffle away (lane ^ 4).
  {
    float acc[2][8][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      for (int half = 0; half < 2; ++half) {
        const float* slot =
            take_slot(kConvChunks + 1 + 2 * tap + half, ring, wd1f, wd2, we1, we2f, deep);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* a_base =
              bufE + (32 * half + 8 * j + t) * kE1S * kE1S + (2 * warp + dy) * kE1S + g + dx;
          mma_kstep_3xtf32<2>(acc, slot + j * 8 * 32 * 4, lane, 2, [&](int mt, int e) {
            return a_base[(e >> 1) * 4 * kE1S * kE1S + mt * kE1S + 8 * (e & 1)];
          });
        }
      }
    }
    float* out_b = out + (size_t)b * kCh * h * w;
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
          out_b[((size_t)(8 * nt + 2 * t + (e & 1)) * h + oy) * w + ox] = v;
        }
      }
  }
  cp_async_wait<0>();
}

}  // namespace wct

// d [B, 64, h, w] -> out [B, 64, h, w] (deep) or [B, 64, 2h, 2w] (shallow).
// wd1f, we2f: the 64->64 convs as 3xTF32 B fragments, [tap][k-step of 8 input
// channels][n-tile][lane][hi0, hi1, lo0, lo1] f32 (ops/junction.py::_tc_frags);
// wd2 [64][9][4] with co padded to 4 and we1 [3][9][64], [ci][tap][co]. Returns
// the CUDA error of the launch.
extern "C" int junction_f32(const float* d, const float* wd1f, const float* bd1,
                            const float* wd2, const float* bd2, const float* we1,
                            const float* be1, const float* we2f, const float* be2,
                            float* out, int B, int h, int w, int deep, int clip,
                            void* stream) {
  cudaError_t err = cudaFuncSetAttribute(wct::junction_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wct::kJunctionSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(2 * w / wct::kT, 2 * h / wct::kT, B);
  wct::junction_kernel<<<grid, wct::kThreads, wct::kJunctionSmem, (cudaStream_t)stream>>>(
      d, wd1f, bd1, wd2, bd2, we1, be1, we2f, be2, out, h, w, deep, clip);
  return (int)cudaGetLastError();
}
