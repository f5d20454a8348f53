// The fused cascade junction: decoder tail -> encoder head, one launch, in f32
// or bf16 operands.
//
// Replaces the TPU kernel wct_tpu/ops/junction_pallas.py::junction
// (_junction_kernel), which computes in the operand type of its input. On
// d [B, 64, h, w] (NCHW, f32 or bf16) it computes
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
// unfused chain writes and reads five full-resolution 64-channel maps. Under
// bf16 every conv sums exact products in f32, adds its f32 bias, applies the
// ReLU and rounds once to bf16, and m, rgb and e1 are bf16 (rgb held as f32
// values that are bf16 ones); the weights come rounded to bf16 from the host.
//
// Bound on an H100: operations. 2*H*W*9*(64*64 + 64*3 + 3*64 + 64*64) FLOP per
// image, 40.5 GFLOP at 512 px; at batch 4, 162 GFLOP. f32: the two 64->64
// convs (96 % of the FLOP) run in 3xTF32, three passes at 495 TFLOP/s, 0.98
// ms, against 268 MB of d read and 268 MB written (0.16 ms). bf16: one pass at
// 989 TFLOP/s, 0.164 ms, against 134 + 134 MB (0.08 ms). The 64->3 and 3->64
// stages stay FFMA (conv_tc.cuh has the stages and the k-steps of both types).
//
// Each 64->64 conv is an implicit GEMM over the block's tile: M = the pixels
// of the stage's region in raster order, N = 64 output channels (8 n-tiles),
// K = 9 taps x 64 input channels, tap-major. Warp w owns m-tiles w, w+8, ...
// of the region and all of N. m's A values are read from the d tile through
// the upsample tables, so u is never stored: f32 per element from the planar
// d tile, bf16 by ldmatrix from a channel-minor copy of it (one row address
// per lane, taken through the tables). The weights stream through the ring of
// conv_tc.cuh: m's conv, then wd2 and we1 (one 16 KB slot), then conv1_2's.
//
// Shared memory (e1 lives where m was: m is dead once rgb exists):
//
//                                                 f32                bf16
//   bufM  m [22 x 22], later e1 [18 x 18]         123,904 (planar)   69,696 (x 144 B)
//         (bf16: first the d tile as loaded, [64][12][12], 18,432)
//   dt    the d tile [12 x 12]                    37,888 (planes     20,736 (x 144 B)
//         (later the 64->3 stage's partials)       padded to 148)
//   rgb   [3][20][20] f32                          4,800              4,800
//   ring  3 x 16 KB                               49,152             49,152
//   reflect+upsample index tables                    192                192
//                                                215,936            144,576
//
// Accuracy: the tensor cores truncate their sums, so an accumulator that
// took all of a conv's mma's drifts toward zero, and the 64->3 and conv0
// stages (O(255) weights) amplify it. f32: 216 mma's (72 k-steps x 3 passes)
// reached 8e-5 of the output's max against plain; with a fresh partial per
// k-step the kernel stays within 1.7e-5 of a float64 evaluation where cuDNN's
// f32 chain is up to 4.5e-5 off. bf16 keeps the partials too (conv_tc.cuh
// says why).
//
// Blocks per SM: one, for both types. Under bf16 the shared memory would
// allow more than one block only below 115,712 bytes (two blocks and their
// reserved 1 KB each in the SM's 228 KB), and a block of 8 warps that each
// hold 4 m-tiles x 8 n-tiles of f32 accumulators (128 registers) plus their
// fragments needs more than the 128 registers a thread that two blocks
// allow. So the bf16 form keeps the f32 form's tiling and one block per SM,
// and the 71 KB it frees stay unused; its gain is the single pass and the
// halved A and B traffic (1.47 ms per launch at [4, 64, 256, 256] against
// f32's 4.7; PERF.md).
//
// The summation order of every output is fixed, there are no atomics, and
// nothing depends on the batch: an image gives the same bits alone and in any
// batch.
//
// Grid (W/16, H/16, B), 256 threads, one block per SM.

#include "conv_tc.cuh"

namespace wct {

constexpr int kMS = kT + 6;   // m region edge (halo 3)
constexpr int kUS = kT + 8;   // u region edge (halo 4)
constexpr int kDS = kUS / 2;  // d tile edge
constexpr int kDPix = kDS * kDS;
constexpr int kDPlane = kDPix + 4;  // f32: 148, so that A loads of 4 channels hit 4 bank groups
constexpr int kMPix = kMS * kMS;    // 484 pixels of m: 31 m-tiles of 16
constexpr int kMTiles = (kMPix + 15) / 16;
constexpr int kJSlot = 16384;       // the ring's slot: a chunk, or wd2 and we1 (16,128 B)
constexpr int kSmallFloats = kCh * 9 * 4 + 3 * kTapStride;

template <typename T>
__host__ __device__ constexpr int m_bytes() {
  return map_bytes<T>(kMPix);
}

template <typename T>
__host__ __device__ constexpr int d_bytes() {
  return is_f32<T>() ? kCh * kDPlane * 4 : kDPix * kPitch * 2;
}

template <typename T>
__host__ __device__ constexpr int junction_smem() {
  return m_bytes<T>() + d_bytes<T>() + kRgbFloats * 4 + kSlots * kJSlot + 2 * kUS * 4;
}

static_assert(map_bytes<float>(kE1S * kE1S) <= m_bytes<float>(), "e1 lives where m was");
static_assert(map_bytes<bf16>(kE1S * kE1S) <= m_bytes<bf16>(), "e1 lives where m was");
static_assert(kCh * kDPix * 2 <= m_bytes<bf16>(), "the loaded d tile fits where m will be");
static_assert(kSmallFloats * 4 <= kJSlot, "wd2 and we1 share one slot");
static_assert(Tc<float>::kChunkBytes <= kJSlot && Tc<bf16>::kChunkBytes <= kJSlot, "chunks fit a slot");
static_assert(kRgbFloats * 4 <= d_bytes<bf16>(), "the 64->3 partial sums fit the d tile");
static_assert(junction_smem<float>() <= 232448, "one block's shared memory on sm_90");

// m [22 x 22] (halo fixed) -> rgb [3][20][20] f32 = conv 64->3 (+clip), rounded
// to T. ws holds the weights [64][9][4] (co padded to 4); scratch takes 1200
// floats. 100 2x2 pixel tiles x 2 halves of the input channels = 200 threads;
// the halves are added in a fixed order.
template <typename T>
__device__ __forceinline__ void stage_rgb(const T* m, float* rgb, const float* ws, float* scratch,
                                          const float* __restrict__ bd2, int clip) {
  constexpr int kTiles = kRgbS / 2;  // 10
  const int tid = threadIdx.x;
  const int half = tid / (kTiles * kTiles), pt = tid % (kTiles * kTiles);
  const int ty = pt / kTiles, tx = pt % kTiles;
  float acc[2][2][3] = {};
  if (half < 2) {
    if constexpr (is_f32<T>()) {
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
    } else {
      // Channel-minor m: a 16-byte load brings 8 channels of a pixel.
      for (int cg = half * 4; cg < half * 4 + 4; ++cg) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x[4][8];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const uint4 v = *reinterpret_cast<const uint4*>(
                  m + ((2 * ty + dy + r) * kMS + 2 * tx + c) * kPitch + 8 * cg);
              const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                x[c][2 * k] = bf16_lo(u[k]);
                x[c][2 * k + 1] = bf16_hi(u[k]);
              }
            }
#pragma unroll
            for (int k = 0; k < 8; ++k)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const float4 wv =
                    *reinterpret_cast<const float4*>(ws + ((8 * cg + k) * 9 + dy * 3 + dx) * 4);
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                  acc[r][p][0] = fmaf(x[p + dx][k], wv.x, acc[r][p][0]);
                  acc[r][p][1] = fmaf(x[p + dx][k], wv.y, acc[r][p][1]);
                  acc[r][p][2] = fmaf(x[p + dx][k], wv.z, acc[r][p][2]);
                }
              }

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
          rgb[c * kRgbS * kRgbS + (2 * ty + r) * kRgbS + 2 * tx + p] = as_operand<T>(v);
        }
  }
}

// The d tile: rows 8*by-2 .. 8*by+9 and columns 8*bx-2 .. 8*bx+9 of image b,
// zero outside the map (never read). f32 straight into the planar tile, 8
// bytes (2 columns) per copy; bf16 as it lies in memory ([64][12][12], 4
// bytes per copy) into `raw`, for transpose_d. dx0 and w are even, so a pair
// is in the map or out whole. Commits one group.
template <typename T>
__device__ __forceinline__ void load_d(const T* __restrict__ d_b, T* dt, T* raw, int dy0, int dx0,
                                       int h, int w) {
  const uint32_t base = smem_addr(is_f32<T>() ? dt : raw);
  for (int i = threadIdx.x; i < kCh * kDS * (kDS / 2); i += kThreads) {
    const int c = i / (kDPix / 2), y = (i / (kDS / 2)) % kDS, x = 2 * (i % (kDS / 2));
    const int gy = dy0 + y, gx = dx0 + x;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const T* src = in ? d_b + ((size_t)c * h + gy) * w + gx : d_b;
    if constexpr (is_f32<T>())
      cp_async8(base + (c * kDPlane + y * kDS + x) * 4, src, in ? 8 : 0);
    else
      cp_async4(base + (c * kDPix + y * kDS + x) * 2, src, in ? 4 : 0);
  }
  cp_async_commit();
}

// bf16: the loaded d tile [64][144] -> channel-minor dt [144][kPitch].
__device__ __forceinline__ void transpose_d(const bf16* raw, bf16* dt) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(raw);
  for (int i = threadIdx.x; i < kDPix * kCh / 2; i += kThreads) {
    const int px = i % kDPix, c = 2 * (i / kDPix);
    *reinterpret_cast<uint32_t*>(dt + px * kPitch + c) =
        (uint32_t)r[c * kDPix + px] | ((uint32_t)r[(c + 1) * kDPix + px] << 16);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
junction_kernel(const T* __restrict__ d, const unsigned char* __restrict__ wd1f,
                const float* __restrict__ bd1, const float* __restrict__ wd2,
                const float* __restrict__ bd2, const float* __restrict__ we1,
                const float* __restrict__ be1, const unsigned char* __restrict__ we2f,
                const float* __restrict__ be2, T* __restrict__ out, int h, int w, int deep,
                int clip) {
  constexpr int kChunks = Tc<T>::kChunks, kChunkBytes = Tc<T>::kChunkBytes;
  constexpr int kPerTap = kChunks / 9;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  T* bufM = reinterpret_cast<T*>(base);
  T* bufE = bufM;  // e1 replaces m
  T* dt = reinterpret_cast<T*>(base + m_bytes<T>());
  float* rgb = reinterpret_cast<float*>(base + m_bytes<T>() + d_bytes<T>());
  unsigned char* ring = reinterpret_cast<unsigned char*>(rgb + kRgbFloats);
  int* ly = reinterpret_cast<int*>(ring + kSlots * kJSlot);
  int* lx = ly + kUS;
  const WeightStream ws{wd1f, kChunks, wd2, kCh * 9 * 4, we1, 3 * kTapStride,
                        we2f, deep ? kChunks : 0};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const int H = 2 * h, W = 2 * w;
  // d rows 8*by-2 .. 8*by+9 and columns 8*bx-2 .. 8*bx+9 feed u rows and
  // columns 16*b-4 .. 16*b+19 after the reflection at full resolution.
  const int dy0 = (kT / 2) * by - 2, dx0 = (kT / 2) * bx - 2;
  if (tid < kUS) ly[tid] = (reflect(kT * by - 4 + tid, H) >> 1) - dy0;
  if (tid >= 32 && tid < 32 + kUS) lx[tid - 32] = (reflect(kT * bx - 4 + tid - 32, W) >> 1) - dx0;
  load_d<T>(d + (size_t)b * kCh * h * w, dt, bufM, dy0, dx0, h, w);
  fetch_slot<kJSlot, kChunkBytes>(0, ring, ws);
  fetch_slot<kJSlot, kChunkBytes>(1, ring, ws);
  if constexpr (!is_f32<T>()) cp_async_wait<2>();  // the d tile; two weight chunks may still fly
  __syncthreads();  // the index tables (bf16: and the d tile as loaded)
  if constexpr (!is_f32<T>()) transpose_d(bufM, dt);  // the first take_slot's barrier orders it

  // ---- decoder conv 64->64 + relu on the upsampled tile: m, 22x22 ----
  {
    constexpr int kNM = (kMTiles + 7) / 8;  // 4 (warp 7: 3)
    const int live = (kMTiles - warp + 7) / 8;
    float acc[kNM][8][4] = {};
    // (row << 8) | column in m of the lane's pixels: f32 rows g and g + 8 of
    // each m-tile, bf16 its ldmatrix row (pixel lane % 16).
    int pyx[kNM][2];
#pragma unroll
    for (int mt = 0; mt < kNM; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int in_tile = is_f32<T>() ? g + 8 * r : (lane & 15);
        const int p = min((warp + 8 * mt) * 16 + in_tile, kMPix - 1);
        pyx[mt][r] = (p / kMS) << 8 | p % kMS;
      }
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      int off[kNM][2];  // d-tile pixel of each of the lane's rows, this tap
#pragma unroll
      for (int mt = 0; mt < kNM; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          off[mt][r] = ly[(pyx[mt][r] >> 8) + dy] * kDS + lx[(pyx[mt][r] & 255) + dx];
      for (int part = 0; part < kPerTap; ++part) {
        const T* slot = reinterpret_cast<const T*>(
            take_slot<kJSlot, kChunkBytes>(kPerTap * tap + part, ring, ws));
#pragma unroll
        for (int j = 0; j < kStepsPerChunk; ++j) {
          const T* step = slot + j * kChunkBytes / kStepsPerChunk / sizeof(T);
          if constexpr (is_f32<T>()) {
            const float* a_base = dt + (32 * part + 8 * j + t) * kDPlane;
            mma_kstep<kNM>(acc, step, lane, live, [&](int mt, int e) {
              return a_base[(e >> 1) * 4 * kDPlane + off[mt][e & 1]];
            });
          } else {
            const uint32_t a_base = smem_addr(dt + 16 * j + 8 * (lane >> 4));
            mma_kstep<kNM>(acc, step, lane, live, [&](int mt) {
              return a_base + off[mt][0] * kPitch * (uint32_t)sizeof(T);
            });
          }
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
        for (int nt = 0; nt < 8; ++nt) {
          const int co = 8 * nt + 2 * t;
          store_pair(bufM, kMPix, p, co, fmaxf(acc[mt][nt][2 * r] + __ldg(bd1 + co), 0.f),
                     fmaxf(acc[mt][nt][2 * r + 1] + __ldg(bd1 + co + 1), 0.f));
        }
      }
    }
  }
  fix_halo(bufM, kMS, kT * by - 3, kT * bx - 3, H, W);

  // ---- decoder conv 64->3 (linear, optional clip): rgb, 20x20 ----
  const float* small = reinterpret_cast<const float*>(take_slot<kJSlot, kChunkBytes>(kChunks, ring, ws));
  stage_rgb<T>(bufM, rgb, small, reinterpret_cast<float*>(dt), bd2, clip);
  fix_halo(rgb, 3, kRgbS, kT * by - 2, kT * bx - 2, H, W);

  // ---- encoder conv0∘conv1_1 + relu: e1, 18x18 (over m, which is dead) ----
  stage_e1<T>(rgb, bufE, small + kCh * 9 * 4, be1);
  if (!deep) {  // the relu1_1 features of the tile are the output
    __syncthreads();
    T* out_b = out + (size_t)b * kCh * H * W;
    for (int i = tid; i < kCh * kT * kT; i += kThreads) {
      const int c = i / (kT * kT), y = (i / kT) % kT, x = i % kT;
      const int pix = (y + 1) * kE1S + x + 1;
      out_b[((size_t)c * H + kT * by + y) * W + kT * bx + x] =
          is_f32<T>() ? bufE[c * kE1S * kE1S + pix] : bufE[pix * kPitch + c];
    }
    cp_async_wait<0>();  // nothing of the stream is left in flight at exit
    return;
  }
  fix_halo(bufE, kE1S, kT * by - 1, kT * bx - 1, H, W);

  // ---- encoder conv1_2 + relu + 2x2 max pool ----
  stage_e2_pool<T, kJSlot>(bufE, ring, ws, kChunks + 1, be2, out + (size_t)b * kCh * h * w, h, w,
                           by, bx);
  cp_async_wait<0>();
}

template <typename T>
int launch_junction(const void* d, const void* wd1f, const float* bd1, const float* wd2,
                    const float* bd2, const float* we1, const float* be1, const void* we2f,
                    const float* be2, void* out, int B, int h, int w, int deep, int clip,
                    void* stream) {
  auto kernel = junction_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         junction_smem<T>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(2 * w / kT, 2 * h / kT, B);
  kernel<<<grid, kThreads, junction_smem<T>(), (cudaStream_t)stream>>>(
      static_cast<const T*>(d), static_cast<const unsigned char*>(wd1f), bd1, wd2, bd2, we1, be1,
      static_cast<const unsigned char*>(we2f), be2, static_cast<T*>(out), h, w, deep, clip);
  return (int)cudaGetLastError();
}

}  // namespace wct

// d [B, 64, h, w] -> out [B, 64, h, w] (deep) or [B, 64, 2h, 2w] (shallow), in
// the operand type of the entry point. wd1f, we2f: the 64->64 convs as B
// fragments (f32: 3xTF32 [tap][k-step of 8][n-tile][lane][hi0, hi1, lo0, lo1],
// ops/junction.py::_tc_frags; bf16: [tap][k-step of 16][n-tile pair][lane][8],
// _tc_frags_bf16); wd2 [64][9][4] with co padded to 4 and we1 [3][9][64],
// [ci][tap][co], f32 (bf16 values for the bf16 entry). Returns the CUDA error
// of the launch.
extern "C" int junction_f32(const float* d, const float* wd1f, const float* bd1,
                            const float* wd2, const float* bd2, const float* we1,
                            const float* be1, const float* we2f, const float* be2,
                            float* out, int B, int h, int w, int deep, int clip,
                            void* stream) {
  return wct::launch_junction<float>(d, wd1f, bd1, wd2, bd2, we1, be1, we2f, be2, out, B, h, w,
                                     deep, clip, stream);
}

extern "C" int junction_bf16(const void* d, const void* wd1f, const float* bd1,
                             const float* wd2, const float* bd2, const float* we1,
                             const float* be1, const void* we2f, const float* be2, void* out,
                             int B, int h, int w, int deep, int clip, void* stream) {
  return wct::launch_junction<wct::bf16>(d, wd1f, bd1, wd2, bd2, we1, be1, we2f, be2, out, B, h,
                                         w, deep, clip, stream);
}

// The form's shared memory per block and the blocks an SM holds at once on
// the current device (bf16 != 0: the bf16 form). Returns the CUDA error.
extern "C" int junction_plan(int bf16, int* smem_bytes, int* blocks_per_sm) {
  return bf16 ? wct::kernel_plan(wct::junction_kernel<wct::bf16>, wct::junction_smem<wct::bf16>(),
                                 smem_bytes, blocks_per_sm)
              : wct::kernel_plan(wct::junction_kernel<float>, wct::junction_smem<float>(),
                                 smem_bytes, blocks_per_sm);
}
