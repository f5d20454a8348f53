// The fused cascade junction: decoder tail -> encoder head, one launch, in f32
// or bf16 operands, its 64->64 convs on Hopper's wgmma.
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
// borders keep that exact). No intermediate touches device memory. Under
// bf16 every conv sums exact products in f32, adds its f32 bias, applies the
// ReLU and rounds once to bf16, and m, rgb and e1 are bf16 (rgb held as f32
// values that are bf16 ones); the weights come rounded to bf16 from the host.
//
// Bound on an H100: operations. 2*H*W*9*(64*64 + 64*3 + 3*64 + 64*64) FLOP per
// image, 40.5 GFLOP at 512 px; at batch 4, 162 GFLOP. f32: the two 64->64
// convs (96 % of the FLOP) run in 3xTF32, three passes at 495 TFLOP/s, 0.98
// ms, against 268 MB of d read and 268 MB written (0.16 ms). bf16: one pass at
// 989 TFLOP/s, 0.164 ms, against 134 + 134 MB (0.08 ms).
//
// Design. A block of two warpgroups owns a 16x16 output tile and computes
// each stage on the region the next one needs:
//
//   u  [24 x 24]  the upsampled d tile, never stored (read through ly, lx)
//   m  [22 x 22]  decoder conv 64->64 + relu          (halo 3)
//   rgb [20 x 20] decoder conv 64->3 (+clip), f32      (halo 2)
//   e1 [18 x 18]  conv0∘conv1_1 + relu, over m         (halo 1)
//   out [16 x 16] conv1_2 + relu + 2x2 max pool, or e1's inner 16 x 16
//
// Each 64->64 conv is an implicit GEMM over the tile: M = the stage's
// pixels, N = 64 output channels, K = 9 taps x 64 input channels,
// tap-major, on wgmma.m64n64 with A in registers and B in shared memory
// (conv_wgmma.cuh):
//
//   m      484 pixels in 8 row blocks of 64 (the last one part padding);
//          warpgroup g takes blocks g, g+2, g+4, g+6, and warp w of block i
//          the m-tile 8 i + w, its A rows read through the upsample tables
//          (a chunk ahead): f32 per element from the planar d tile and split
//          into hi and lo, bf16 by ldmatrix from a channel-minor copy.
//   conv1_2  256 pixels in 4 row blocks; warp w's slices are tile rows 2w and
//          2w + 1, so the pool's vertical max is in its registers
//          (conv_wgmma.cuh::conv1_2_pool, which encoder_head.cu runs too).
//
// B arrives in 16 KB slots by bulk copy on mbarriers (conv_wgmma.cuh's ring;
// f32 3 slots, bf16 6): m's conv (f32 18 chunks of half a tap, hi then lo;
// bf16 9 taps), then the 64->3 and 3->64 stages' weights in one slot, then
// conv1_2's. The two warpgroups run their wgmma's independently; the block
// meets at a barrier only between stages (the halo fixes), never per chunk.
// Within a chunk a warpgroup's groups of wgmma's run back to back while the
// partial before is folded and the next A is read (conv_wgmma.cuh); a
// partial covers 32 input channels (f32 4 k-steps, bf16 2).
//
// The 64->3 and 3->64 stages: f32 FFMA (stage_rgb below,
// conv_tc.cuh::stage_e1); bf16 on mma.sync.m16n8k16 (stage_rgb_mma below,
// conv_tc.cuh::stage_e1_mma), whose B fragments fit the same slot.
//
// Shared memory, from a 1 KB-aligned base (the swizzle atoms must be):
//
//                                                 f32                bf16
//   ring  weight slots                            3 x 16,384         6 x 16,384
//   bufM  m [22 x 22], later e1 [18 x 18]         123,904 (planar)   69,696 (x 144 B)
//         (bf16: first the d tile as loaded, [64][12][12], 18,432)
//   dt    the d tile [12 x 12]                    37,888             20,736
//         (f32: later the 64->3 stage's partials)
//   rgb   [3][20][20] f32                          4,800              4,800
//   reflect+upsample index tables                    192                192
//   barriers and release counts                       36                 72
//   alignment slack                                1,024              1,024
//                                                216,996            194,824
//
// One block of 256 threads per SM. Registers (ptxas: f32 255, bf16 about
// 250, no spills): 4 row blocks x 32 f32 accumulators per thread in m's
// conv, two partials of 32, and two groups' A fragments.
//
// The summation order of every output is fixed (taps, then channels, a
// partial per 32 input channels summed inside the tensor core and folded
// with a rounded f32 add; the bf16 64->3 stage a partial per k-step), there
// are no atomics on data, and nothing depends on the batch: an image gives
// the same bits alone and in any batch.
//
// Grid (W/16, H/16, B), 256 threads, one block per SM.

#include "conv_wgmma.cuh"

namespace wct {

constexpr int kMS = kT + 6;   // m region edge (halo 3)
constexpr int kUS = kT + 8;   // u region edge (halo 4)
constexpr int kDS = kUS / 2;  // d tile edge
constexpr int kDPix = kDS * kDS;
constexpr int kDPlane = kDPix + 4;  // f32: 148, so that A loads of 4 channels hit 4 bank groups
constexpr int kMPix = kMS * kMS;    // 484 pixels of m: 31 m-tiles of 16
constexpr int kJSlot = 16384;       // a weight slot: a chunk, or wd2 and we1 (16,128 B)
constexpr int kSmallFloats = kCh * 9 * 4 + 3 * kTapStride;

template <typename T>
__host__ __device__ constexpr int m_bytes() {
  return map_bytes<T>(kMPix);
}

template <typename T>
__host__ __device__ constexpr int d_bytes() {
  return is_f32<T>() ? kCh * kDPlane * 4 : kDPix * kPitch * 2;
}

static_assert(map_bytes<float>(kE1S * kE1S) <= m_bytes<float>(), "e1 lives where m was");
static_assert(map_bytes<bf16>(kE1S * kE1S) <= m_bytes<bf16>(), "e1 lives where m was");
static_assert(kCh * kDPix * 2 <= m_bytes<bf16>(), "the loaded d tile fits where m will be");
static_assert(kSmallFloats * 4 <= kJSlot, "wd2 and we1 share one slot");
static_assert(kRgbFloats * 4 <= d_bytes<float>(), "the 64->3 partial sums fit the d tile");

// Stage stamps: built with -DWCT_STAGE_TIMES, thread 0 writes kStamps 64-bit
// values per tile (the tile's index: bx + W/16 (by + H/16 b)) into
// g_stage_stamps (junction_stamps() copies them out): %globaltimer (ns) at
// the tile's start, after the d tile, after the m conv (before its halo
// fix), after the halo fix, after rgb, after e1 and at its end; then clock64
// at its start and at its end, and the clock64 cycles thread 0 spent waiting
// for weight chunks; then %globaltimer again once the FFMA stages' weights
// are in and once rgb is computed (before its halo fix); then the clock64
// cycles thread 0 spent waiting for conv1_2's weight chunks; then those it
// spent handing weight slots back (the ring's releases). The normal build
// has none of this.

constexpr int kStamps = 14;
constexpr int kStampBlocks = 8192;  // blocks past this many are not stamped

#ifdef WCT_STAGE_TIMES
__device__ unsigned long long g_stage_stamps[kStampBlocks * kStamps];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long* tile_stamps(int tile) {
  return threadIdx.x == 0 && tile < kStampBlocks ? g_stage_stamps + tile * kStamps : nullptr;
}

#define JSTAMP_DECL \
  unsigned long long* stamps_ = nullptr; \
  long long waited_ = 0, released_ = 0
#define JSTAMP_TILE(tile) do { stamps_ = tile_stamps(tile); waited_ = released_ = 0; } while (0)
#define JSTAMP(i) do { if (stamps_) stamps_[i] = global_ns(); } while (0)
#define JSTAMP_CLOCK(i) do { if (stamps_) stamps_[i] = clock64(); } while (0)
#define JWAIT_BEGIN long long w0_ = stamps_ ? clock64() : 0
#define JWAIT_END do { if (stamps_) waited_ += clock64() - w0_; } while (0)
#define JSTAMP_WAITED(i) do { if (stamps_) stamps_[i] = waited_; } while (0)
#define JRELEASE(stmt) do { long long r0_ = stamps_ ? clock64() : 0; stmt; \
  if (stamps_) released_ += clock64() - r0_; } while (0)
#define JSTAMP_RELEASED(i) do { if (stamps_) stamps_[i] = released_; } while (0)
#else
#define JSTAMP_DECL
#define JSTAMP_TILE(tile)
#define JSTAMP(i)
#define JSTAMP_CLOCK(i)
#define JWAIT_BEGIN
#define JWAIT_END
#define JSTAMP_WAITED(i)
#define JRELEASE(stmt) stmt
#define JSTAMP_RELEASED(i)
#endif

// ---------------------------------------------------------------- stages

// f32: m [22 x 22] (halo fixed, planar) -> rgb [3][20][20] = conv 64->3
// (+clip). ws holds the weights [64][9][4] (co padded to 4); scratch takes
// 1200 floats. 100 2x2 pixel tiles x 2 halves of the input channels = 200
// threads; the halves are added in a fixed order.
__device__ __forceinline__ void stage_rgb(const float* m, float* rgb, const float* ws,
                                          float* scratch, const float* __restrict__ bd2,
                                          int clip) {
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

// The index tables of a tile: ly[i] (lx[i]) is the d-tile row (column) that
// u row (column) 16*by-4+i (16*bx-4+i) reads after the reflection at full
// resolution.
__device__ __forceinline__ void index_tables(int* ly, int* lx, int by, int bx, int dy0, int dx0,
                                             int H, int W) {
  const int tid = threadIdx.x;
  if (tid < kUS) ly[tid] = (reflect(kT * by - 4 + tid, H) >> 1) - dy0;
  if (tid >= 32 && tid < 32 + kUS) lx[tid - 32] = (reflect(kT * bx - 4 + tid - 32, W) >> 1) - dx0;
}

// The shallow output: e1's inner 16 x 16 pixels into out_b [64][H][W].
template <typename T>
__device__ __forceinline__ void store_e1(const T* e1, T* __restrict__ out_b, int by, int bx, int H,
                                         int W) {
  for (int i = threadIdx.x; i < kCh * kT * kT; i += kThreads) {
    const int c = i / (kT * kT), y = (i / kT) % kT, x = i % kT;
    const int pix = (y + 1) * kE1S + x + 1;
    out_b[((size_t)c * H + kT * by + y) * W + kT * bx + x] =
        is_f32<T>() ? e1[c * kE1S * kE1S + pix] : e1[pix * kPitch + c];
  }
}

// ---------------------------------------------------------------- the kernel

template <typename T>
struct Wg {
  static constexpr int kSlots = is_f32<T>() ? 3 : 6;
  static constexpr int kRing = kSlots * kJSlot;
};

template <typename T>
__host__ __device__ constexpr int junction_smem() {
  return 1024 + Wg<T>::kRing + m_bytes<T>() + d_bytes<T>() + kRgbFloats * 4 + 2 * kUS * 4 +
         Wg<T>::kSlots * 12;
}

static_assert(junction_smem<float>() <= 232448, "one block's shared memory on sm_90");
static_assert(junction_smem<bf16>() <= 232448, "one block's shared memory on sm_90");

// bf16, the 64->3 and 3->64 stages on mma.sync.m16n8k16 (bf16 x bf16 -> f32)
// instead of FFMA: the weights as B fragments in the FFMA stages' slot,
// rgb's [36 k-steps][32 lanes][2 words] (co 0..2 of the n-tile's 8, the rest
// zero), then e1's [2 k-steps][8 n-tiles][32 lanes][2 words] (K = 27 = 3
// channels x 9 taps, zero-padded to 32); ops/junction.py::_rgb_frags_bf16,
// _e1_frags_bf16. Products are exact, sums f32, one rounding after bias,
// clip or ReLU, as the FFMA stages.
constexpr int kRgbFragWords = 36 * 32 * 2;    // 9,216 bytes
static_assert(kRgbFragWords == kCh * 9 * 4, "rgb's fragments take the FFMA weights' bytes");

// m [22 x 22] (halo fixed, channel-minor) -> rgb [3][20][20] f32 holding bf16
// values: 400 pixels = 25 m-tiles, warp w m-tiles w, w + 8, w + 16, w + 24
// (past the 25th, padding rows that are computed and not stored, so that
// every warp's four m-tiles are four independent chains); 36 k-steps (tap,
// then 16 channels) by ldmatrix, a fresh partial per k-step.
__device__ __forceinline__ void stage_rgb_mma(const bf16* m, float* rgb, const uint32_t* wf,
                                              const float* __restrict__ bd2, int clip) {
  constexpr int kPix = kRgbS * kRgbS, kTiles = (kPix + 15) / 16, kNM = (kTiles + 7) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[kNM][4] = {};
  uint32_t row[kNM];  // the lane's ldmatrix row at tap (0, 0): pixel lane % 16 of the m-tile
#pragma unroll
  for (int mt = 0; mt < kNM; ++mt) {
    const int p = min((warp + 8 * mt) * 16 + (lane & 15), kPix - 1);
    row[mt] = smem_addr(m + ((p / kRgbS) * kMS + p % kRgbS) * kPitch + 8 * (lane >> 4));
  }
#pragma unroll 4
  for (int s = 0; s < 36; ++s) {
    const int tap = s >> 2;
    const uint32_t shift = (((tap / 3) * kMS + tap % 3) * kPitch + 16 * (s & 3)) * 2;
    const uint2 b = *reinterpret_cast<const uint2*>(wf + (s * 32 + lane) * 2);
#pragma unroll
    for (int mt = 0; mt < kNM; ++mt) {
      uint32_t a[4];
      ldsm_x4(row[mt] + shift, a[0], a[1], a[2], a[3]);
      float part[4] = {};
      mma_bf16_16816(part, a, b.x, b.y);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][r] += part[r];
    }
  }
  // acc[mt][2 r + e]: pixel 16 (warp + 8 mt) + g + 8 r, channel 2 t + e.
#pragma unroll
  for (int mt = 0; mt < kNM; ++mt) {
    if (t > 1) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = (warp + 8 * mt) * 16 + g + 8 * r;
      if (p >= kPix) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * t + e;
        if (c > 2) continue;
        float v = acc[mt][2 * r + e] + __ldg(bd2 + c);
        if (clip) v = fminf(fmaxf(v, 0.f), 1.f);
        rgb[c * kPix + p] = as_operand<bf16>(v);
      }
    }
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
  constexpr int kS = Wg<T>::kSlots;
  constexpr int kChunks = Tc<T>::kChunks, kChunkBytes = Tc<T>::kChunkBytes;
  constexpr int kPerTap = kChunks / 9;
  extern __shared__ float4 smem4[];
  // Aligned by pointer arithmetic on the shared array itself, so that every
  // access below stays a shared-memory one (an integer round trip would make
  // them generic loads and stores).
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4) + (-smem_addr(smem4) & 1023u);
  T* bufM = reinterpret_cast<T*>(base + Wg<T>::kRing);
  T* bufE = bufM;  // e1 replaces m
  T* dt = reinterpret_cast<T*>(base + Wg<T>::kRing + m_bytes<T>());
  float* rgb = reinterpret_cast<float*>(base + Wg<T>::kRing + m_bytes<T>() + d_bytes<T>());
  int* ly = reinterpret_cast<int*>(rgb + kRgbFloats);
  int* lx = ly + kUS;
  const Ring<kS, kJSlot> ring{base, reinterpret_cast<uint64_t*>(lx + kUS),
                      reinterpret_cast<int*>(reinterpret_cast<uint64_t*>(lx + kUS) + kS)};
  const WeightStream ws{wd1f, kChunks, wd2, kCh * 9 * 4, we1,
                        is_f32<T>() ? 3 * kTapStride : kE1FragWords, we2f, deep ? kChunks : 0};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const int H = 2 * h, W = 2 * w;
  // d rows 8*by-2 .. 8*by+9 and columns 8*bx-2 .. 8*bx+9 feed u rows and
  // columns 16*b-4 .. 16*b+19 after the reflection at full resolution.
  const int dy0 = (kT / 2) * by - 2, dx0 = (kT / 2) * bx - 2;
  JSTAMP_DECL;
  JSTAMP_TILE(bx + gridDim.x * (by + gridDim.y * b));
  JSTAMP(0);
  JSTAMP_CLOCK(7);
  index_tables(ly, lx, by, bx, dy0, dx0, H, W);
  if (tid == 0) ring.init();
  load_d<T>(d + (size_t)b * kCh * h * w, dt, bufM, dy0, dx0, h, w);
  __syncthreads();  // the barriers are set up
  if (tid == 0)
    for (int q = 0; q < kS; ++q) ring.template issue<kChunkBytes>(q, ws);
  cp_async_wait<0>();
  __syncthreads();  // the d tile and the index tables
  if constexpr (!is_f32<T>()) {
    transpose_d(bufM, dt);
    __syncthreads();
  }
  JSTAMP(1);

  // ---- decoder conv 64->64 + relu on the upsampled tile: m, 22x22 ----
  {
    constexpr int kRB = 4;
    float acc[kRB][32];
#pragma unroll
    for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[rb][i] = 0.f;
    // (row << 8) | column in m of the lane's pixels in row block rb (m-tile
    // 8 rb + warp): f32 rows g and g + 8, bf16 its ldmatrix row lane % 16.
    int pyx[kRB][2];
#pragma unroll
    for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int in_tile = is_f32<T>() ? g + 8 * r : (lane & 15);
        const int p = min((8 * rb + warp) * 16 + in_tile, kMPix - 1);
        pyx[rb][r] = (p / kMS) << 8 | p % kMS;
      }
    const auto wait = [&](int c) {
      JWAIT_BEGIN;
      ring.wait(c);
      JWAIT_END;
    };
    if constexpr (is_f32<T>()) {
      for (int c = 0; c < kChunks; ++c) {
        const int tap = c / kPerTap, part = c % kPerTap, dy = tap / 3, dx = tap % 3;
        int off[kRB][2];  // d-tile pixel of each of the lane's rows, this tap
#pragma unroll
        for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            off[rb][r] = ly[(pyx[rb][r] >> 8) + dy] * kDS + lx[(pyx[rb][r] & 255) + dx];
        wait(c);
        chunk_rows_tf32<kRB, kFoldSteps<T>>(acc, ring.slot(c),
                             [&](int rb, int j, uint32_t(&ah)[4], uint32_t(&al)[4]) {
                               a_tf32(dt + (32 * part + 8 * j + t) * kDPlane, kDPlane, off[rb],
                                      ah, al);
                             });
        JRELEASE(ring.template release<kChunkBytes>(c, ws));
      }
    } else {  // a chunk is a tap
      const uint32_t a_base = smem_addr(dt + 8 * (lane >> 4));
      // The lane's ldmatrix row of each row block at tap c: a d-tile pixel
      // through the upsample tables, read a chunk ahead.
      const auto rows_at = [&](int c, uint32_t (&row)[kRB]) {
#pragma unroll
        for (int rb = 0; rb < kRB; ++rb)
          row[rb] = a_base + (ly[(pyx[rb][0] >> 8) + c / 3] * kDS +
                              lx[(pyx[rb][0] & 255) + c % 3]) * kPitch * 2;
      };
      uint32_t row[kRB], next[kRB];
      uint32_t a[2][kStepsPerChunk][4];
      rows_at(0, row);
      load_a(a[0], row[0]);
      for (int c = 0; c < kChunks; ++c) {
        if (c + 1 < kChunks) rows_at(c + 1, next);
        wait(c);
        chunk_rows<kRB, kFoldSteps<T>>(acc, a, ring.slot(c), [&](int rb) { return row[rb]; },
                        c + 1 < kChunks ? next[0] : 0u);
        JRELEASE(ring.template release<kChunkBytes>(c, ws));
#pragma unroll
        for (int rb = 0; rb < kRB; ++rb) row[rb] = next[rb];
      }
    }
    // acc[rb][4 nt + 2 r + e]: pixel 16 (8 rb + warp) + g + 8 r, channel 8 nt + 2 t + e.
#pragma unroll
    for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = (8 * rb + warp) * 16 + g + 8 * r;
        if (p >= kMPix) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int co = 8 * nt + 2 * t;
          store_pair(bufM, kMPix, p, co, fmaxf(acc[rb][4 * nt + 2 * r] + __ldg(bd1 + co), 0.f),
                     fmaxf(acc[rb][4 * nt + 2 * r + 1] + __ldg(bd1 + co + 1), 0.f));
        }
      }
  }
  JSTAMP(2);
  fix_halo(bufM, kMS, kMS, kT * by - 3, kT * bx - 3, H, W);
  JSTAMP(3);

  // ---- decoder conv 64->3 (linear, optional clip): rgb, 20x20 ----
  {
    JWAIT_BEGIN;
    ring.wait(kChunks);
    JWAIT_END;
  }
  JSTAMP_WAITED(9);
  JSTAMP(10);
  const float* small = reinterpret_cast<const float*>(base + (kChunks % kS) * kJSlot);
  if constexpr (is_f32<T>())
    stage_rgb(bufM, rgb, small, reinterpret_cast<float*>(dt), bd2, clip);
  else
    stage_rgb_mma(bufM, rgb, reinterpret_cast<const uint32_t*>(small), bd2, clip);
  JSTAMP(11);
  fix_halo(rgb, 3, kRgbS, kRgbS, kT * by - 2, kT * bx - 2, H, W);
  JSTAMP(4);

  // ---- encoder conv0∘conv1_1 + relu: e1, 18x18 (over m, which is dead) ----
  if constexpr (is_f32<T>())
    stage_e1<T>(rgb, bufE, small + kCh * 9 * 4, be1);
  else
    stage_e1_mma(rgb, bufE, reinterpret_cast<const uint32_t*>(small) + kRgbFragWords, be1);
  if (!deep) {  // the relu1_1 features of the tile are the output
    __syncthreads();
    JSTAMP(5);
    store_e1(bufE, out + (size_t)b * kCh * H * W, by, bx, H, W);
    JSTAMP(6);
    JSTAMP_CLOCK(8);
    JSTAMP_WAITED(12);
    JSTAMP_RELEASED(13);
    return;
  }
  fix_halo(bufE, kE1S, kE1S, kT * by - 1, kT * bx - 1, H, W);
  // Every thread is past the FFMA stages' weights: their slot takes the
  // chunk kS positions on.
  if (tid == 0) ring.template issue<kChunkBytes>(kChunks + kS, ws);
  JSTAMP(5);

  // ---- encoder conv1_2 + relu + 2x2 max pool ----
  T* out_b = out + (size_t)b * kCh * h * w;
  const int oy0 = (kT / 2) * by, ox0 = (kT / 2) * bx;
  conv1_2_pool<T, 2>(
      bufE, kChunks + 1, [&](int q) { return ring.slot(q); },
      [&](int q) {
        JWAIT_BEGIN;
        ring.wait(q);
        JWAIT_END;
      },
      [&](int q) { JRELEASE(ring.template release<kChunkBytes>(q, ws)); }, be2,
      [&](int r, int x, int c, float v) {
        store_value(out_b + ((size_t)c * h + oy0 + r) * w + ox0 + x, v);
      });
  JSTAMP(6);
  JSTAMP_CLOCK(8);
  JSTAMP_WAITED(12);
  JSTAMP_RELEASED(13);
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
// the operand type of the entry point. wd1f, we2f: the 64->64 convs in the
// wgmma B layout (ops/junction.py::_wgmma_weights; f32: [tap][half][hi, lo]
// [co][32 channels] tf32, bf16: [tap][co][64 channels], each 8 KB block in
// the 128-byte swizzle), 16-byte aligned; wd2 [64][9][4] with co padded to 4
// and we1 [3][9][64], [ci][tap][co], f32 (bf16 values for the bf16 entry),
// 16-byte aligned. Returns the CUDA error of the launch.
extern "C" int junction_f32(const float* d, const void* wd1f, const float* bd1,
                            const float* wd2, const float* bd2, const float* we1,
                            const float* be1, const void* we2f, const float* be2,
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

#ifdef WCT_STAGE_TIMES
// Copies n 64-bit stamps (at most kStampBlocks * kStamps) of the last
// launches into dst (device memory) on `stream`. Returns the CUDA error.
extern "C" int junction_stamps(void* dst, int n, void* stream) {
  if (n > wct::kStampBlocks * wct::kStamps) n = wct::kStampBlocks * wct::kStamps;
  return (int)cudaMemcpyFromSymbolAsync(dst, wct::g_stage_stamps, (size_t)n * 8, 0,
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
}
#endif
