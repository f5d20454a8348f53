// The fused encoder head: RGB -> post-pool1 encoder state, one launch, in f32
// or bf16 operands, conv1_2 on Hopper's wgmma.
//
// Replaces the TPU kernel wct_tpu/ops/junction_pallas.py::encoder_head
// (_head_kernel), which computes in the operand type of its input. On
// img [B, 3, H, W] (NCHW, f32 or bf16) it computes
//
//   e1  = relu(conv3x3(img; we1, be1))        [64, H, W]   conv0 folded into conv1_1
//   out = maxpool2(relu(conv3x3(e1; we2, be2)))   [64, H/2, W/2]
//
// each conv reflect-padding its own input. These are the last stages of
// junction.cu, on the same code: the 3->64 stage (conv_tc.cuh: f32 FFMA,
// bf16 mma.sync.m16n8k16), e1's halo fix (conv_tiles.cuh), and conv1_2 + ReLU
// + pool (conv_wgmma.cuh::conv1_2_pool: RS wgmma.m64n64, f32 in 3xTF32 with a
// partial per 4 k-steps, bf16 one pass with a partial per 2; the weights in
// the 128-byte-swizzled layout of ops/junction.py::_wgmma_weights). Under
// bf16 both convs round once to bf16, after the f32 bias and the ReLU, and e1
// is bf16.
//
// Bound on an H100: operations. 2*H*W*9*(3*64 + 64*64) FLOP per image, 20.2
// GFLOP at 512 px, 80.9 GFLOP at batch 4: f32 three TF32 passes, 0.491 ms;
// bf16 one pass, 0.082 ms; against 12.6 (6.3) MB read and 268 (134) MB
// written, 0.084 (0.042) ms. The unfused chain writes and reads three
// full-resolution maps (conv0's, conv1_1's, conv1_2's) that here never leave
// the SM. conv1_2 is 95.5 % of the FLOP.
//
// Design. A block of two warpgroups is persistent (one per SM) and walks
// output tiles of kRows = 32 rows x 16 columns (a tile may reach below the
// image; its rows there are computed and not stored): the rgb tile [3][36][20]
// (rows reflected at the copy; bf16 copies whole rows and reflects the columns
// while converting to f32), e1 on 34 x 18, its halo fix, then conv1_2 on the
// 32 x 16 tile as an implicit GEMM, M = 512 pixels in 4 row blocks of 64 per
// warpgroup (warp w's slices are tile rows 4w ..), N = 64, K = 9 taps x 64
// channels; the pool's vertical max in registers. While a tile's conv1_2
// runs, the next tile's rgb is in flight (cp.async).
//
// conv1_2's weights stream through a ring of kS slots of one chunk each
// (f32: half a tap, hi then lo, 16 KB, 3 slots; bf16: a tap, 8 KB, 9 slots),
// bulk copies on mbarriers; the f32 stream runs on across the block's tiles,
// so the next tile's first chunks land during its rgb and e1 stages. The bf16
// ring holds the whole conv (73,728 B): loaded once per block, never
// refilled. conv1_1's weights (f32 [3][9][64] taps, bf16 mma fragments) stay
// resident. f32 stores each pooled value as the pool makes it; bf16 stages
// the tile's pooled map in shared memory and stores it 16 bytes at a time
// (f32's 32 KB would not fit beside the ring and e1).
//
// Shared memory, from a 1 KB-aligned base:
//
//                           f32                      bf16
//   ring                    49,152 (3 slots)         73,728 (9 slots)
//   e1 [34 x 18]            156,672 (planar)         88,128 (x 144 B)
//   rgb [3][36][20] f32     8,640                    8,640
//   raw rgb rows bf16       -                        6,912 ([3][36][32])
//   conv1_1's weights       6,912                    4,096
//   pooled tile [64][16][8] -                        16,384 (staged for the store)
//   barriers, counts        36                       108
//   alignment slack         1,024                    1,024
//                           222,436                  199,020
//
// One block of 256 threads per SM (the accumulators of 4 row blocks, two
// partials and two groups' A take up to 255 registers). 16 x 16 tiles, one
// block per tile, a shallower bf16 ring and a direct bf16 store were each
// slower on the card (PERF.md, PR 13).
//
// The summation order of every output is fixed (taps, then channels, a
// partial per 32 input channels folded with a rounded f32 add; the 3->64
// stage as conv_tc.cuh), there are no atomics on data, the tiling follows H and
// W alone, and a tile's arithmetic does not depend on which block runs it: an
// image gives the same bits alone and in any batch.
// Grid: min(tiles, SMs x blocks per SM), 256 threads.

#include "conv_wgmma.cuh"

namespace wct {

// Stage stamps: built with -DWCT_STAGE_TIMES, thread 0 writes kHeadStamps
// 64-bit values per tile (index t < kHeadStampTiles) into g_head_stamps
// (encoder_head_stamps() copies them out): %globaltimer (ns) at the tile's
// start, once its rgb is in shared memory (bf16: converted), after e1 and its
// halo fix, and after conv1_2 + pool; then clock64 at its start and at its
// end, and the clock64 cycles thread 0 spent waiting for conv1_2's weight
// chunks. The normal build has none of this.
#ifdef WCT_STAGE_TIMES
constexpr int kHeadStamps = 7;
constexpr int kHeadStampTiles = 8192;
__device__ unsigned long long g_head_stamps[kHeadStampTiles * kHeadStamps];

__device__ __forceinline__ unsigned long long head_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define HSTAMP_DECL \
  unsigned long long* stamps_ = nullptr; \
  long long waited_ = 0
#define HSTAMP_TILE(t) do { \
    stamps_ = threadIdx.x == 0 && (t) < kHeadStampTiles ? g_head_stamps + (t) * kHeadStamps : nullptr; \
    waited_ = 0; } while (0)
#define HSTAMP(i) do { if (stamps_) stamps_[i] = head_ns(); } while (0)
#define HSTAMP_CLOCK(i) do { if (stamps_) stamps_[i] = clock64(); } while (0)
#define HWAIT(stmt) do { long long w0_ = stamps_ ? clock64() : 0; stmt; \
    if (stamps_) waited_ += clock64() - w0_; } while (0)
#define HSTAMP_WAITED(i) do { if (stamps_) stamps_[i] = waited_; } while (0)
#else
#define HSTAMP_DECL
#define HSTAMP_TILE(t)
#define HSTAMP(i)
#define HSTAMP_CLOCK(i)
#define HWAIT(stmt) stmt
#define HSTAMP_WAITED(i)
#endif

template <typename T>
struct Head {
  static constexpr int kRows = 32;                  // tile rows
  static constexpr int kS = is_f32<T>() ? 3 : Tc<T>::kChunks;  // ring slots (bf16: all of conv1_2)
  static constexpr bool kStaged = !is_f32<T>();     // the pooled tile staged for 16-byte stores
  static constexpr int kRB = kRows / 8;             // row blocks per warpgroup
  static constexpr int kE1R = kRows + 2, kRgbR = kRows + 4;
  static constexpr int kSlot = Tc<T>::kChunkBytes;
  static constexpr int kRawCols = 32;               // bf16: columns x0-8 .. x0+23
  static constexpr int kRing = kS * kSlot;
  static constexpr int kE1 = map_bytes<T>(kE1R * kE1S);
  static constexpr int kRgb = 3 * kRgbR * kRgbS * 4;
  static constexpr int kRaw = is_f32<T>() ? 0 : 3 * kRgbR * kRawCols * 2;
  static constexpr int kW1 = is_f32<T>() ? 3 * kTapStride * 4 : kE1FragWords * 4;
  static constexpr int kOut = kStaged ? kCh * (kRows / 2) * 8 * (int)sizeof(T) : 0;
  static constexpr int kSmem = 1024 + kRing + kE1 + kRgb + kRaw + kW1 + kOut + kS * 12;
  static_assert(kSmem <= 232448, "one block's shared memory on sm_90");
};

// Tile t's rgb rows into shared memory, asynchronously (one commit group): f32
// each value at its reflected row and column into rgb [3][kRgbR][20]; bf16 the
// reflected rows as they lie in memory, columns x0-8 .. x0+23 in 16-byte
// copies (a copy outside the image is skipped: W is a multiple of 16), into
// raw [3][kRgbR][32], for convert_rgb. Rows past the reflection (a tile
// reaching below the image by more than the image's height) read a row of
// the image; no output of the image reads them.
template <typename T, int kRgbR>
__device__ __forceinline__ void load_rgb(const T* __restrict__ img_b, float* rgb, T* raw, int y0,
                                         int x0, int H, int W) {
  if constexpr (is_f32<T>()) {
    const uint32_t base = smem_addr(rgb);
    for (int i = threadIdx.x; i < 3 * kRgbR * kRgbS; i += kThreads) {
      const int c = i / (kRgbR * kRgbS), r = (i / kRgbS) % kRgbR, x = i % kRgbS;
      const int gy = min(max(reflect(y0 - 2 + r, H), 0), H - 1), gx = reflect(x0 - 2 + x, W);
      cp_async4(base + i * 4, img_b + ((size_t)c * H + gy) * W + gx);
    }
  } else {
    const uint32_t base = smem_addr(raw);
    for (int i = threadIdx.x; i < 3 * kRgbR * 4; i += kThreads) {
      const int c = i / (kRgbR * 4), r = (i / 4) % kRgbR, k = i % 4;
      const int gx = x0 - 8 + 8 * k;
      if (gx < 0 || gx >= W) continue;
      const int gy = min(max(reflect(y0 - 2 + r, H), 0), H - 1);
      cp_async16(base + ((c * kRgbR + r) * 32 + 8 * k) * 2, img_b + ((size_t)c * H + gy) * W + gx);
    }
  }
  cp_async_commit();
}

// bf16: raw [3][kRgbR][32] -> rgb [3][kRgbR][20] f32, column x of rgb taking
// image column reflect(x0 - 2 + x).
template <int kRgbR>
__device__ __forceinline__ void convert_rgb(const bf16* raw, float* rgb, int x0, int W) {
  for (int i = threadIdx.x; i < 3 * kRgbR * kRgbS; i += kThreads) {
    const int row = i / kRgbS, x = i % kRgbS;
    rgb[i] = __bfloat162float(raw[row * 32 + reflect(x0 - 2 + x, W) - (x0 - 8)]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
encoder_head_kernel(const T* __restrict__ img, const float* __restrict__ we1,
                    const float* __restrict__ be1, const unsigned char* __restrict__ we2f,
                    const float* __restrict__ be2, T* __restrict__ out, int H, int W,
                    int n_tiles) {
  using P = Head<T>;
  constexpr int kChunks = Tc<T>::kChunks, kRows = P::kRows, kS = P::kS;
  constexpr bool kResident = kS == kChunks;  // the ring holds the whole conv
  extern __shared__ float4 smem4[];
  // Aligned by pointer arithmetic on the shared array itself, so that every
  // access below stays a shared-memory one.
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4) + (-smem_addr(smem4) & 1023u);
  T* e1 = reinterpret_cast<T*>(base + P::kRing);
  float* rgb = reinterpret_cast<float*>(base + P::kRing + P::kE1);
  T* raw = reinterpret_cast<T*>(base + P::kRing + P::kE1 + P::kRgb);
  float* w1 = reinterpret_cast<float*>(base + P::kRing + P::kE1 + P::kRgb + P::kRaw);
  T* out_s = reinterpret_cast<T*>(base + P::kRing + P::kE1 + P::kRgb + P::kRaw + P::kW1);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + P::kRing + P::kE1 + P::kRgb + P::kRaw + P::kW1 + P::kOut);
  const Ring<kS, P::kSlot> ring{base, full, reinterpret_cast<int*>(full + kS)};

  const int tid = threadIdx.x;
  const int tiles_x = W / kT, tiles_y = (H + kRows - 1) / kRows;
  const int h = H / 2, w = W / 2;
  // Ring positions of this block's tiles: tile i's conv1_2 chunk c is
  // position i * kChunks + c (resident: c).
  const int positions = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * kChunks;
  const auto refill = [&](int p) {
    if (p < positions) ring.copy(p, we2f + (size_t)(p % kChunks) * P::kSlot, P::kSlot);
  };
  const auto tile_at = [&](int t, int& b, int& y0, int& x0) {
    const int r = t % (tiles_x * tiles_y);
    b = t / (tiles_x * tiles_y);
    y0 = (r / tiles_x) * kRows;
    x0 = (r % tiles_x) * kT;
  };

  if (tid == 0) ring.init();
  for (int i = tid; i < P::kW1 / 16; i += kThreads)
    reinterpret_cast<uint4*>(w1)[i] = __ldg(reinterpret_cast<const uint4*>(we1) + i);
  {
    int b, y0, x0;
    tile_at(blockIdx.x, b, y0, x0);
    load_rgb<T, P::kRgbR>(img + (size_t)b * 3 * H * W, rgb, raw, y0, x0, H, W);
  }
  __syncthreads();  // the barriers are set up
  if (tid == 0)
    for (int q = 0; q < kS; ++q) refill(q);

  HSTAMP_DECL;
  for (int it = 0, t = blockIdx.x; t < n_tiles; ++it, t += gridDim.x) {
    int b, y0, x0;
    tile_at(t, b, y0, x0);
    HSTAMP_TILE(t);
    HSTAMP(0);
    HSTAMP_CLOCK(4);
    cp_async_wait<0>();
    __syncthreads();  // the rgb tile (and, before the first, conv1_1's weights)
    if constexpr (!is_f32<T>()) {
      convert_rgb<P::kRgbR>(raw, rgb, x0, W);
      __syncthreads();
    }
    HSTAMP(1);
    if constexpr (is_f32<T>())
      stage_e1<T, P::kE1R>(rgb, e1, w1, be1);
    else
      stage_e1_mma<P::kE1R>(rgb, e1, reinterpret_cast<const uint32_t*>(w1), be1);
    fix_halo(e1, P::kE1R, kE1S, y0 - 1, x0 - 1, H, W);  // every thread is past rgb
    HSTAMP(2);
    if (t + (int)gridDim.x < n_tiles) {
      int nb, ny0, nx0;
      tile_at(t + gridDim.x, nb, ny0, nx0);
      load_rgb<T, P::kRgbR>(img + (size_t)nb * 3 * H * W, rgb, raw, ny0, nx0, H, W);
    }
    T* out_b = out + (size_t)b * kCh * h * w + (size_t)(y0 / 2) * w + x0 / 2;
    conv1_2_pool<T, P::kRB>(
        e1, kResident ? 0 : it * kChunks, [&](int q) { return ring.slot(q); },
        [&](int q) { HWAIT(ring.wait(q)); },
        [&](int q) {
          if constexpr (!kResident) ring.release(q, refill);
        },
        be2, [&](int r, int x, int c, float v) {
          if constexpr (P::kStaged)
            store_value(out_s + (c * (kRows / 2) + r) * 8 + x, v);
          else if (y0 / 2 + r < h)
            store_value(out_b + ((size_t)c * h + r) * w + x, v);
        });
    if constexpr (P::kStaged) {  // each channel's pooled row: 8 values, 16-byte pieces
      constexpr int kPieces = 8 * (int)sizeof(T) / 16;
      __syncthreads();
      for (int i = tid; i < kCh * (kRows / 2) * kPieces; i += kThreads) {
        const int c = i / ((kRows / 2) * kPieces), r = i / kPieces % (kRows / 2), k = i % kPieces;
        if (y0 / 2 + r < h)
          reinterpret_cast<uint4*>(out_b + ((size_t)c * h + r) * w)[k] =
              reinterpret_cast<const uint4*>(out_s + (c * (kRows / 2) + r) * 8)[k];
      }
    }
    HSTAMP(3);
    HSTAMP_CLOCK(5);
    HSTAMP_WAITED(6);
  }
}

template <typename T>
int launch_head(const void* img, const float* we1, const float* be1, const void* we2f,
                const float* be2, void* out, int B, int H, int W, void* stream) {
  using P = Head<T>;
  auto kernel = encoder_head_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = B * (W / kT) * ((H + P::kRows - 1) / P::kRows);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  kernel<<<grid, kThreads, P::kSmem, (cudaStream_t)stream>>>(
      static_cast<const T*>(img), we1, be1, static_cast<const unsigned char*>(we2f), be2,
      static_cast<T*>(out), H, W, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace wct

// img [B, 3, H, W] -> out [B, 64, H/2, W/2], in the operand type of the entry
// point; H and W multiples of 16, a bf16 img 16-byte aligned (its rows are
// copied in 16-byte pieces; f32 copies each value on its own). we1: f32 conv1_1 (conv0
// folded in) as [3][9][64] taps ([ci][tap][co]); bf16 its mma.sync B
// fragments (ops/junction.py::_e1_frags_bf16); 16-byte aligned. we2f conv1_2
// in the wgmma B layout (ops/junction.py::_wgmma_weights), 16-byte aligned.
// Returns the CUDA error of the launch.
extern "C" int encoder_head_f32(const float* img, const float* we1, const float* be1,
                                const void* we2f, const float* be2, float* out, int B, int H,
                                int W, void* stream) {
  return wct::launch_head<float>(img, we1, be1, we2f, be2, out, B, H, W, stream);
}

extern "C" int encoder_head_bf16(const void* img, const void* we1, const float* be1,
                                 const void* we2f, const float* be2, void* out, int B, int H,
                                 int W, void* stream) {
  return wct::launch_head<wct::bf16>(img, static_cast<const float*>(we1), be1, we2f, be2, out, B,
                                     H, W, stream);
}

// The form's shared memory per block and the blocks an SM holds at once on
// the current device (bf16 != 0: the bf16 form). Returns the CUDA error.
extern "C" int encoder_head_plan(int bf16, int* smem_bytes, int* blocks_per_sm) {
  return bf16 ? wct::kernel_plan(wct::encoder_head_kernel<wct::bf16>, wct::Head<wct::bf16>::kSmem,
                                 smem_bytes, blocks_per_sm)
              : wct::kernel_plan(wct::encoder_head_kernel<float>, wct::Head<float>::kSmem, smem_bytes,
                                 blocks_per_sm);
}

#ifdef WCT_STAGE_TIMES
// Copies n 64-bit stamps (at most kHeadStampTiles * kHeadStamps) of the last
// launches into dst (device memory) on `stream`. Returns the CUDA error.
extern "C" int encoder_head_stamps(void* dst, int n, void* stream) {
  if (n > wct::kHeadStampTiles * wct::kHeadStamps) n = wct::kHeadStampTiles * wct::kHeadStamps;
  return (int)cudaMemcpyFromSymbolAsync(dst, wct::g_head_stamps, (size_t)n * 8, 0,
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
}
#endif
