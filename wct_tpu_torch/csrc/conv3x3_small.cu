// 3x3 reflect convolution for small channel counts, bf16 in and out, on the
// tensor cores.
//
// Replaces three TPU kernels that compute the same function in three layouts:
// wct_tpu/ops/conv_pallas.py::conv3x3_reflect_pallas (NHWC),
// scripts/exp_nchw_conv.py::conv3x3_reflect_nchw (NCHW) and
// scripts/exp_nchw_conv.py::conv3x3_reflect_nhwc_io (NHWC in and out). On
// x (bf16, C_in <= 64, H and W multiples of 8) with weights w and an f32 bias:
//
//   out[b, y, x, o] = bf16( act( bias[o] + sum over ci, dy, dx of
//       x[b, reflect(y + dy - 1), reflect(x + dx - 1), ci] * w[o, ci, dy, dx] ) )
//
// with reflect(-1) = 1 and reflect(n) = n - 2, act = ReLU or the identity, every
// product an exact bf16 x bf16 product, the sum kept in f32 and rounded once.
//
// Bound on an H100: 64 -> 64 at [4, 64, 512, 512] is 7.7e10 FLOP and 268 MB,
// 0.08 ms either way on the tensor cores (FFMA could not go below 1.15 ms);
// 64 -> 3 and 3 -> 64 move 140 MB, 0.04 ms, bytes.
//
// Design: an implicit GEMM, M = the pixels of a tile, N = C_out, K = 9 taps x
// C_in, on mma.sync.m16n8k16 (bf16 x bf16 -> f32). K is walked in "k-groups"
// of 8 channels of one tap; one mma step takes two k-groups, (tap, channels
// 8j..8j+15) when C_in >= 16 and two taps of one 8-channel group when C_in <= 8
// (so 3 -> 64 runs K = 80 rather than 9 x 16 = 144). mma.sync with ldmatrix and
// not wgmma: each tap's A tile is the staged tile shifted by one pixel, and
// ldmatrix takes a row address per lane, where wgmma's shared-memory
// descriptors want bases aligned to a swizzle atom.
//
// A block is persistent (one per SM: the weights take up to 72 KB of its shared
// memory and are loaded once) and walks output tiles of 8 rows x 32 columns of
// one image. Warp w owns row w: 2 m-tiles of 16 pixels x all of N (8 n-tiles
// for C_out > 8, 1 for C_out <= 8, which pads 64 -> 3 to 8 lanes). The haloed
// input tile [10][34] is kept channel-minor in shared memory, 16 bytes per
// 8-channel group, with an odd pixel stride in 16-byte units so that the 8 row
// addresses of one ldmatrix fall in 8 different bank groups.
//
// Staging is asynchronous (cp.async, 16 bytes), and the reflection is done
// while loading (a bulk tensor copy could only zero-fill):
//   NHWC with C_in % 8 == 0: one copy per pixel and channel group at its
//     reflected coordinate, straight into the tile; two tile buffers, the next
//     tile in flight behind the current tile's mma's.
//   NCHW, or NHWC with another C_in: the rows the tile needs (columns x0-8 ..
//     x0+39 in whole 8-column chunks, which hold both reflected halo columns)
//     are copied as they lie in memory into a raw buffer, in flight behind the
//     mma's; a gather pass then lays them out channel-minor, reflecting.
// Columns past the image edge are zero in the tile and masked on store; W is a
// multiple of 8, so an 8-column chunk is in or out whole. Both layouts then run
// the same compute body on the same tile bits: the two entries give the same
// bits. The output tile goes through shared memory so that every global store
// is 16 bytes (8 channels of a pixel, or 8 pixels of a channel). The
// summation order of every output is fixed (the k-groups in order, each mma's
// own order inside), there are no atomics and no split of K across blocks, and
// nothing depends on the batch: an image gives the same bits alone and in any
// batch.

#include <cuda_bf16.h>

#include "ptx.cuh"

namespace wct {

constexpr int kSmallThreads = 256;         // 8 warps, warp w owns tile row w
constexpr int kTileRows = 8, kTileCols = 32;
constexpr int kHaloRows = kTileRows + 2;   // 10
constexpr int kHaloCols = kTileCols + 2;   // 34
constexpr int kHaloPixels = kHaloRows * kHaloCols;
constexpr int kRawCols = kTileCols + 16;   // columns x0-8 .. x0+39
constexpr int kRawChunks = kRawCols / 8;   // 6
constexpr int kOutPitch = kTileCols + 8;   // NCHW output staging: one row of a channel
constexpr int kOutPlane = kTileRows * kOutPitch + 8;  // one channel (656 bytes)

enum Staging { kDirectNhwc = 0, kRawNhwc = 1, kRawNchw = 2 };

__device__ __forceinline__ int reflect_index(int g, int n) {
  return g < 0 ? -g : (g >= n ? 2 * (n - 1) - g : g);
}

__host__ __device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

// Shared-memory plan, the same on host and device.
struct SmallPlan {
  int ncg, pstride, ksteps, w_bytes, koff_bytes, tile_bytes, second_bytes;
  __host__ __device__ SmallPlan(int cin, int co_pad, int mode) {
    ncg = (cin + 7) / 8;
    pstride = ncg | 1;  // odd, in 16-byte units
    ksteps = (9 * ncg + 1) / 2;
    w_bytes = ksteps * 2 * co_pad * 16;
    koff_bytes = align16(ksteps * 2 * 4);
    const int out_bytes = mode == kRawNchw ? co_pad * kOutPlane * 2
                                           : kTileRows * kTileCols * (co_pad + 8) * 2;
    const int tile = kHaloPixels * pstride * 16;
    tile_bytes = align16(tile > out_bytes ? tile : out_bytes);
    second_bytes = mode == kDirectNhwc ? tile_bytes
                   : mode == kRawNchw  ? align16(cin * kHaloRows * kRawCols * 2)
                                       : align16(kHaloRows * kRawCols * cin * 2);
  }
  __host__ __device__ int bytes() const { return w_bytes + koff_bytes + tile_bytes + second_bytes; }
};

struct TileAt {
  int b, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(int t, int tiles_y, int tiles_x) {
  const int per_image = tiles_y * tiles_x;
  const int r = t % per_image;
  return {t / per_image, (r / tiles_x) * kTileRows, (r % tiles_x) * kTileCols};
}

// NHWC, C_in % 8 == 0: every (halo pixel, channel group) straight into the tile.
__device__ __forceinline__ void stage_direct(const __nv_bfloat16* __restrict__ x, unsigned char* tile,
                                             const SmallPlan& p, TileAt t, int H, int W, int cin) {
  const uint32_t base = smem_addr(tile);
  for (int i = threadIdx.x; i < kHaloPixels * p.ncg; i += kSmallThreads) {
    const int cg = i / kHaloPixels, px = i % kHaloPixels;
    const int yy = px / kHaloCols, xx = px % kHaloCols;
    const int gy = reflect_index(t.y0 - 1 + yy, H);
    const int g = t.x0 - 1 + xx;
    const bool in = g <= W;  // beyond the reflected right halo: zeros, masked on store
    const int gx = in ? reflect_index(g, W) : 0;
    const __nv_bfloat16* src = x + (((size_t)t.b * H + gy) * W + gx) * cin + cg * 8;
    cp_async16(base + (px * p.pstride + cg) * 16, src, in ? 16 : 0);
  }
}

// The rows of the tile as they lie in memory, columns x0-8 .. x0+39 in whole
// 16-byte chunks; chunks outside the image are not loaded (never read).
template <int MODE>
__device__ __forceinline__ void stage_raw(const __nv_bfloat16* __restrict__ x, unsigned char* raw,
                                          TileAt t, int H, int W, int cin) {
  const uint32_t base = smem_addr(raw);
  if (MODE == kRawNchw) {
    // raw [cin][10][48]
    for (int i = threadIdx.x; i < cin * kHaloRows * kRawChunks; i += kSmallThreads) {
      const int k = i % kRawChunks, yy = (i / kRawChunks) % kHaloRows, c = i / (kRawChunks * kHaloRows);
      const int gc = t.x0 - 8 + 8 * k;
      if (gc < 0 || gc >= W) continue;
      const int gy = reflect_index(t.y0 - 1 + yy, H);
      cp_async16(base + ((c * kHaloRows + yy) * kRawCols + 8 * k) * 2,
                 x + (((size_t)t.b * cin + c) * H + gy) * W + gc);
    }
  } else {
    // raw [10][48][cin]: a row's 48 pixels are 6 * cin chunks of 16 bytes
    const int lo = t.x0 >= 8 ? 0 : 8 - t.x0;                            // first valid column
    const int hi = (W - (t.x0 - 8)) < kRawCols ? W - (t.x0 - 8) : kRawCols;  // one past the last
    const int per_row = kRawChunks * cin;
    for (int i = threadIdx.x; i < kHaloRows * per_row; i += kSmallThreads) {
      const int j = i % per_row, yy = i / per_row;
      if (j < lo * cin / 8 || j >= hi * cin / 8) continue;
      const int gy = reflect_index(t.y0 - 1 + yy, H);
      cp_async16(base + (yy * per_row + j) * 16,
                 x + (((long long)t.b * H + gy) * W + (t.x0 - 8)) * cin + 8 * j);
    }
  }
}

// raw -> the channel-minor tile, reflecting columns; channels >= cin are 0.
template <int MODE>
__device__ __forceinline__ void gather(const unsigned char* raw_bytes, unsigned char* tile,
                                       const SmallPlan& p, TileAt t, int W, int cin) {
  const __nv_bfloat16* raw = reinterpret_cast<const __nv_bfloat16*>(raw_bytes);
  for (int i = threadIdx.x; i < kHaloPixels * p.ncg; i += kSmallThreads) {
    const int cg = i / kHaloPixels, px = i % kHaloPixels;
    const int yy = px / kHaloCols, xx = px % kHaloCols;
    const int g = t.x0 - 1 + xx;
    const int col = (g <= W ? reflect_index(g, W) : 0) - (t.x0 - 8);
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg * 8 + j;
      uint32_t bits = 0;  // +0.0 in bf16
      if (g <= W && c < cin)
        bits = __bfloat16_as_ushort(MODE == kRawNchw ? raw[(c * kHaloRows + yy) * kRawCols + col]
                                                     : raw[(yy * kRawCols + col) * cin + c]);
      v[j / 2] = j % 2 ? v[j / 2] | (bits << 16) : bits;
    }
    *reinterpret_cast<uint4*>(tile + (px * p.pstride + cg) * 16) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

enum Act { kIdentity = 0, kRelu = 1 };

template <int NT, int MODE>
__global__ void __launch_bounds__(kSmallThreads, 1)
conv3x3_small_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wk,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W,
                  int cin, int cout, int act, int tiles_y, int tiles_x, int n_tiles) {
  constexpr int kCoPad = 8 * NT;
  constexpr bool kNhwc = MODE != kRawNchw;
  extern __shared__ __align__(16) unsigned char smem[];
  const SmallPlan p(cin, kCoPad, MODE);
  unsigned char* w_s = smem;
  int* koff = reinterpret_cast<int*>(smem + p.w_bytes);
  unsigned char* buf[2] = {smem + p.w_bytes + p.koff_bytes,
                           smem + p.w_bytes + p.koff_bytes + p.tile_bytes};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int t = blockIdx.x;  // the grid has at most one block per tile
  // Byte offset of each k-group's A rows from the pixel's: tap (dy, dx), group cg.
  // The pad k-group of an odd count repeats tap 8 against zero weights.
  for (int kg = tid; kg < 2 * p.ksteps; kg += kSmallThreads) {
    int tap = kg / p.ncg, cg = kg % p.ncg;
    if (tap > 8) tap = 8, cg = 0;
    koff[kg] = (((tap / 3) * kHaloCols + tap % 3) * p.pstride + cg) * 16;
  }
  TileAt at = tile_at(t, tiles_y, tiles_x);
  // The weights into shared memory (asynchronous; the next wait covers them),
  // the bias into registers.
  {
    const uint32_t wbase = smem_addr(w_s);
    for (int i = tid; i < p.w_bytes / 16; i += kSmallThreads) cp_async16(wbase + i * 16, wk + i * 8);
  }
  float bias_r[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    bias_r[nt][0] = __ldg(bias + nt * 8 + 2 * (lane & 3));
    bias_r[nt][1] = __ldg(bias + nt * 8 + 2 * (lane & 3) + 1);
  }

  if (MODE == kDirectNhwc) {
    stage_direct(x, buf[0], p, at, H, W, cin);
    cp_async_commit();
  } else {
    stage_raw<MODE>(x, buf[1], at, H, W, cin);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    gather<MODE>(buf[1], buf[0], p, at, W, cin);
  }

  // Per lane: its A row in each m-tile (pixel column 16 mt + lane % 16 of row
  // `warp`; lanes 16..31 take the step's second k-group) and its B row.
  uint32_t a_row[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) a_row[mt] = ((warp * kHaloCols + mt * 16 + (lane & 15)) * p.pstride) * 16;
  const uint32_t b_row = smem_addr(w_s) +
                         ((((lane >> 3) & 1) * kCoPad + (lane >> 4) * 8 + (lane & 7)) * 16);
  const int khalf = lane >> 4;

  for (int cur = 0;; cur ^= 1) {
    const int tn = t + gridDim.x;
    const bool more = tn < n_tiles;
    const TileAt next = tile_at(more ? tn : t, tiles_y, tiles_x);
    unsigned char* tile = MODE == kDirectNhwc ? buf[cur] : buf[0];
    if (MODE == kDirectNhwc) {
      if (more) {
        stage_direct(x, buf[cur ^ 1], p, next, H, W, cin);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // the current tile has landed for every thread
    } else {
      __syncthreads();  // the tile is gathered, and no thread still reads the raw rows
      if (more) {
        stage_raw<MODE>(x, buf[1], next, H, W, cin);
        cp_async_commit();
      }
    }

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
    const uint32_t tile_a = smem_addr(tile);
#pragma unroll 2
    for (int s = 0; s < p.ksteps; ++s) {
      const int ko = koff[2 * s + khalf];
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(tile_a + a_row[mt] + ko, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
      const uint32_t bs = b_row + s * 2 * kCoPad * 16;
      uint32_t b[NT][2];
      if (NT == 1) {
        ldsm_x2(bs, b[0][0], b[0][1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          ldsm_x4(bs + j * 16 * 16, b[2 * j][0], b[2 * j][1], b[2 * j + 1][0], b[2 * j + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    __syncthreads();  // every warp is done with the tile: it now stages the output

    // acc[mt][nt][2h + e]: pixel 16 mt + lane / 4 + 8 h of row `warp`,
    // channel 8 nt + 2 (lane % 4) + e.
    __nv_bfloat16* o_s = reinterpret_cast<__nv_bfloat16*>(tile);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[mt][nt][2 * h] + bias_r[nt][0];
          float v1 = acc[mt][nt][2 * h + 1] + bias_r[nt][1];
          if (act == kRelu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          const int col = mt * 16 + (lane >> 2) + 8 * h, co = nt * 8 + 2 * (lane & 3);
          if (kNhwc) {
            *reinterpret_cast<uint32_t*>(o_s + (warp * kTileCols + col) * (kCoPad + 8) + co) =
                pack_bf16(v0, v1);
          } else {
            o_s[co * kOutPlane + warp * kOutPitch + col] = __float2bfloat16_rn(v0);
            o_s[(co + 1) * kOutPlane + warp * kOutPitch + col] = __float2bfloat16_rn(v1);
          }
        }
    __syncthreads();
    if (kNhwc) {
      if (cout % 8 == 0) {  // 8 channels of a pixel: 16 aligned bytes
        const int chunks = cout / 8;
        for (int i = tid; i < kTileRows * kTileCols * chunks; i += kSmallThreads) {
          const int k = i % chunks, px = i / chunks, r = px / kTileCols, c = px % kTileCols;
          if (at.x0 + c >= W) continue;
          *reinterpret_cast<uint4*>(out + (((size_t)at.b * H + at.y0 + r) * W + at.x0 + c) * cout + 8 * k) =
              *reinterpret_cast<const uint4*>(o_s + px * (kCoPad + 8) + 8 * k);
        }
      } else {
        for (int i = tid; i < kTileRows * kTileCols * cout; i += kSmallThreads) {
          const int k = i % cout, px = i / cout, r = px / kTileCols, c = px % kTileCols;
          if (at.x0 + c >= W) continue;
          out[(((size_t)at.b * H + at.y0 + r) * W + at.x0 + c) * cout + k] = o_s[px * (kCoPad + 8) + k];
        }
      }
    } else {  // 8 pixels of a channel row: 16 aligned bytes (x0 and W are multiples of 8)
      for (int i = tid; i < cout * kTileRows * (kTileCols / 8); i += kSmallThreads) {
        const int k = i % (kTileCols / 8), r = (i / (kTileCols / 8)) % kTileRows,
                  c = i / (kTileCols / 8 * kTileRows);
        if (at.x0 + 8 * k >= W) continue;
        *reinterpret_cast<uint4*>(out + (((size_t)at.b * cout + c) * H + at.y0 + r) * W + at.x0 + 8 * k) =
            *reinterpret_cast<const uint4*>(o_s + c * kOutPlane + r * kOutPitch + 8 * k);
      }
    }
    if (!more) return;
    if (MODE != kDirectNhwc) {
      cp_async_wait<0>();
      __syncthreads();  // the raw rows have landed, and the output is out of the tile
      gather<MODE>(buf[1], buf[0], p, next, W, cin);
    } else {
      __syncthreads();  // the output is out of buf[cur] before the next prefetch lands there
    }
    t = tn;
    at = next;
  }
}

template <int NT, int MODE>
int launch_small(const void* x, const void* wk, const float* bias, void* out, int B, int H, int W,
                 int cin, int cout, int act, cudaStream_t stream) {
  auto kernel = conv3x3_small_mma<NT, MODE>;
  const int smem = SmallPlan(cin, 8 * NT, MODE).bytes();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSmallThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = H / kTileRows, tiles_x = (W + kTileCols - 1) / kTileCols;
  const int n_tiles = B * tiles_y * tiles_x;
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  kernel<<<grid, kSmallThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wk), bias,
      static_cast<__nv_bfloat16*>(out), H, W, cin, cout, act, tiles_y, tiles_x, n_tiles);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_layout(const void* x, const void* wk, const float* bias, void* out, int B, int H, int W,
                  int cin, int cout, int relu, int nhwc, cudaStream_t s) {
  if (!nhwc) return launch_small<NT, kRawNchw>(x, wk, bias, out, B, H, W, cin, cout, relu, s);
  if (cin % 8 == 0) return launch_small<NT, kDirectNhwc>(x, wk, bias, out, B, H, W, cin, cout, relu, s);
  return launch_small<NT, kRawNhwc>(x, wk, bias, out, B, H, W, cin, cout, relu, s);
}

}  // namespace wct

// x [B, cin, H, W] (nhwc = 0) or [B, H, W, cin] (nhwc = 1), bf16; out the same
// layout with cout channels, 16-byte aligned. wk [2 * ksteps][co_pad][8] bf16,
// ksteps = ceil(9 * ceil(cin / 8) / 2): k-group kg = tap * ceil(cin / 8) + g
// holds w[co, 8g .. 8g + 7, tap / 3, tap % 3], zero-padded in channels, in
// co up to co_pad = 8 (cout <= 8) or 64, and in a last odd k-group. bias
// [co_pad] f32. H and W are multiples of 8, cin and cout in 1..64. Returns the
// CUDA error of the launch.
extern "C" int conv3x3_small_bf16(const void* x, const void* wk, const float* bias, void* out,
                                  int B, int H, int W, int cin, int cout, int relu, int nhwc,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cout <= 8) return wct::launch_layout<1>(x, wk, bias, out, B, H, W, cin, cout, relu, nhwc, s);
  return wct::launch_layout<8>(x, wk, bias, out, B, H, W, cin, cout, relu, nhwc, s);
}
