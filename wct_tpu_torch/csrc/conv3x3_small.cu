// 3x3 reflect convolution for small channel counts, bf16 in and out, on
// Hopper's wgmma.
//
// Replaces three TPU kernels that compute the same function in three layouts:
// wct_tpu/ops/conv_pallas.py::conv3x3_reflect_pallas (NHWC),
// scripts/exp_nchw_conv.py::conv3x3_reflect_nchw (NCHW) and
// scripts/exp_nchw_conv.py::conv3x3_reflect_nhwc_io (NHWC in and out). On
// x (bf16, C_in <= 64, H and W multiples of 8) with OIHW weights w and an f32
// bias:
//
//   out[b, y, x, o] = bf16( act( bias[o] + sum over ci, dy, dx of
//       x[b, reflect(y + dy - 1), reflect(x + dx - 1), ci] * w[o, ci, dy, dx] ) )
//
// with reflect(-1) = 1 and reflect(n) = n - 2, act = ReLU or the identity, the
// weights rounded to bf16, every product an exact bf16 x bf16 product, the sum
// kept in f32 and rounded once.
//
// Bound on an H100: 64 -> 64 at [4, 64, 512, 512] is 7.7e10 FLOP and 268 MB,
// 0.08 ms either way on the tensor cores; 64 -> 3 and 3 -> 64 move 140 MB,
// 0.04 ms, bytes.
//
// Design: an implicit GEMM, M = the pixels of a tile row, N = C_out (64, or 8
// when C_out <= 8), K = 9 taps x C_in, on wgmma with both operands read from
// shared memory through descriptors. A block is persistent (one per SM) and
// walks tiles of 4 rows x 64 columns, row-major within an image, so that
// neighbours' halo rows come from L2. The haloed tile [6 rows][66 columns] is
// kept channel-minor, G = C_in / 8 rounded up to 1, 2, 4 or 8 16-byte groups
// a pixel (the rest zero), K-major with the swizzle of its width (G = 8, 4, 2:
// 128-, 64-, 32-byte; G = 1: none). A tap's A operand is then the 64 pixels of
// one tile row shifted by (dy, dx): a descriptor whose start is that pixel's
// address (the swizzle follows the address bits, so any pixel will do). K is
// walked in k-groups of 8 channels, tap * G + group; a k-step takes two (G =
// 1: two taps, the last against zero weights). Warpgroup g takes tile rows 2
// g and 2 g + 1, each a row block of 64 pixels, and sums a bf16 partial per
// kFoldSteps<bf16> = 2 k-steps (both row blocks in one commit group) that it
// folds into an f32 sum while the next group runs; G is a template
// parameter, so the k-loop is unrolled and no wgmma is in flight across a
// loop's back edge. The RS form (A loaded by ldmatrix) on 8 x 32 tiles, four
// warpgroups of one row, stores from each warp's registers and other
// variants measured slower on the card; PERF.md has their times.
//
// The weights are laid out in the kernel from the caller's OIHW f32, once per
// block: chunk c, output channel n, k-group 8 c + u at byte c * C_pad * 128 +
// (n / 8) * 1024 + (n % 8) * 128 + 16 (u ^ n % 8) (the 128-byte swizzle),
// 73,728 bytes at C_out > 8. The wrapper launches nothing but the kernel.
//
// Staging by TMA tensor copies on mbarriers (tma.cuh):
//   NHWC, C_in = 8, 16, 32 or 64: one box [6 rows][66 columns][C_in] over a
//     [B * H, W, C_in] view, straight into the tile with the tile's swizzle,
//     in a ring of two tile slots: the next tile lands while this one is
//     multiplied.
//   NCHW: one box [6 rows][C_in][88 columns] (x0 - 8 .. x0 + 79: a box starts
//     on 16 bytes of a row) over the tensor seen as [B][H][C_in][W] (a map
//     whose strides are out of order: a channel's row is 176 bytes on, an
//     odd number of 16-byte units, so the 8 channel rows of one ldmatrix fall
//     in 8 bank groups); then 8 x 8 blocks of 8 channels and 8 aligned
//     columns are turned channel-minor by ldmatrix.trans + stmatrix (rows
//     outside the tile go to a scratch row).
//   NHWC, other C_in: five boxes of 16 pixels over [B * H, W * C_in / 8, 8];
//     each 16-byte group of the tile is two 16-byte loads and a funnel shift.
// The raw rows have two slots where they fit (C_out <= 8, or C_in small), else
// one, in flight behind the tile's products. Every staged tile is laid out
// and swizzled the same way whatever filled it, so the entries feed one
// compute body the same A values in the same k order and give the same bits. TMA fills rows and columns outside the tensor with
// zeros (rows -1 and H of an NHWC view are the neighbouring image's): an edge
// tile's halo rows and columns are then overwritten from their reflections
// (row -1 from row 1, row H from H - 2, column -1 from 1, column W from W -
// 2); columns past W + 1 stay zero and their outputs are dropped.
//
// The epilogue: bias, ReLU and the one rounding in registers; the tile goes to
// an output slot by stmatrix (NHWC at C_out = 64: 128-byte pixels swizzled;
// NCHW: a [C_out][64] box per tile row, 128-byte rows swizzled, transposed on
// the way) or by 2-byte stores (NHWC, other C_out), and leaves by TMA tensor
// stores, which drop what lies past W, behind the next tile's products.
//
// The host encodes two tensor maps a call; the shared-memory allowance and
// the grid are found once per kernel and device.
//
// The summation order of every output is fixed (the k-groups in order, a
// partial per 2 k-steps, wgmma's own order inside), there are no atomics and
// no split of K across blocks, and a tile's arithmetic does not depend on the
// block that runs it: an image gives the same bits alone and in any batch.

#include "conv_wgmma.cuh"
#include "tma.cuh"

namespace wct {

// Stage stamps: built with -DWCT_STAGE_TIMES, thread 0 writes kSmallStamps
// 64-bit values per tile (index t < kSmallStampTiles) into g_small_stamps
// (conv3x3_small_stamps() copies them out): clock64 at the tile's start,
// once its tile is staged (the input's wait, and the raw forms' conversion),
// after the halo patch and its barrier, after the products, after the
// epilogue's writes and barriers, and once the stores are issued; then
// %globaltimer (ns) at the start and after the stores' issue. The normal build
// has none of this.
#ifdef WCT_STAGE_TIMES
constexpr int kSmallStamps = 8;
constexpr int kSmallStampTiles = 8192;
__device__ long long g_small_stamps[kSmallStampTiles * kSmallStamps];

__device__ __forceinline__ long long small_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define SSTAMP(k, v)                                                              \
  do {                                                                            \
    const int t_ = blockIdx.x + i * gridDim.x;                                    \
    if (tid == 0 && t_ < kSmallStampTiles) g_small_stamps[t_ * kSmallStamps + (k)] = (v); \
  } while (0)
#else
#define SSTAMP(k, v)
#endif

constexpr int kSmallThreads = 256;        // two warpgroups, two tile rows each
constexpr int kTileRows = 4, kTileCols = 64;
constexpr int kHaloRows = kTileRows + 2;  // 6
constexpr int kHaloCols = kTileCols + 2;  // 66
constexpr int kHaloPixels = kHaloRows * kHaloCols;
constexpr int kRawCols = kTileCols + 24;  // NCHW raw rows: columns x0-8 .. x0+79
constexpr int kRawBlocks = 10;            // their 8-column blocks that reach the tile
constexpr int kRawPieces = 5;             // NHWC raw rows: five boxes of 16 pixels
constexpr int kSmallRB = 2;               // row blocks (tile rows) per warpgroup

constexpr int kMaxDevices = 64;           // devices whose launch plan is cached

enum Staging { kDirectNhwc = 0, kRawNhwc = 1, kRawNchw = 2 };
enum Act { kIdentity = 0, kRelu = 1 };

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// 16-byte groups a pixel of the tile: ceil(C_in / 8) rounded up to a power of 2.
__host__ __device__ constexpr int tile_groups(int cin) {
  return cin <= 8 ? 1 : cin <= 16 ? 2 : cin <= 32 ? 4 : 8;
}

// The tile's swizzle for G groups a pixel (m = 7: 128-byte, 3: 64-byte, 1:
// 32-byte, 0: none), and a byte offset from a 1 KB-aligned base as that
// swizzle places it: the 16-byte unit's bits 4.. XOR the offset's bits 7...
__host__ __device__ constexpr uint32_t tile_swizzle(int g) {
  return g == 8 ? 7 : g == 4 ? 3 : g == 2 ? 1 : 0;
}

__host__ __device__ __forceinline__ uint32_t swz(uint32_t off, uint32_t m) {
  return off ^ (((off >> 7) & m) << 4);
}

// Shared-memory plan, the same on host and device; offsets from a 1 KB-aligned
// base.
struct SmallPlan {
  int g, pix, swz, nchunks, co_pad, tile_bytes, raw_piece, row_box, out_half, raw_bytes, raw_slots;
  int tile_off, out_off, raw_off, misc_off, bytes;
  __host__ __device__ SmallPlan(int cin, int cout, int mode) {
    g = tile_groups(cin);
    pix = 16 * g;  // bytes of a pixel in the tile
    swz = tile_swizzle(g);
    nchunks = (9 * g + 7) / 8;
    co_pad = cout <= 8 ? 8 : 64;
    tile_bytes = round_up(kHaloPixels * pix, 1024);
    raw_piece = round_up(kHaloRows * 16 * cin * 2, 128);
    row_box = co_pad * 128;                               // NCHW output: a tile row's [C_out][64]
    out_half = round_up(kTileRows * 32 * cout * 2, 128);  // other NHWC: [4][32][C_out] a half
    raw_bytes = round_up(mode == kRawNchw   ? cin * kHaloRows * kRawCols * 2
                         : mode == kRawNhwc ? kRawPieces * raw_piece + 16  // the last group's second load
                                            : 0,
                         128);
    const int out = mode == kRawNchw ? kTileRows * row_box
                    : cout == 64     ? kTileRows * kTileCols * 128
                                     : 2 * out_half;
    tile_off = nchunks * co_pad * 128;
    out_off = tile_off + (mode == kDirectNhwc ? 2 : 1) * tile_bytes;
    raw_off = out_off + round_up(out, 1024);
    // Two raw slots where they fit (the next tile's rows land while this one
    // is converted and multiplied), else one.
    raw_slots = 1024 + raw_off + 2 * raw_bytes + 48 <= 232448 ? 2 : 1;
    misc_off = raw_off + raw_slots * raw_bytes;
    bytes = 1024 + misc_off + 48;  // misc: a zero unit, a scratch unit, two mbarriers
  }
};

// Overwrite an edge tile's halo pixels outside the image with their
// reflections; rcol is the staged column of image column W, or -1.
__device__ __forceinline__ void patch_halo(unsigned char* tile, const SmallPlan& p, bool top,
                                           bool bottom, bool left, int rcol) {
  for (int i = threadIdx.x; i < kHaloPixels * p.g; i += kSmallThreads) {
    const int px = i % kHaloPixels, cg = i / kHaloPixels;
    const int r = px / kHaloCols, c = px % kHaloCols;
    const int rr = top && r == 0 ? 2 : bottom && r == kHaloRows - 1 ? kHaloRows - 3 : r;
    const int cc = left && c == 0 ? 2 : c == rcol ? rcol - 2 : c;
    if (rr == r && cc == c) continue;  // sources are never patched themselves
    *reinterpret_cast<uint4*>(tile + swz(px * p.pix + 16 * cg, p.swz)) =
        *reinterpret_cast<const uint4*>(tile + swz((rr * kHaloCols + cc) * p.pix + 16 * cg, p.swz));
  }
}

// NCHW raw rows [6][C_in][88] -> the tile: per warp, four 8 x 8 blocks (8
// channels of one group, 8 aligned raw columns of one row) a step.
__device__ __forceinline__ void nchw_to_tile(const unsigned char* raw, unsigned char* tile,
                                             const SmallPlan& p, int cin, uint32_t zero,
                                             uint32_t scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mi = lane >> 3, rw = lane & 7;
  const int items = kHaloRows * kRawBlocks * p.g;  // a multiple of 4
  for (int it0 = 4 * warp; it0 < items; it0 += 4 * (kSmallThreads / 32)) {
    const int it = it0 + mi;
    const int k = it % kRawBlocks, r = it / kRawBlocks % kHaloRows, cg = it / (kRawBlocks * kHaloRows);
    const int ch = 8 * cg + rw;
    const uint32_t src = ch < cin ? smem_addr(raw + ((r * cin + ch) * kRawCols + 8 * k) * 2) : zero;
    uint32_t v0, v1, v2, v3;
    ldsm_x4_trans(src, v0, v1, v2, v3);
    const int col = 8 * k - 7 + rw;  // raw column 8 k + rw is tile column 8 k + rw - 7
    const uint32_t dst = col >= 0 && col < kHaloCols
                             ? smem_addr(tile + swz((r * kHaloCols + col) * p.pix + 16 * cg, p.swz))
                             : scratch;
    stsm_x4(dst, v0, v1, v2, v3);
  }
}

// NHWC raw rows (five pieces [6][16 * C_in], raw_piece bytes apart) -> the
// tile, one 16-byte group (8 channels of a pixel) a step; channels past C_in
// are zero.
__device__ __forceinline__ void nhwc_to_tile(const unsigned char* raw, unsigned char* tile,
                                             const SmallPlan& p, int cin) {
  for (int i = threadIdx.x; i < kHaloPixels * p.g; i += kSmallThreads) {
    const int px = i % kHaloPixels, cg = i / kHaloPixels;
    const int valid = cin - 8 * cg;  // channels of the group inside C_in
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    if (valid > 0) {
      const int r = px / kHaloCols, rc = px % kHaloCols + 7;  // raw column
      const int q = rc / 16;
      const int e = (r * 16 + rc % 16) * cin + 8 * cg;  // element in its piece
      const uint4* src = reinterpret_cast<const uint4*>(raw + q * p.raw_piece) + (e >> 3);
      const uint4 u0 = src[0], u1 = src[1];
      const uint32_t w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const int s = e & 7, ws = s >> 1;  // the group's first element, in halves and words of u0
      uint32_t sel[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        uint32_t v = w[k];
        v = ws == 1 ? w[k + 1] : v;
        v = ws == 2 ? w[k + 2] : v;
        v = ws == 3 ? w[k + 3] : v;
        sel[k] = v;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t v = s & 1 ? __funnelshift_r(sel[k], sel[k + 1], 16) : sel[k];
        o[k] = 2 * k + 1 < valid ? v : 2 * k < valid ? v & 0xffffu : 0u;
      }
    }
    *reinterpret_cast<uint4*>(tile + swz(px * p.pix + 16 * cg, p.swz)) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The descriptor of k-step s's A for the tile row whose tap (0, 0) pixel is
// at shared address `row` (G groups a pixel): K-major, 8-pixel core matrices
// 8 * 16 G bytes apart; G = 1 pairs two taps, the second (LBO) one tap on.
template <int G>
__device__ __forceinline__ uint64_t desc_tile(uint32_t row, int s) {
  constexpr int kPix = 16 * G;
  constexpr uint64_t kType = G == 8 ? 1 : G == 4 ? 2 : G == 2 ? 3 : 0;
  const int kg = 2 * s, tap = kg / G;
  const uint32_t tapoff = ((tap / 3) * kHaloCols + tap % 3) * kPix;
  uint32_t lbo = 16;  // unused by the swizzled layouts
  if (G == 1) {
    const int t2 = tap + 1 < 9 ? tap + 1 : tap;  // the pad k-group reads tap 8 against zero weights
    lbo = ((t2 / 3) * kHaloCols + t2 % 3) * kPix - tapoff;
  }
  const uint32_t addr = row + tapoff + 16 * (kg % G);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)((8 * kPix) >> 4) << 32 | kType << 62;
}

// acc[rb] = the conv sums of row block rb (tile row kSmallRB wg + rb, 64 pixels) of
// warpgroup wg, from the tile at `tile` and the weights at `wts`.
template <int G, int NA>
__device__ __forceinline__ void tile_products(float (&acc)[kSmallRB][NA], uint32_t tile, uint32_t wts,
                                              int co_pad) {
  constexpr int kS = (9 * G + 1) / 2;  // k-steps
  constexpr int kF = kFoldSteps<bf16>;
  constexpr int kGroups = (kS + kF - 1) / kF;
  const int wg = threadIdx.x >> 7;
  float part[2][kSmallRB][NA];
#pragma unroll
  for (int rb = 0; rb < kSmallRB; ++rb)
#pragma unroll
    for (int k = 0; k < NA; ++k) acc[rb][k] = 0.f;
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    wgmma_fence();
#pragma unroll
    for (int rb = 0; rb < kSmallRB; ++rb) {
      const uint32_t row = tile + (kSmallRB * wg + rb) * kHaloCols * 16 * G;
#pragma unroll
      for (int s = gi * kF; s < (gi * kF + kF < kS ? gi * kF + kF : kS); ++s)
        wgmma_bf16_ss(part[gi & 1][rb], desc_tile<G>(row, s),
                      desc_sw128(wts + (s / 4) * co_pad * 128 + 32 * (s % 4)), s > gi * kF);
    }
    wgmma_commit();
    if (gi > 0) {
      wgmma_wait<1>();  // group gi - 1
#pragma unroll
      for (int rb = 0; rb < kSmallRB; ++rb) fold(acc[rb], part[(gi - 1) & 1][rb]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int rb = 0; rb < kSmallRB; ++rb) fold(acc[rb], part[(kGroups - 1) & 1][rb]);
}

// in_map: NHWC direct [B * H, W, C_in] in boxes [6][66][C_in] (the tile's
// swizzle); NHWC raw [B * H, W * C_in / 8, 8] in boxes [6][2 C_in][8]; NCHW
// [B][H][C_in][W] in boxes [6][C_in][88]. out_map: NCHW [B * C_out, H, W] in
// boxes [C_out][1][64] (128-byte swizzle); NHWC at C_out = 64 [B * H, W, 64]
// in boxes [4][64][64] (128-byte swizzle); other NHWC [B * H, W * C_out / 8,
// 8] in boxes [4][4 C_out][8]. NA: accumulators a thread a row block (32: N =
// 64; 4: N = 8).
template <int G, int NA, int MODE>
__global__ void __launch_bounds__(kSmallThreads, 1)
conv3x3_small_wgmma(const __grid_constant__ CUtensorMap in_map,
                    const __grid_constant__ CUtensorMap out_map, const float* __restrict__ w,
                    const float* __restrict__ bias, int H, int W, int cin, int cout, int act,
                    int tiles_x, int per_image, int n_tiles) {
  constexpr int kNT = NA / 4;  // n-tiles of 8 output channels
  extern __shared__ float4 smem4[];
  // Aligned by pointer arithmetic on the shared array itself, so that every
  // access below stays a shared-memory one.
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4) + (-smem_addr(smem4) & 1023u);
  const SmallPlan p(cin, cout, MODE);
  unsigned char* w_s = base;
  unsigned char* tile_s = base + p.tile_off;
  unsigned char* out_s = base + p.out_off;
  unsigned char* raw_s = base + p.raw_off;
  unsigned char* misc = base + p.misc_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(misc + 32);
  const uint32_t zero = smem_addr(misc), scratch = zero + 16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int n_mine = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const auto tile_at = [&](int i, int& b, int& y0, int& x0) {
    const int tt = blockIdx.x + i * gridDim.x, r = tt % per_image;
    b = tt / per_image;
    y0 = (r / tiles_x) * kTileRows;
    x0 = (r % tiles_x) * kTileCols;
  };
  // One thread: block tile i's input in flight, into tile slot i % 2 (direct)
  // or raw slot i % raw_slots.
  const int slots = MODE == kDirectNhwc ? 2 : p.raw_slots;
  const auto issue = [&](int i) {
    int b, y0, x0;
    tile_at(i, b, y0, x0);
    const uint32_t bar = smem_addr(full + i % slots);
    unsigned char* raw = raw_s + (i % slots) * p.raw_bytes;
    if (MODE == kDirectNhwc) {
      mbar_expect_tx(bar, kHaloPixels * cin * 2);
      tma_load_3d(smem_addr(tile_s + (i & 1) * p.tile_bytes), &in_map, 0, x0 - 1, b * H + y0 - 1,
                  bar);
    } else if (MODE == kRawNchw) {
      mbar_expect_tx(bar, cin * kHaloRows * kRawCols * 2);
      tma_load_4d(smem_addr(raw), &in_map, x0 - 8, 0, y0 - 1, b, bar);
    } else {
      mbar_expect_tx(bar, kRawPieces * kHaloRows * 16 * cin * 2);
      for (int q = 0; q < kRawPieces; ++q)
        tma_load_3d(smem_addr(raw + q * p.raw_piece), &in_map, 0, (x0 / 8 - 1 + 2 * q) * cin,
                    b * H + y0 - 1, bar);
    }
  };

  if (tid == 0) {
    mbar_init(smem_addr(full), 1);
    mbar_init(smem_addr(full + 1), 1);
  }
  __syncthreads();  // the barriers are set up
  if (tid == 0)
    for (int i = 0; i < slots && i < n_mine; ++i) issue(i);
  // The weights: zeros, then each OIHW value, rounded to bf16, at its place.
  for (int i = tid; i < p.tile_off / 16; i += kSmallThreads)
    reinterpret_cast<uint4*>(w_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) reinterpret_cast<uint4*>(misc)[0] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int pr = tid; pr < cout * cin; pr += kSmallThreads) {
    const int co = pr / cin, ci = pr % cin;
    const float* src = w + (size_t)pr * 9;
    unsigned char* row = w_s + (co >> 3) * 1024 + (co & 7) * 128 + 2 * (ci & 7);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int kg = tap * G + (ci >> 3);
      *reinterpret_cast<__nv_bfloat16*>(row + (kg >> 3) * (p.co_pad * 128) + 16 * ((kg & 7) ^ (co & 7))) =
          __float2bfloat16_rn(__ldg(src + tap));
    }
  }
  fence_proxy_async();  // the weights are read by wgmma, the asynchronous proxy
  float bias_r[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * nt + 2 * t + e;
      bias_r[nt][e] = ch < cout ? __ldg(bias + ch) : 0.f;
    }
  __syncthreads();

  const uint32_t w_base = smem_addr(w_s), out_a = smem_addr(out_s);
  const int wg = warp >> 2, wi = warp & 3;  // warpgroup; the warp's 16 pixels of a row block
  for (int i = 0; i < n_mine; ++i) {
    int b, y0, x0;
    tile_at(i, b, y0, x0);
    SSTAMP(0, clock64());
    SSTAMP(6, small_ns());
    unsigned char* tile = tile_s + (MODE == kDirectNhwc ? (i & 1) * p.tile_bytes : 0);
    bool generic = false;  // the tile holds generic writes that wgmma must see
    if (MODE == kDirectNhwc) {
      mbar_wait(smem_addr(full + (i & 1)), (i >> 1) & 1);
    } else {
      mbar_wait(smem_addr(full + i % slots), (i / slots) & 1);
      const unsigned char* raw = raw_s + (i % slots) * p.raw_bytes;
      if (MODE == kRawNchw)
        nchw_to_tile(raw, tile, p, cin, zero, scratch);
      else
        nhwc_to_tile(raw, tile, p, cin);
      generic = true;
    }
    SSTAMP(1, clock64());
    const bool top = y0 == 0, bottom = y0 + kTileRows == H, left = x0 == 0;
    const int rcol = W - x0 + 1 < kHaloCols ? W - x0 + 1 : -1;
    if (top || bottom || left || rcol >= 0) {
      if (generic) __syncthreads();  // the staged tile is whole
      patch_halo(tile, p, top, bottom, left, rcol);
      generic = true;
    }
    if (generic) {
      fence_proxy_async();  // these writes are read by wgmma
      __syncthreads();
      if (MODE != kDirectNhwc && tid == 0 && i + slots < n_mine) {
        fence_proxy_async();  // the raw rows' generic reads before the copy's writes
        issue(i + slots);
      }
    }

    SSTAMP(2, clock64());
    float acc[kSmallRB][NA];
    tile_products<G>(acc, smem_addr(tile), w_base, p.co_pad);
    SSTAMP(3, clock64());

    if (tid == 0) bulk_wait_read();  // the last tile's stores have read the output slot
    __syncthreads();  // every warpgroup is done with this tile; the output slot is free
    if (MODE == kDirectNhwc && tid == 0 && i + 2 < n_mine) {
      fence_proxy_async();  // the slot's patches before the copy's writes
      issue(i + 2);
    }

    // acc[rb][4 nt + e]: pixel 16 wi + g + 8 (e >> 1) of tile row kSmallRB wg + rb,
    // channel 8 nt + 2 t + (e & 1); v[rb][nt][h] the bf16 pair of pixel g + 8 h.
    uint32_t v[kSmallRB][kNT][2];
#pragma unroll
    for (int rb = 0; rb < kSmallRB; ++rb)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[rb][4 * nt + 2 * h] + bias_r[nt][0];
          float v1 = acc[rb][4 * nt + 2 * h + 1] + bias_r[nt][1];
          if (act == kRelu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          v[rb][nt][h] = pack_bf16(v0, v1);
        }
    const int mi = lane >> 3, rw = lane & 7;  // stmatrix: lane's matrix and row
    if (MODE == kRawNchw) {  // matrix rows: 8 channels, each 8 pixels of the row's box
#pragma unroll
      for (int rb = 0; rb < kSmallRB; ++rb) {
        const uint32_t box = out_a + (kSmallRB * wg + rb) * p.row_box;
        const int k = 2 * wi + (mi & 1);  // the 16-byte piece of the channel row
        if constexpr (kNT == 1) {
          stsm_x2_trans(box + swz(rw * 128 + 16 * k, 7), v[rb][0][0], v[rb][0][1]);
        } else {
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            const int ch = 8 * (2 * np + (mi >> 1)) + rw;
            stsm_x4_trans(box + swz(ch * 128 + 16 * k, 7), v[rb][2 * np][0], v[rb][2 * np][1],
                          v[rb][2 * np + 1][0], v[rb][2 * np + 1][1]);
          }
        }
      }
    } else if (kNT == 8 && cout == 64) {  // matrix rows: 8 pixels, each 8 channels
#pragma unroll
      for (int rb = 0; rb < kSmallRB; ++rb)
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          const int q = (kSmallRB * wg + rb) * kTileCols + 16 * wi + 8 * (mi & 1) + rw;
          stsm_x4(out_a + swz(q * 128 + 16 * (2 * np + (mi >> 1)), 7), v[rb][2 * np][0],
                  v[rb][2 * np][1], v[rb][2 * np + 1][0], v[rb][2 * np + 1][1]);
        }
    } else {  // two halves [4][32][C_out], a value at a time
#pragma unroll
      for (int rb = 0; rb < kSmallRB; ++rb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 16 * wi + g + 8 * h;  // the pixel
          uint16_t* o = reinterpret_cast<uint16_t*>(out_s + (x >> 5) * p.out_half) +
                        ((kSmallRB * wg + rb) * 32 + (x & 31)) * cout;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ch = 8 * nt + 2 * t + e;
              if (ch < cout) o[ch] = (uint16_t)(v[rb][nt][h] >> (16 * e));
            }
        }
    }
    fence_proxy_async();  // the output slot's writes before the stores read it
    __syncthreads();
    SSTAMP(4, clock64());
    if (tid == 0) {
      if (MODE == kRawNchw) {
        for (int r = 0; r < kTileRows; ++r)
          tma_store_3d(&out_map, x0, y0 + r, b * cout, out_a + r * p.row_box);
      } else if (cout == 64) {
        tma_store_3d(&out_map, 0, x0, b * H + y0, out_a);
      } else {
        tma_store_3d(&out_map, 0, x0 / 8 * cout, b * H + y0, out_a);
        if (x0 + 32 < W)
          tma_store_3d(&out_map, 0, (x0 / 8 + 4) * cout, b * H + y0, out_a + p.out_half);
      }
      bulk_commit();
    }
    SSTAMP(5, clock64());
    SSTAMP(7, small_ns());
  }
  if (tid == 0) bulk_wait();
}

namespace {
// Per kernel (G, N, layout form) and device: the shared memory it was allowed
// and the blocks that then fit on the card.
int g_plan_bytes[4 * 2 * 3][kMaxDevices], g_plan_blocks[4 * 2 * 3][kMaxDevices];
}  // namespace

constexpr int kernel_index(int g, int na, int mode) {
  return ((g == 1 ? 0 : g == 2 ? 1 : g == 4 ? 2 : 3) * 2 + (na == 32)) * 3 + mode;
}

inline CUtensorMapSwizzle swizzle_of(uint32_t m) {
  return m == 7 ? CU_TENSOR_MAP_SWIZZLE_128B
         : m == 3 ? CU_TENSOR_MAP_SWIZZLE_64B
         : m == 1 ? CU_TENSOR_MAP_SWIZZLE_32B
                  : CU_TENSOR_MAP_SWIZZLE_NONE;
}

template <int G, int NA, int MODE>
int launch_small(const void* x, const float* w, const float* bias, void* out, int B, int H, int W,
                 int cin, int cout, int act, cudaStream_t stream) {
  const SmallPlan p(cin, cout, MODE);
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t Bu = B, Hu = H, Wu = W, ci = cin, co = cout;
  CUtensorMap in_map = {}, out_map = {};
  cudaError_t err;
  if (MODE == kDirectNhwc) {
    const uint64_t dims[3] = {ci, Wu, Bu * Hu}, strides[2] = {ci * 2, Wu * ci * 2};
    const uint32_t box[3] = {(uint32_t)cin, kHaloCols, kHaloRows};
    err = encode_tiled(&in_map, bf, 3, x, dims, strides, box, swizzle_of(p.swz));
  } else if (MODE == kRawNhwc) {
    const uint64_t dims[3] = {8, Wu * ci / 8, Bu * Hu}, strides[2] = {16, Wu * ci * 2};
    const uint32_t box[3] = {8, 2 * (uint32_t)cin, kHaloRows};
    err = encode_tiled(&in_map, bf, 3, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {  // [B][H][C_in][W]: a box lands as [rows][channels][columns]
    const uint64_t dims[4] = {Wu, ci, Hu, Bu}, strides[3] = {Hu * Wu * 2, Wu * 2, ci * Hu * Wu * 2};
    const uint32_t box[4] = {kRawCols, (uint32_t)cin, kHaloRows, 1};
    err = encode_tiled(&in_map, bf, 4, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return (int)err;
  if (MODE == kRawNchw) {
    const uint64_t dims[3] = {Wu, Hu, Bu * co}, strides[2] = {Wu * 2, Hu * Wu * 2};
    const uint32_t box[3] = {kTileCols, 1, (uint32_t)cout};
    err = encode_tiled(&out_map, bf, 3, out, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  } else if (cout == 64) {
    const uint64_t dims[3] = {64, Wu, Bu * Hu}, strides[2] = {128, Wu * 128};
    const uint32_t box[3] = {64, kTileCols, kTileRows};
    err = encode_tiled(&out_map, bf, 3, out, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    const uint64_t dims[3] = {8, Wu * co / 8, Bu * Hu}, strides[2] = {16, Wu * co * 2};
    const uint32_t box[3] = {8, 4 * (uint32_t)cout, kTileRows};
    err = encode_tiled(&out_map, bf, 3, out, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return (int)err;
  auto kernel = conv3x3_small_wgmma<G, NA, MODE>;
  // The shared-memory allowance and the resident blocks, once per kernel,
  // device and shared-memory size: they cost more host time than a small
  // call's kernel. (Kept in an anonymous namespace: a function-local static
  // of a template would be one symbol for every library that holds this
  // source, a stamped build's too.)
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int* cached_bytes = g_plan_bytes[kernel_index(G, NA, MODE)];
  int* cached_blocks = g_plan_blocks[kernel_index(G, NA, MODE)];
  if (cached_bytes[dev] != p.bytes) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSmallThreads, p.bytes);
    if (err != cudaSuccess) return (int)err;
    cached_bytes[dev] = p.bytes;
    cached_blocks[dev] = sms * per_sm;
  }
  const int tiles_x = (W + kTileCols - 1) / kTileCols, per_image = tiles_x * (H / kTileRows);
  const int n_tiles = B * per_image;
  const int grid = n_tiles < cached_blocks[dev] ? n_tiles : cached_blocks[dev];
  kernel<<<grid, kSmallThreads, p.bytes, stream>>>(in_map, out_map, w, bias, H, W, cin, cout, act,
                                                   tiles_x, per_image, n_tiles);
  return (int)cudaGetLastError();
}

template <int G, int NA>
int launch_layout(const void* x, const float* w, const float* bias, void* out, int B, int H, int W,
                  int cin, int cout, int relu, int nhwc, cudaStream_t s) {
  if (!nhwc) return launch_small<G, NA, kRawNchw>(x, w, bias, out, B, H, W, cin, cout, relu, s);
  if (cin == 8 * G) return launch_small<G, NA, kDirectNhwc>(x, w, bias, out, B, H, W, cin, cout, relu, s);
  return launch_small<G, NA, kRawNhwc>(x, w, bias, out, B, H, W, cin, cout, relu, s);
}

template <int G>
int launch_width(const void* x, const float* w, const float* bias, void* out, int B, int H, int W,
                 int cin, int cout, int relu, int nhwc, cudaStream_t s) {
  if (cout <= 8) return launch_layout<G, 4>(x, w, bias, out, B, H, W, cin, cout, relu, nhwc, s);
  return launch_layout<G, 32>(x, w, bias, out, B, H, W, cin, cout, relu, nhwc, s);
}

}  // namespace wct

// x [B, cin, H, W] (nhwc = 0) or [B, H, W, cin] (nhwc = 1), bf16, 16-byte
// aligned; out the same layout with cout channels, 16-byte aligned. w [cout,
// cin, 3, 3] f32 (OIHW, rounded to bf16 in the kernel), bias [cout] f32. H
// and W multiples of 8, cin and cout in 1..64. Returns the CUDA error of the
// launch.
#ifdef WCT_STAGE_TIMES
// Copies n 64-bit stamps (at most kSmallStampTiles * kSmallStamps) of the
// last launches into dst (device memory) on `stream`. Returns the CUDA error.
extern "C" int conv3x3_small_stamps(void* dst, int n, void* stream) {
  if (n > wct::kSmallStampTiles * wct::kSmallStamps) n = wct::kSmallStampTiles * wct::kSmallStamps;
  return (int)cudaMemcpyFromSymbolAsync(dst, wct::g_small_stamps, (size_t)n * 8, 0,
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
}
#endif

extern "C" int conv3x3_small_bf16(const void* x, const float* w, const float* bias, void* out,
                                  int B, int H, int W, int cin, int cout, int relu, int nhwc,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (wct::tile_groups(cin)) {
    case 1: return wct::launch_width<1>(x, w, bias, out, B, H, W, cin, cout, relu, nhwc, s);
    case 2: return wct::launch_width<2>(x, w, bias, out, B, H, W, cin, cout, relu, nhwc, s);
    case 4: return wct::launch_width<4>(x, w, bias, out, B, H, W, cin, cout, relu, nhwc, s);
    default: return wct::launch_width<8>(x, w, bias, out, B, H, W, cin, cout, relu, nhwc, s);
  }
}
