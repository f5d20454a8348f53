// 3x3 reflect convolution for small channel counts, bf16 in and out.
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
// 0.08 ms either way on the tensor cores; 64 -> 3 is 140 MB, 0.04 ms, bytes.
// This first kernel multiplies with FFMA on upconverted values, which gives the
// same f32 sums of exact products as an mma would but cannot go below
// FLOP / 67 TFLOP/s (1.15 ms for 64 -> 64). Tensor cores are left for later.
//
// One body, templated on the layout and on how the 8 warps of a block split the
// work. A block owns 8 rows x (32 * PW) columns of one image for 8 * CW output
// channels, CW * PW = 8: warp (cw, pw) owns output channels 8cw..8cw+7 (its
// weight reads are shared-memory broadcasts) on columns 32pw..32pw+31, and a
// lane owns one row segment of 8 pixels, so a weight fetch feeds 8 pixels and a
// 10-value input row feeds 3 taps: 192 FMAs per 9 loads.
//   wide   (C_out > 8):  CW = 8, PW = 1, input channels staged 8 at a time;
//   narrow (C_out <= 8): CW = 1, PW = 8, staged 4 at a time, so that a 64 -> 3
//                        conv keeps every warp busy on pixels.
// The haloed input tile is loaded with explicit reflected indices (a bulk tensor
// copy can only zero-fill) and converted to f32 as it is staged. Both layouts
// are read and written in place: NHWC takes no permuted copy. Columns past the
// image edge are clamped on load and masked on store; W is a multiple of 8, so a
// lane's segment is in or out whole. The summation order of every output is
// fixed (ci, then dy, then dx), there are no atomics, and nothing depends on
// the batch: an image gives the same bits alone and in any batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wct {

constexpr int kSmallThreads = 256;
constexpr int kSmallRows = 8;   // tile rows
constexpr int kSeg = 8;         // pixels of one row that a lane owns
constexpr int kWarpCols = 32;   // columns a warp covers: 4 segments

__device__ __forceinline__ int reflect_index(int g, int n) {
  return g < 0 ? -g : (g >= n ? 2 * (n - 1) - g : g);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// w [cin_pad][9][8 * CW] f32 (bf16 values), bias [8 * CW] f32, both zero-padded.
template <int CW, int PW, int KC, bool NHWC>
__global__ void __launch_bounds__(kSmallThreads)
conv3x3_small_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H,
                     int W, int cin, int cout, int relu) {
  static_assert(CW * PW == 8, "8 warps");
  constexpr int kCo = 8 * CW;
  constexpr int kCols = PW * kWarpCols;
  constexpr int kLoadCols = kCols + 2;
  constexpr int kPitch = kCols + 4;  // a multiple of 4: float4 reads stay aligned
  constexpr int kInRows = kSmallRows + 2;
  __shared__ __align__(16) float in_s[KC * kInRows * kPitch];
  __shared__ __align__(16) float w_s[KC * 9 * kCo];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int co0 = (warp % CW) * 8;
  const int row = lane >> 2;
  const int lx = (warp / CW) * kWarpCols + (lane & 3) * kSeg;
  const int x0 = blockIdx.x * kCols, y0 = blockIdx.y * kSmallRows, b = blockIdx.z;
  const bool active = x0 + lx < W && co0 < cout;

  float acc[kSeg][8] = {};
  for (int c0 = 0; c0 < cin; c0 += KC) {
    __syncthreads();
    {
      const float4* src = reinterpret_cast<const float4*>(w + (size_t)c0 * 9 * kCo);
      float4* dst = reinterpret_cast<float4*>(w_s);
      for (int i = tid; i < KC * 9 * kCo / 4; i += kSmallThreads) dst[i] = __ldg(src + i);
    }
    for (int i = tid; i < KC * kInRows * kLoadCols; i += kSmallThreads) {
      int c, y, xx;
      if (NHWC) {
        c = i % KC;
        xx = (i / KC) % kLoadCols;
        y = i / (KC * kLoadCols);
      } else {
        xx = i % kLoadCols;
        y = (i / kLoadCols) % kInRows;
        c = i / (kLoadCols * kInRows);
      }
      float v = 0.f;
      if (c0 + c < cin) {
        const int gy = reflect_index(y0 - 1 + y, H);
        const int gx = min(max(reflect_index(x0 - 1 + xx, W), 0), W - 1);
        const size_t off = NHWC ? (((size_t)b * H + gy) * W + gx) * cin + c0 + c
                                : (((size_t)b * cin + c0 + c) * H + gy) * W + gx;
        v = __bfloat162float(x[off]);
      }
      in_s[(c * kInRows + y) * kPitch + xx] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* rp = in_s + (c * kInRows + row + dy) * kPitch + lx;
        const float4 p0 = *reinterpret_cast<const float4*>(rp);
        const float4 p1 = *reinterpret_cast<const float4*>(rp + 4);
        const float2 p2 = *reinterpret_cast<const float2*>(rp + 8);
        const float xv[10] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wp = w_s + (c * 9 + dy * 3 + dx) * kCo + co0;
          const float4 wa = *reinterpret_cast<const float4*>(wp);
          const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < kSeg; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(xv[j + dx], wv[k], acc[j][k]);
        }
      }
    }
  }
  if (!active) return;

  const int gy = y0 + row, gx = x0 + lx;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float bk = __ldg(bias + co0 + k);
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      acc[j][k] += bk;
      if (relu) acc[j][k] = fmaxf(acc[j][k], 0.f);
    }
  }
  if (NHWC) {
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      __nv_bfloat16* o = out + (((size_t)b * H + gy) * W + gx + j) * cout + co0;
      if (cout % 8 == 0) {  // the pixel's 8 channels are 16 aligned bytes
        *reinterpret_cast<uint4*>(o) =
            make_uint4(pack_bf16(acc[j][0], acc[j][1]), pack_bf16(acc[j][2], acc[j][3]),
                       pack_bf16(acc[j][4], acc[j][5]), pack_bf16(acc[j][6], acc[j][7]));
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (co0 + k < cout) o[k] = __float2bfloat16_rn(acc[j][k]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (co0 + k >= cout) continue;
      // 8 pixels of one row: gx and W are multiples of 8, so 16 aligned bytes
      __nv_bfloat16* o = out + (((size_t)b * cout + co0 + k) * H + gy) * W + gx;
      *reinterpret_cast<uint4*>(o) =
          make_uint4(pack_bf16(acc[0][k], acc[1][k]), pack_bf16(acc[2][k], acc[3][k]),
                     pack_bf16(acc[4][k], acc[5][k]), pack_bf16(acc[6][k], acc[7][k]));
    }
  }
}

template <int CW, int PW, int KC>
int launch_small(const void* x, const float* w, const float* bias, void* out, int B, int H, int W,
                 int cin, int cout, int relu, int nhwc, cudaStream_t stream) {
  const dim3 grid((W + PW * kWarpCols - 1) / (PW * kWarpCols), H / kSmallRows, B);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (nhwc)
    conv3x3_small_kernel<CW, PW, KC, true>
        <<<grid, kSmallThreads, 0, stream>>>(xp, w, bias, op, H, W, cin, cout, relu);
  else
    conv3x3_small_kernel<CW, PW, KC, false>
        <<<grid, kSmallThreads, 0, stream>>>(xp, w, bias, op, H, W, cin, cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace wct

// x [B, cin, H, W] (nhwc = 0) or [B, H, W, cin] (nhwc = 1), bf16; out the same
// layout with cout channels. C_out <= 8 takes the narrow split, whose weights
// are w [ceil(cin / 4) * 4][9][8] and bias [8]; otherwise the wide split with
// w [ceil(cin / 8) * 8][9][64] and bias [64]; f32, zero-padded. H and W are
// multiples of 8, cin and cout in 1..64, out 16-byte aligned. Returns the CUDA
// error of the launch.
extern "C" int conv3x3_small_bf16(const void* x, const float* w, const float* bias, void* out,
                                  int B, int H, int W, int cin, int cout, int relu, int nhwc,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cout <= 8)
    return wct::launch_small<1, 8, 4>(x, w, bias, out, B, H, W, cin, cout, relu, nhwc, s);
  return wct::launch_small<8, 1, 8>(x, w, bias, out, B, H, W, cin, cout, relu, nhwc, s);
}
