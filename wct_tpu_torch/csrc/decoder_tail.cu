// The relu1_1 decoder conv with per-image weights: 64 -> 3, one launch.
//
// Replaces the TPU kernel wct_tpu/ops/junction_pallas.py::decoder_tail
// (_tail_kernel). On f [B, 64, H, W] (NCHW, f32) with image b's own weights
// w[b] and bias b[b] (the cascade folds each image's WCT affine into the
// shared conv) it computes
//
//   out[b] = conv3x3(reflect_pad(f[b]); w[b], bias[b]), clipped to [0,1] if `clip`
//
// Bound on an H100: bytes. 2*H*W*9*64*3 FLOP per image is 0.9 GFLOP at 512 px,
// 0.05 ms at batch 4, against 268 MB of f read once and 12.6 MB written:
// 0.08 ms. So the kernel reads f once from device memory (plus a one-pixel
// halo, 1.16x) in coalesced rows, and what a library has to do for per-image
// weights (a grouped conv over a padded copy of f) is avoided: the block
// indexes w by its image and reflects while it loads.
//
// A block owns 16 rows x 64 columns of one image; a thread owns 1 x 4 pixels
// x 3 channels. The 64 input channels pass through shared memory 8 at a time
// ([8][18][68] floats); the image's weights [64][9][4] (co padded to 4) stay
// there. 48,384 B static, several blocks per SM, so one block's loads overlap
// another's FMAs. Fixed summation order (ci, dy, dx), no atomics.
// Grid (ceil(W/64), H/16, B), 256 threads.

#include "conv_tiles.cuh"

namespace wct {

constexpr int kTailW = 64;          // tile width
constexpr int kTailPitch = kTailW + 4;
constexpr int kTailRows = kT + 2;

__global__ void __launch_bounds__(kThreads)
decoder_tail_kernel(const float* __restrict__ f, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                    int clip) {
  __shared__ __align__(16) float in_s[kChunk * kTailRows * kTailPitch];
  __shared__ __align__(16) float w_s[kCh * 9 * 4];

  const int tid = threadIdx.x;
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const int row = tid >> 4, xg = tid & 15;
  const float* f_b = f + (size_t)b * kCh * H * W;
  copy4(w_s, w + (size_t)b * kCh * 9 * 4, kCh * 9 * 4);

  float acc[3][4] = {};
  for (int c0 = 0; c0 < kCh; c0 += kChunk) {
    __syncthreads();
    for (int i = tid; i < kChunk * kTailRows * (kTailW + 2); i += kThreads) {
      const int c = i / (kTailRows * (kTailW + 2));
      const int y = (i / (kTailW + 2)) % kTailRows, x = i % (kTailW + 2);
      const int gy = reflect(kT * by - 1 + y, H);
      // Columns past a narrow image's edge are masked at the store; clamp
      // their reads into the row.
      const int gx = min(max(reflect(kTailW * bx - 1 + x, W), 0), W - 1);
      in_s[(c * kTailRows + y) * kTailPitch + x] =
          __ldg(f_b + ((size_t)(c0 + c) * H + gy) * W + gx);
    }
    __syncthreads();
    for (int c = 0; c < kChunk; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* rp = in_s + (c * kTailRows + row + dy) * kTailPitch + 4 * xg;
        const float4 p = *reinterpret_cast<const float4*>(rp);
        const float2 q = *reinterpret_cast<const float2*>(rp + 4);
        const float x[6] = {p.x, p.y, p.z, p.w, q.x, q.y};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(w_s + ((c0 + c) * 9 + dy * 3 + dx) * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[0][j] = fmaf(x[j + dx], wv.x, acc[0][j]);
            acc[1][j] = fmaf(x[j + dx], wv.y, acc[1][j]);
            acc[2][j] = fmaf(x[j + dx], wv.z, acc[2][j]);
          }
        }
      }
    }
  }
  const int gx0 = kTailW * bx + 4 * xg;
  if (gx0 >= W) return;  // W is a multiple of 16, so a group of 4 is in or out whole
  float* out_b = out + (size_t)b * 3 * H * W;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float bc = __ldg(bias + b * 4 + c);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[c][j] + bc;
      if (clip) v[j] = fminf(fmaxf(v[j], 0.f), 1.f);
    }
    *reinterpret_cast<float4*>(out_b + ((size_t)c * H + kT * by + row) * W + gx0) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace wct

// f [B, 64, H, W], w [B][64][9][4] ([ci][tap][co], co padded to 4), bias [B][4]
// -> out [B, 3, H, W]. Returns the CUDA error of the launch.
extern "C" int decoder_tail_f32(const float* f, const float* w, const float* bias,
                                float* out, int B, int H, int W, int clip, void* stream) {
  const dim3 grid((W + wct::kTailW - 1) / wct::kTailW, H / wct::kT, B);
  wct::decoder_tail_kernel<<<grid, wct::kThreads, 0, (cudaStream_t)stream>>>(f, w, bias, out,
                                                                             H, W, clip);
  return (int)cudaGetLastError();
}
