// The relu1_1 decoder conv with per-image weights: 64 -> 3, one launch, f32.
//
// Replaces the f32 form of the TPU kernel
// wct_tpu/ops/junction_pallas.py::decoder_tail (_tail_kernel); its bf16 form is
// conv3x3_small.cu's per-image entry (decoder_tail_bf16), which computes this
// conv under the bf16 kernels' rounding rule on the tensor cores. On f [B, 64,
// H, W] (NCHW, f32) with image b's own weights w[b] and bias b[b] (the
// cascade folds each image's WCT affine into the shared conv) it computes
//
//   out[b] = conv3x3(reflect_pad(f[b]); w[b], bias[b]), clipped to [0,1] if `clip`
//
// Bound on an H100: bytes. 2*H*W*9*64*3 FLOP per image is 0.9 GFLOP at 512 px,
// 0.054 ms of fp32 FFMA at batch 4, against 268 MB of f read once and 12.6 MB
// written: 0.084 ms. So f is read once, as 16-byte asynchronous copies that
// stay in flight behind the FMAs: a block owns 16 rows x 64 columns of one
// image and stages 8 input channels at a time, rows 16*by-1 .. 16*by+16
// (reflected at load) and columns 64*bx-4 .. 64*bx+67 (16-byte aligned; the
// reflected halo column at the image's left or right edge is patched in
// shared memory), in two buffers: chunk c + 1 lands while chunk c is summed.
// The image's weights [64][9][4] (co padded to 4) stay in shared memory. A
// thread owns 1 x 4 pixels x 3 channels. 92,160 B of shared memory, two
// blocks per SM, so one block's loads also overlap the other's FMAs. What a
// library has to do for per-image weights (a grouped conv over a padded copy
// of f) is avoided. Fixed summation order (ci, dy, dx), no atomics.
// Grid (ceil(W/64), H/16, B), 256 threads.

#include "conv_tiles.cuh"
#include "ptx.cuh"

namespace wct {

constexpr int kTailW = 64;                  // tile width
constexpr int kTailCols = kTailW + 8;       // staged columns x0-4 .. x0+67
constexpr int kTailRows = kT + 2;
constexpr int kTailChunk = 8;               // input channels per stage
constexpr int kTailStage = kTailChunk * kTailRows * kTailCols;  // floats
constexpr int kTailWeights = kCh * 9 * 4;
constexpr int kTailSmem = (kTailWeights + 2 * kTailStage) * 4;

// Channels c0 .. c0+7 of the block's rows and columns into `stage`; chunks of
// 4 columns outside the image are not loaded (only the patched halo columns
// and masked outputs would read them). Commits one group.
__device__ __forceinline__ void stage_rows(const float* __restrict__ f_b, float* stage, int c0,
                                           int y0, int x0, int H, int W) {
  const uint32_t base = smem_addr(stage);
  constexpr int kCopies = kTailCols / 4;
  for (int i = threadIdx.x; i < kTailChunk * kTailRows * kCopies; i += kThreads) {
    const int k = i % kCopies, y = (i / kCopies) % kTailRows, c = i / (kCopies * kTailRows);
    const int gx = x0 - 4 + 4 * k;
    if (gx < 0 || gx >= W) continue;
    const int gy = reflect(y0 - 1 + y, H);
    cp_async16(base + ((c * kTailRows + y) * kTailCols + 4 * k) * 4,
               f_b + ((size_t)(c0 + c) * H + gy) * W + gx);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 2)
decoder_tail_kernel(const float* __restrict__ f, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                    int clip) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* stages[2] = {w_s + kTailWeights, w_s + kTailWeights + kTailStage};

  const int tid = threadIdx.x;
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const int row = tid >> 4, xg = tid & 15;
  const int x0 = kTailW * bx, y0 = kT * by;
  const float* f_b = f + (size_t)b * kCh * H * W;
  {
    const uint32_t wb = smem_addr(w_s);
    const float* w_b = w + (size_t)b * kTailWeights;
    for (int i = tid; i < kTailWeights / 4; i += kThreads) cp_async16(wb + i * 16, w_b + 4 * i);
  }
  stage_rows(f_b, stages[0], 0, y0, x0, H, W);  // with the weights

  const bool left = x0 == 0, right = x0 + kTailW >= W;
  float acc[3][4] = {};
  for (int ch = 0; ch < kCh / kTailChunk; ++ch) {
    float* cur = stages[ch & 1];
    if (ch + 1 < kCh / kTailChunk) {
      stage_rows(f_b, stages[(ch + 1) & 1], kTailChunk * (ch + 1), y0, x0, H, W);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (left || right) {  // the reflected halo columns: -1 takes 1, W takes W-2
      for (int i = tid; i < kTailChunk * kTailRows; i += kThreads) {
        float* rp = cur + i * kTailCols;
        if (left) rp[3] = rp[5];
        if (right) rp[W - x0 + 4] = rp[W - x0 + 2];
      }
      __syncthreads();
    }
    for (int c = 0; c < kTailChunk; ++c) {
      const float* wc = w_s + (kTailChunk * ch + c) * 9 * 4;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        // columns 4 xg - 1 .. 4 xg + 4 of the tile: staged 4 xg + 3 .. 4 xg + 8
        const float* rp = cur + (c * kTailRows + row + dy) * kTailCols + 4 * xg + 3;
        const float4 q = *reinterpret_cast<const float4*>(rp + 1);
        const float x[6] = {rp[0], q.x, q.y, q.z, q.w, rp[5]};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(wc + (dy * 3 + dx) * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[0][j] = fmaf(x[j + dx], wv.x, acc[0][j]);
            acc[1][j] = fmaf(x[j + dx], wv.y, acc[1][j]);
            acc[2][j] = fmaf(x[j + dx], wv.z, acc[2][j]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with `cur` before it is refilled
  }
  const int gx0 = x0 + 4 * xg;
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
    *reinterpret_cast<float4*>(out_b + ((size_t)c * H + y0 + row) * W + gx0) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace wct

// f [B, 64, H, W], w [B][64][9][4] ([ci][tap][co], co padded to 4), bias [B][4]
// -> out [B, 3, H, W]. Returns the CUDA error of the launch.
extern "C" int decoder_tail_f32(const float* f, const float* w, const float* bias,
                                float* out, int B, int H, int W, int clip, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(wct::decoder_tail_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wct::kTailSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + wct::kTailW - 1) / wct::kTailW, H / wct::kT, B);
  wct::decoder_tail_kernel<<<grid, wct::kThreads, wct::kTailSmem, (cudaStream_t)stream>>>(
      f, w, bias, out, H, W, clip);
  return (int)cudaGetLastError();
}
