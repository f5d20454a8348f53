// The fused encoder head: RGB -> post-pool1 encoder state, one launch.
//
// Replaces the TPU kernel wct_tpu/ops/junction_pallas.py::encoder_head
// (_head_kernel). On img [B, 3, H, W] (NCHW, f32) it computes
//
//   e1  = relu(conv3x3(img; we1, be1))        [64, H, W]   conv0 folded into conv1_1
//   out = maxpool2(relu(conv3x3(e1; we2, be2)))   [64, H/2, W/2]
//
// each conv reflect-padding its own input. The input tile is loaded through
// the reflection itself (it is the real image, so that is exact); e1's halo is
// fixed in shared memory (conv_tiles.cuh) before conv1_2 reads it.
//
// Bound on an H100: operations. 2*H*W*9*(3*64 + 64*64) FLOP per image, 20.2
// GFLOP at 512 px; batch 4 is 1.2 ms of fp32 FFMA against 12.6 MB read and
// 268 MB written (0.08 ms). The unfused chain writes and reads three
// full-resolution maps (conv0's, conv1_1's, conv1_2's) that here never leave
// the SM. The 64->64 conv is conv_tiles.cuh's shared inner loop; e1 on 18x18
// for 16x16 of output costs 1.27x the 3->64 conv's FMAs, which are 4 % of the
// whole.
//
// Shared memory: e1 [64][18][18] 82,944 B, rgb [3][20][20] 4,800 B, staged
// weights 18,432 B: 106,176 B, so two blocks fit an SM.
// Grid (W/16, H/16, B), 256 threads.

#include "conv_tiles.cuh"

namespace wct {

constexpr int kHeadSmem = (kE1Floats + kRgbFloats + kWsFloats) * 4;

__global__ void __launch_bounds__(kThreads, 2)
encoder_head_kernel(const float* __restrict__ img, const float* __restrict__ we1,
                    const float* __restrict__ be1, const float* __restrict__ we2,
                    const float* __restrict__ be2, float* __restrict__ out, int H, int W) {
  extern __shared__ float4 smem4[];
  float* bufE = reinterpret_cast<float*>(smem4);
  float* rgb = bufE + kE1Floats;
  float* ws = rgb + kRgbFloats;

  const int tid = threadIdx.x;
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const float* img_b = img + (size_t)b * 3 * H * W;
  for (int i = tid; i < kRgbFloats; i += kThreads) {
    const int c = i / (kRgbS * kRgbS);
    const int y = reflect(kT * by - 2 + (i / kRgbS) % kRgbS, H);
    const int x = reflect(kT * bx - 2 + i % kRgbS, W);
    rgb[i] = __ldg(img_b + ((size_t)c * H + y) * W + x);
  }
  copy4(ws, we1, 3 * kTapStride);
  __syncthreads();
  stage_e1(rgb, bufE, ws, be1);
  fix_halo(bufE, kCh, kE1S, kT * by - 1, kT * bx - 1, H, W);
  const int h = H / 2, w = W / 2;
  stage_e2_pool(bufE, ws, we2, be2, out + (size_t)b * kCh * h * w, h, w, by, bx);
}

}  // namespace wct

// img [B, 3, H, W] -> out [B, 64, H/2, W/2]. we1 [3][9][64], we2 [64][9][64]
// as [ci][tap][co]. Returns the CUDA error of the launch.
extern "C" int encoder_head_f32(const float* img, const float* we1, const float* be1,
                                const float* we2, const float* be2, float* out, int B,
                                int H, int W, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(wct::encoder_head_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wct::kHeadSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(W / wct::kT, H / wct::kT, B);
  wct::encoder_head_kernel<<<grid, wct::kThreads, wct::kHeadSmem, (cudaStream_t)stream>>>(
      img, we1, be1, we2, be2, out, H, W);
  return (int)cudaGetLastError();
}
