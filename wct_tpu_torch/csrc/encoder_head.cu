// The fused encoder head: RGB -> post-pool1 encoder state, one launch, in f32
// or bf16 operands.
//
// Replaces the TPU kernel wct_tpu/ops/junction_pallas.py::encoder_head
// (_head_kernel), which computes in the operand type of its input. On
// img [B, 3, H, W] (NCHW, f32 or bf16) it computes
//
//   e1  = relu(conv3x3(img; we1, be1))        [64, H, W]   conv0 folded into conv1_1
//   out = maxpool2(relu(conv3x3(e1; we2, be2)))   [64, H/2, W/2]
//
// each conv reflect-padding its own input. These are the encoder stages of
// junction.cu, shared through conv_tc.cuh: the input tile is loaded through
// the reflection itself (it is the real image, so that is exact), e1 (3->64)
// runs FFMA, its halo is fixed in shared memory (conv_tiles.cuh), and conv1_2
// runs on the tensor cores (f32: 3xTF32 mma.sync.m16n8k8; bf16: one pass of
// mma.sync.m16n8k16) with the pool in registers. Under bf16 both convs round
// once to bf16, after the f32 bias and the ReLU, and e1 is bf16.
//
// Bound on an H100: operations. 2*H*W*9*(3*64 + 64*64) FLOP per image, 20.2
// GFLOP at 512 px, 80.9 GFLOP at batch 4: f32 three TF32 passes, 0.491 ms;
// bf16 one pass, 0.082 ms; against 12.6 (6.3) MB read and 268 (134) MB
// written, 0.084 (0.042) ms. The unfused chain writes and reads three
// full-resolution maps (conv0's, conv1_1's, conv1_2's) that here never leave
// the SM. e1 on 18x18 for 16x16 of output costs 1.27x the 3->64 conv's FMAs,
// which are 4 % of the whole.
//
// Shared memory: e1 (f32 planar 82,944 B; bf16 channel-minor 46,656 B), the
// rgb tile 4,800 B, and the ring of three slots of a chunk each (49,152 B;
// 24,576 B), which first carries we1 (6,912 B): 136,896 B for f32, one block
// per SM; 76,032 B for bf16, two blocks per SM (its 64 accumulators and
// fragments fit the 128 registers a thread that two blocks allow).
// Grid (W/16, H/16, B), 256 threads.

#include "conv_tc.cuh"

namespace wct {

template <typename T>
__host__ __device__ constexpr int head_smem() {
  return map_bytes<T>(kE1S * kE1S) + kRgbFloats * 4 + kSlots * Tc<T>::kChunkBytes;
}

static_assert(3 * kTapStride * 4 <= Tc<bf16>::kChunkBytes, "we1 fits a slot");

template <typename T, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
encoder_head_kernel(const T* __restrict__ img, const float* __restrict__ we1,
                    const float* __restrict__ be1, const unsigned char* __restrict__ we2f,
                    const float* __restrict__ be2, T* __restrict__ out, int H, int W) {
  constexpr int kSlot = Tc<T>::kChunkBytes;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  T* bufE = reinterpret_cast<T*>(base);
  float* rgb = reinterpret_cast<float*>(base + map_bytes<T>(kE1S * kE1S));
  unsigned char* ring = reinterpret_cast<unsigned char*>(rgb + kRgbFloats);
  const WeightStream ws{nullptr, 0, we1, 3 * kTapStride, nullptr, 0, we2f, Tc<T>::kChunks};

  const int tid = threadIdx.x;
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  fetch_slot<kSlot, kSlot>(0, ring, ws);
  fetch_slot<kSlot, kSlot>(1, ring, ws);
  const T* img_b = img + (size_t)b * 3 * H * W;
  for (int i = tid; i < kRgbFloats; i += kThreads) {
    const int c = i / (kRgbS * kRgbS);
    const int y = reflect(kT * by - 2 + (i / kRgbS) % kRgbS, H);
    const int x = reflect(kT * bx - 2 + i % kRgbS, W);
    rgb[i] = load_value(img_b + ((size_t)c * H + y) * W + x);
  }
  // we1; the barrier also orders the rgb tile
  const float* ws1 = reinterpret_cast<const float*>(take_slot<kSlot, kSlot>(0, ring, ws));
  stage_e1<T>(rgb, bufE, ws1, be1);
  fix_halo(bufE, kE1S, kT * by - 1, kT * bx - 1, H, W);
  const int h = H / 2, w = W / 2;
  stage_e2_pool<T, kSlot>(bufE, ring, ws, 1, be2, out + (size_t)b * kCh * h * w, h, w, by, bx);
  cp_async_wait<0>();
}

template <typename T, int kMinBlocks>
int launch_head(const void* img, const float* we1, const float* be1, const void* we2f,
                const float* be2, void* out, int B, int H, int W, void* stream) {
  auto kernel = encoder_head_kernel<T, kMinBlocks>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         head_smem<T>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(W / kT, H / kT, B);
  kernel<<<grid, kThreads, head_smem<T>(), (cudaStream_t)stream>>>(
      static_cast<const T*>(img), we1, be1, static_cast<const unsigned char*>(we2f), be2,
      static_cast<T*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace wct

// img [B, 3, H, W] -> out [B, 64, H/2, W/2], in the operand type of the entry
// point. we1 [3][9][64] ([ci][tap][co], f32; bf16 values for the bf16 entry);
// we2f conv1_2's B fragments as junction.cu's. Returns the CUDA error of the
// launch.
extern "C" int encoder_head_f32(const float* img, const float* we1, const float* be1,
                                const float* we2f, const float* be2, float* out, int B,
                                int H, int W, void* stream) {
  return wct::launch_head<float, 1>(img, we1, be1, we2f, be2, out, B, H, W, stream);
}

extern "C" int encoder_head_bf16(const void* img, const float* we1, const float* be1,
                                 const void* we2f, const float* be2, void* out, int B, int H,
                                 int W, void* stream) {
  return wct::launch_head<wct::bf16, 2>(img, we1, be1, we2f, be2, out, B, H, W, stream);
}

// The form's shared memory per block and the blocks an SM holds at once on
// the current device (bf16 != 0: the bf16 form). Returns the CUDA error.
extern "C" int encoder_head_plan(int bf16, int* smem_bytes, int* blocks_per_sm) {
  return bf16 ? wct::kernel_plan(wct::encoder_head_kernel<wct::bf16, 2>, wct::head_smem<wct::bf16>(),
                                 smem_bytes, blocks_per_sm)
              : wct::kernel_plan(wct::encoder_head_kernel<float, 1>, wct::head_smem<float>(),
                                 smem_bytes, blocks_per_sm);
}
