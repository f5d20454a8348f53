// The relu1_1 decoder conv with per-image weights: 64 -> 3, one launch, in f32
// or bf16 operands.
//
// Replaces the TPU kernel wct_tpu/ops/junction_pallas.py::decoder_tail
// (_tail_kernel), which computes in the operand type of its input. On f [B,
// 64, H, W] (NCHW, f32 or bf16) with image b's own weights w[b] and bias b[b]
// (the cascade folds each image's WCT affine into the shared conv) it computes
//
//   out[b] = conv3x3(reflect_pad(f[b]); w[b], bias[b]), clipped to [0,1] if `clip`
//
// Under bf16 the weights, folded in f32 by the caller, are rounded to bf16 as
// they are loaded (and held as the f32 values they are), every product is
// exact in f32, the sum is f32, and the output rounds once to bf16 after the
// f32 bias and the clip, as the TPU kernel does (junction_pallas.py::_cs_conv).
//
// Bound on an H100: bytes. 2*H*W*9*64*3 FLOP per image is 0.9 GFLOP at 512
// px, 0.054 ms of fp32 FFMA at batch 4, against 268 MB of f read once and 12.6
// MB written in f32, 0.084 ms; in bf16 134 + 6.3 MB, 0.042 ms, under the FFMA
// floor. The products stay FFMA in both forms (bf16 upcast to f32 is exact):
// the tensor cores would pad N = 3 to 8 and need f in a channel-minor copy.
//
// Design. f is read once: a block owns a tile of 64 rows x 64 columns of one
// image, and its rows y0-1 .. y0+64 and columns x0-4 .. x0+67 (bf16: x0-8 ..
// x0+71, a box starting on 16 bytes) of kChunkC channels at a time arrive as
// one TMA box per channel (tma.cuh; f seen as
// a [B * 64 * H, W] tensor) into two stages on mbarriers: chunk c + 1 lands
// while chunk c is summed, and two blocks per SM overlap one's loads with
// the other's FMAs. A box's rows -1 and H (of the plane above, or below)
// are patched in shared memory with rows 1 and H - 2, the reflection; its
// columns outside the image arrive as zeros and are never read. The halo
// is 1.03 x the rows and 1.13 x (bf16 1.25 x) the columns, and neighbouring
// tiles read each other's halo from L2. The image's weights, read as the
// caller holds them (OIHW), stay in shared memory as [64][9][4] (co padded
// to 4): the wrapper launches nothing but the kernel.
//
// A thread owns 4 rows x 4 columns x 3 output channels: per input channel
// it holds the channel's 27 weights in registers and walks the 6 input rows
// its outputs read, each row one 16-byte (bf16: 8-byte) shared load of its 4
// columns, the left and right neighbours by shuffle from the next lanes (the
// tile's first and last lanes load theirs; at the image's edge the reflected
// neighbour is the thread's own column 1, or column W-2), so that each loaded
// value feeds up to 36 FMAs and FFMA makes up most of a channel's
// instructions. What bounds a launch is measured in PERF.md.
//
// Shared memory: the weights 9,216 B and two stages of one box per channel
// (each padded to 128 bytes): f32 2 channels of 66 x 72, 2 x 38,144 B; bf16 4
// of 66 x 80, 2 x 42,496 B; with the barriers and alignment 85,648 and
// 94,352 B, two blocks per SM. The summation order of every output is fixed (ci, dy, dx),
// there are no atomics, and the tiling follows H and W alone: an image gives
// the same bits alone and in any batch.
// Grid (ceil(W/64), ceil(H/64), B), 256 threads.

#include <type_traits>

#include "conv_wgmma.cuh"
#include "tma.cuh"

namespace wct {

constexpr int kTailW = 64;                 // tile columns
constexpr int kTailH = 64;                 // tile rows
constexpr int kTailRows = kTailH + 2;      // staged rows y0-1 .. y0+64
constexpr int kTailWeights = kCh * 9 * 4;  // floats in shared memory

template <typename T>
struct Tail {
  static constexpr int kChunkC = sizeof(T) == 4 ? 2 : 4;  // input channels per stage
  static constexpr int kStages = 2;                       // stages in flight or in use
  // Box columns before the tile's first: 16 bytes, where a box may start
  // (a bf16 box starting 8 bytes off faulted on the card).
  static constexpr int kLead = 16 / (int)sizeof(T);
  static constexpr int kCols = kTailW + 2 * kLead;
  static constexpr int kBox = kTailRows * kCols * (int)sizeof(T);  // one channel's box
  static constexpr int kChannel = (kBox + 127) / 128 * 128;  // its stride (TMA: 128-byte aligned)
  static constexpr int kStage = kChunkC * kChannel;
  static constexpr int kSmem = 128 + kTailWeights * 4 + kStages * kStage + kStages * 8;
};

// The 4 values of a thread's columns in one staged row, as f32.
__device__ __forceinline__ float4 tail_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 tail_load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
}

__device__ __forceinline__ float tail_load1(const float* p) { return *p; }
__device__ __forceinline__ float tail_load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void tail_store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void tail_store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// f as a [B * 64 * H, W] tensor map, boxes of kTailRows rows x kCols columns.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
decoder_tail_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ out, int H, int W, int clip) {
  using P = Tail<T>;
  constexpr int kC = P::kChunkC, kS = P::kStages, kN = kCh / kC, kCols = P::kCols;
  constexpr int kChan = P::kChannel / (int)sizeof(T);  // elements from one staged channel to the next
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4) + (-smem_addr(smem4) & 127u);
  float* w_s = reinterpret_cast<float*>(base);
  T* stages = reinterpret_cast<T*>(base + kTailWeights * 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kTailWeights * 4 + kS * P::kStage);

  const int tid = threadIdx.x;
  const int xg = tid & 15, rg = tid >> 4;  // columns 4 xg .., rows 4 rg .. of the tile
  const int x0 = kTailW * blockIdx.x, y0 = kTailH * blockIdx.y, b = blockIdx.z;
  const int gx0 = x0 + 4 * xg;
  const bool left_edge = gx0 == 0, right_edge = gx0 + 4 == W;
  // Thread 0: channels kC q .. of the tile's rows y0-1 .. and columns x0-kLead ..
  // into stage q % kS, one box per channel (rows and columns outside the
  // tensor arrive as zeros; rows of the next plane past the image's end are
  // not read).
  const auto issue = [&](int q) {
    const uint32_t bar = smem_addr(full + q % kS);
    mbar_expect_tx(bar, kC * P::kBox);
    for (int c = 0; c < kC; ++c)
      tma_load_2d(smem_addr(stages + (q % kS) * (P::kStage / (int)sizeof(T)) + c * kChan), &map,
                  x0 - P::kLead, (b * kCh + kC * q + c) * H + y0 - 1, bar);
  };
  if (tid == 0)
    for (int s = 0; s < kS; ++s) mbar_init(smem_addr(full + s), 1);
  {  // the image's OIHW weights [3][64][9] -> [64][9][4], as the operand type holds them
    const float* w_b = w + (size_t)b * 3 * kCh * 9;
    for (int i = tid; i < 3 * kCh * 9; i += kThreads) {
      const float v = __ldg(w_b + i);
      w_s[(i % (kCh * 9)) * 4 + i / (kCh * 9)] =
          std::is_same<T, float>::value ? v : __bfloat162float(__float2bfloat16_rn(v));
    }
    for (int i = tid; i < kCh * 9; i += kThreads) w_s[i * 4 + 3] = 0.f;
  }
  __syncthreads();  // the barriers are set up
  if (tid == 0)
    for (int q = 0; q < kS - 1; ++q) issue(q);

  // The reflected rows of an edge tile: staged row 0 (image row -1) takes
  // row 2 (image row 1), staged row H - y0 + 1 (image row H) row H - y0 - 1.
  const bool top = y0 == 0, bottom = H - y0 <= kTailH;
  float acc[4][4][3] = {};  // [row][column][co]
  for (int ch = 0; ch < kN; ++ch) {
    T* cur = stages + ch % kS * (P::kStage / (int)sizeof(T));
    mbar_wait(smem_addr(full + ch % kS), (ch / kS) & 1);
    if (top || bottom)
      for (int i = tid; i < kC * kCols; i += kThreads) {
        T* cp = cur + i / kCols * kChan + i % kCols;
        if (top) cp[0] = cp[2 * kCols];
        if (bottom) cp[(H - y0 + 1) * kCols] = cp[(H - y0 - 1) * kCols];
      }
    // Chunk ch is in place for every thread, and every thread is done with
    // chunk ch - 1, whose stage takes chunk ch + kS - 1 (its generic reads
    // and the patches fenced before the copy's writes).
    __syncthreads();
    if (tid == 0 && ch + kS - 1 < kN) {
      fence_proxy_async();
      issue(ch + kS - 1);
    }
#pragma unroll 1
    for (int c = 0; c < kC; ++c) {
      float4 wv[9];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        wv[k] = *reinterpret_cast<const float4*>(w_s + ((kC * ch + c) * 9 + k) * 4);
      const T* rp0 = cur + c * kChan + 4 * rg * kCols + P::kLead + 4 * xg;
#pragma unroll
      for (int r = 0; r < 6; ++r) {  // staged row 4 rg + r: image row y0 + 4 rg + r - 1
        const T* rp = rp0 + r * kCols;
        const float4 q = tail_load4(rp);
        float lft = __shfl_up_sync(0xffffffffu, q.w, 1, 16);
        float rgt = __shfl_down_sync(0xffffffffu, q.x, 1, 16);
        if (xg == 0) lft = tail_load1(rp - 1);
        if (xg == 15) rgt = tail_load1(rp + 4);
        if (left_edge) lft = q.y;   // column -1 reflects to 1
        if (right_edge) rgt = q.z;  // column W reflects to W - 2
        const float x[6] = {lft, q.x, q.y, q.z, q.w, rgt};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int o = r - dy;  // the output row this input row feeds through tap row dy
          if (o < 0 || o > 3) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 wt = wv[dy * 3 + dx];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[o][j][0] = fmaf(x[j + dx], wt.x, acc[o][j][0]);
              acc[o][j][1] = fmaf(x[j + dx], wt.y, acc[o][j][1]);
              acc[o][j][2] = fmaf(x[j + dx], wt.z, acc[o][j][2]);
            }
          }
        }
      }
    }
  }
  if (gx0 >= W) return;  // W is a multiple of 16, so a group of 4 is in or out whole
  T* out_b = out + (size_t)b * 3 * H * W;
#pragma unroll
  for (int co = 0; co < 3; ++co) {
    const float bc = __ldg(bias + b * 3 + co);
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int y = y0 + 4 * rg + o;
      if (y >= H) break;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[o][j][co] + bc;
        if (clip) v[j] = fminf(fmaxf(v[j], 0.f), 1.f);
      }
      tail_store4(out_b + ((size_t)co * H + y) * W + gx0, v);
    }
  }
}

template <typename T>
int launch_tail(const void* f, const float* w, const float* bias, void* out, int B, int H, int W,
                int clip, void* stream) {
  CUtensorMap map = {};
  cudaError_t err = encode_2d(
      &map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      sizeof(T), f, (uint64_t)B * kCh * H, W, Tail<T>::kCols, kTailRows,
      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  auto kernel = decoder_tail_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tail<T>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTailW - 1) / kTailW, (H + kTailH - 1) / kTailH, B);
  kernel<<<grid, kThreads, Tail<T>::kSmem, (cudaStream_t)stream>>>(map, w, bias,
                                                                   static_cast<T*>(out), H, W, clip);
  return (int)cudaGetLastError();
}

}  // namespace wct

// f [B, 64, H, W] (16-byte aligned), w [B, 3, 64, 3, 3] f32 (OIHW per image),
// bias [B, 3] f32 -> out [B, 3, H, W], in the operand type of the entry point.
// H and W multiples of 16. Returns the CUDA error of the launch.
extern "C" int decoder_tail_f32(const void* f, const float* w, const float* bias, void* out,
                                int B, int H, int W, int clip, void* stream) {
  return wct::launch_tail<float>(f, w, bias, out, B, H, W, clip, stream);
}

extern "C" int decoder_tail_bf16(const void* f, const float* w, const float* bias, void* out,
                                 int B, int H, int W, int clip, void* stream) {
  return wct::launch_tail<__nv_bfloat16>(f, w, bias, out, B, H, W, clip, stream);
}
