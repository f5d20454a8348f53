// Tensor-memory-accelerator copies of 2-D boxes (centered_gram.cu,
// decoder_tail.cu): the host encodes a tensor map with
// cuTensorMapEncodeTiled, reached through the runtime's entry-point query so
// that a library is built without -lcuda; one thread copies a box into
// shared memory, completing on an mbarrier (conv_wgmma.cuh's mbar_*). Box
// coordinates may lie partly outside the tensor: those elements arrive as
// zeros and count toward the barrier's bytes.

#pragma once
#include <cuda.h>
#include <cuda_runtime.h>

#include <cudaTypedefs.h>

#include <cstdint>

namespace wct {

// The box of `map` at column c0, row c1 into shared memory at dst (128-byte
// aligned; 1 KB with a swizzle), completing on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// map over a row-major [rows, cols] tensor at base (16-byte aligned, cols x
// esize a multiple of 16) in boxes of box_rows x box_cols.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, int esize,
                             const void* base, uint64_t rows, uint64_t cols, uint32_t box_cols,
                             uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &status);
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * static_cast<cuuint64_t>(esize)};
  const cuuint32_t box[2] = {box_cols, box_rows}, unit[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wct
