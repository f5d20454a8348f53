// Tensor-memory-accelerator copies of 2-D to 4-D boxes (centered_gram.cu,
// decoder_tail.cu, conv3x3_small.cu): the host encodes a tensor map with
// cuTensorMapEncodeTiled, reached through the runtime's entry-point query so
// that a library is built without -lcuda; one thread copies a box into
// shared memory, completing on an mbarrier (conv_wgmma.cuh's mbar_*), or
// from shared memory back to the tensor, in a bulk group it commits and
// waits for. Box coordinates may lie partly outside the tensor: on a load
// those elements arrive as zeros and count toward the barrier's bytes, on a
// store they are dropped.

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// The box at src (shared memory, laid out as tma_load_3d would land it) into
// the tensor at (c0, c1, c2), in this thread's current bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c0, int c1, int c2,
                                             uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until this thread's committed stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// map over a tensor of `rank` (at most 5) dimensions at base (16-byte
// aligned): dims[0] the innermost and contiguous, strides[i] the bytes from
// one index of dimension i + 1 to the next (multiples of 16, in any order),
// boxes of box[0] x box[1] x ... (box[0] x esize a multiple of 16; with a
// swizzle, at most its span).
inline cudaError_t encode_tiled(CUtensorMap* map, CUtensorMapDataType dtype, int rank,
                                const void* base, const uint64_t* dims, const uint64_t* strides,
                                const uint32_t* box, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &status);
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    unit[i] = 1;
    if (i + 1 < rank) st[i] = strides[i];
  }
  const CUresult r = encode(map, dtype, rank, const_cast<void*>(base), d, st, bx, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// map over a row-major [rows, cols] tensor at base (16-byte aligned, cols x
// esize a multiple of 16) in boxes of box_rows x box_cols.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, int esize,
                             const void* base, uint64_t rows, uint64_t cols, uint32_t box_cols,
                             uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {cols * static_cast<uint64_t>(esize)};
  const uint32_t box[2] = {box_cols, box_rows};
  return encode_tiled(map, dtype, 2, base, dims, strides, box, swizzle);
}

}  // namespace wct
