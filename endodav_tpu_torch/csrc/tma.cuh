// Tensor Memory Accelerator loads for the port's Hopper kernels (sm_90a).
//
// A 2-D tile of a row-major matrix reaches shared memory in one
// instruction (cp.async.bulk.tensor), in rows of 128 or 64 bytes swizzled as
// Swizzled<E, 128 or 64> (tc_tile.cuh) reads them; the copy's completion is counted
// in bytes on an mbarrier that the consumers wait on.  Rows past the
// matrix's end are zero-filled.  One thread issues the loads of a stage,
// so the block's warps spend no instructions on them (cp.async took one
// instruction for every 16 bytes, which the products then waited behind).
// The tensor maps are encoded on the host (make_tile_map) through the
// driver's cuTensorMapEncodeTiled, reached by cudaGetDriverEntryPoint, and
// passed to the kernels as __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace endodav {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// the barriers' initialisation, visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// order this thread's earlier shared-memory accesses (generic proxy)
// before later TMA writes to the same memory (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// tile at column c0 (elements) and row c1 of the map's matrix -> dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// A 1024-byte aligned address at or after p (the swizzled tiles' alignment).
__device__ __forceinline__ char* align1024(void* p) {
  const uint32_t s = smem_addr(p);
  return static_cast<char*>(p) + ((1024 - (s & 1023)) & 1023);
}

// Map of a row-major [rows, cols] matrix (row stride ld elements) of f32
// or bf16, read in tiles of box_rows x box_bytes (128 or 64) of columns,
// swizzled to match (Swizzled<E, box_bytes>).  Returns the CUresult (0 on
// success).
inline int make_tile_map(CUtensorMap* map, const void* base, bool f32, uint64_t rows,
                         uint64_t cols, uint64_t ld, uint32_t box_rows, uint32_t box_bytes) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(CUDA_ERROR_NOT_FOUND);
    encode = reinterpret_cast<Encode>(fn);
  }
  const uint32_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * esize};
  const cuuint32_t box[2] = {box_bytes / esize, box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return static_cast<int>(encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(base), dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace endodav
