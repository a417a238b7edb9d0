// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace endodav {

// dtype codes passed from Python (kernels/_build.py:DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round an f32 value through T, as `.astype(x.dtype)` does in the JAX kernels
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace endodav
