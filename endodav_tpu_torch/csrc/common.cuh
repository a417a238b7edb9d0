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

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Register tile of the SIMT products: RM token rows x RN output columns a thread.
constexpr int RM = 8;
constexpr int RN = 4;

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(v[0]);
  const float2 b = __bfloat1622float2(v[1]);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// acc[i][n] = sum_k a[i*lda + k] * w[k*ldw + n] for an RM x RN tile:
// a (shared memory, rows 16-byte aligned) is read as float4 along k, and
// each row of 4 weights (global memory, JAX layout [C_in, C_out]) feeds
// RM*RN FMAs.  The next 4 weight rows are loaded while the current ones
// are used, so a load from L2 overlaps 128 FMAs (a block of these kernels
// often has an SM to itself: few warps to hide the latency otherwise).
// kdim is a multiple of 4.
template <typename T>
__device__ __forceinline__ void tile_product(const float* a, int lda, const T* w, int ldw,
                                             int kdim, float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int n = 0; n < RN; ++n) acc[i][n] = 0.f;
  float wnext[4][RN];
#pragma unroll
  for (int u = 0; u < 4; ++u) load4(w + (long long)u * ldw, wnext[u]);
  for (int k = 0; k < kdim; k += 4) {
    float wv[4][RN];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int n = 0; n < RN; ++n) wv[u][n] = wnext[u][n];
    if (k + 4 < kdim) {
#pragma unroll
      for (int u = 0; u < 4; ++u) load4(w + (long long)(k + 4 + u) * ldw, wnext[u]);
    }
    float av[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i) load4(a + i * lda + k, av[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int n = 0; n < RN; ++n) acc[i][n] = fmaf(av[i][u], wv[u][n], acc[i][n]);
  }
}

}  // namespace endodav
