// Attention along the time axis of the motion modules, for Hopper (sm_90a).
//
// Replaces: endodav_tpu/kernels/temporal_attention.py:_kernel (:31),
// launched by _forward (:55, pallas_call :66) through temporal_attention
// (:81): the attention of the motion modules' unfused sub-block, which the
// training step and every RoPE motion module run.
//
// Computes, for q, k, v [R, T, H, Dh] (R = B*H*W rows of the feature map,
// T frames, H heads) in f32 or bf16:
//   s = (q . k) * scale                  f32 sums
//   p = softmax_j(s)                     f32, rounded to v's type
//   o = sum_j p v_j                      f32 sums, stored in q's type
// as the TPU kernel does (the scale after the product; p cast to v's
// dtype before PV, :47-52).
//
// What bounds it: 4*T*Dh flops a query row against 4 Dh elements of q, k,
// v and o: at T=16..32 about 8-16 flops a byte in f32, under the card's
// ridge point (20 in f32 SIMT), so device memory bounds it, with the FMAs
// close behind: the kernel has to read each input once, keep enough bytes
// in flight, and spend few instructions beside its FMAs.
//
// Design: T is small (16 in training, 32 at serving, at most 64), the
// batch of (row, head) pairs enormous (54464 at a 518x644 window's 74x92
// module).  One warp owns one (row, head): it stages that head's q, k, v
// [T, Dh] in its own region of shared memory, converted to f32 (16-byte
// loads along the contiguous Dh of each frame, several in flight a lane),
// then computes both products from register tiles with no block-wide
// barrier (warp_attention.cuh: a lane holds 4 queries x 8 keys of the
// scores at T=32, the softmax of a query over 4 lanes, and 4 queries x 2
// or 4 columns of the output, so every lane is busy in both phases).
// Several warps a block (the wrapper picks up to 4, by their shared
// memory) and several blocks an SM keep the loads of some warps in flight
// while others compute.  No row is padded in device memory: any R works.

#include <cstdint>

#include "common.cuh"
#include "warp_attention.cuh"

namespace {

using namespace endodav;

constexpr int MAX_T = 64;
constexpr int MAX_WARPS = 4;

// f32 elements of one warp's region: q, k, v [TM][ld] and p [QB][pld]
__host__ __device__ inline int warp_floats(int tm, int dh) {
  const int ld = odd_words(round_up(dh, 4)), qb = tm >= 32 ? 32 : 16;
  return 3 * tm * ld + qb * odd_words(tm);
}

// 16 bytes of T at p, as f32, into d
__device__ __forceinline__ void load16(const float* p, float* d) {
  *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* d) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

// DV consecutive outputs of f32 accumulators, stored as T
template <int DV>
__device__ __forceinline__ void store_out(float* p, const float* o) {
  if constexpr (DV == 4) *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  else *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
}
template <int DV>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* o) {
#pragma unroll
  for (int e = 0; e < DV; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(p + e) = __floats2bfloat162_rn(o[e], o[e + 1]);
}

// units = rows * heads (row, head) pairs, one a warp; TM keys at most, DV
// output columns a lane a step.  vec: dh * sizeof(T) is a multiple of 16
// and the tensors are 16-byte aligned.
template <typename T, int TM, int DV>
__global__ void __launch_bounds__(MAX_WARPS * 32)
temporal_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, long long units, int t,
                     int heads, int dh, int vec, float scale) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long unit = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (unit >= units) return;
  const int dp = round_up(dh, 4), ld = odd_words(dp);
  float* qs = reinterpret_cast<float*>(smem4) + (size_t)warp * warp_floats(TM, dh);
  float* ks = qs + TM * ld;
  float* vs = ks + TM * ld;
  float* ps = vs + TM * ld;  // [QB][odd_words(TM)]
  const long long row = unit / heads;
  const int h = static_cast<int>(unit - row * heads);
  const long long fstride = (long long)heads * dh;  // elements of one (row, frame)
  const long long base = row * t * fstride + (long long)h * dh;

  // columns dh..dp-1 of q and k are summed over: zero
  for (int i = lane; i < t * (dp - dh); i += 32) {
    const int f = i / (dp - dh), e = dh + i % (dp - dh);
    qs[f * ld + e] = 0.f;
    ks[f * ld + e] = 0.f;
  }
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per = dh / V, n = t * per;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
      const int f = i / per, e = (i - f * per) * V;
      const long long g = base + f * fstride + e;
      load16(q + g, qs + f * ld + e);
      load16(k + g, ks + f * ld + e);
      load16(v + g, vs + f * ld + e);
    }
  } else {
    for (int i = lane; i < t * dh; i += 32) {
      const int f = i / dh, e = i % dh;
      const long long g = base + f * fstride + e;
      qs[f * ld + e] = to_f(q[g]);
      ks[f * ld + e] = to_f(k[g]);
      vs[f * ld + e] = to_f(v[g]);
    }
  }
  __syncwarp();
  warp_attention<T, TM, DV>(qs, ks, vs, ld, ps, odd_words(TM), t, dp, scale,
                            [&](int f, int d0, const auto& o) {
                              T* dst = out + base + f * fstride + d0;
                              if (vec && d0 + DV <= dh) {
                                store_out<DV>(dst, o);
                              } else {
#pragma unroll
                                for (int e = 0; e < DV; ++e)
                                  if (d0 + e < dh) dst[e] = from_f<T>(o[e]);
                              }
                            });
}

template <typename T, int TM, int DV>
int launch_tm(const void* q, const void* k, const void* v, void* out, long long units, int t,
              int heads, int dh, int wpb, int vec, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)wpb * warp_floats(TM, dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(temporal_attn_kernel<T, TM, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (units + wpb - 1) / wpb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  temporal_attn_kernel<T, TM, DV><<<static_cast<unsigned>(blocks), wpb * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), units, t, heads, dh, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DV>
int launch_dv(const void* q, const void* k, const void* v, void* out, long long units, int t,
              int heads, int dh, int wpb, int vec, float scale, cudaStream_t stream) {
  if (t <= 16)
    return launch_tm<T, 16, DV>(q, k, v, out, units, t, heads, dh, wpb, vec, scale, stream);
  if (t <= 32)
    return launch_tm<T, 32, DV>(q, k, v, out, units, t, heads, dh, wpb, vec, scale, stream);
  return launch_tm<T, 64, DV>(q, k, v, out, units, t, heads, dh, wpb, vec, scale, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, long long units, int t,
           int heads, int dh, int wpb, float scale, cudaStream_t stream) {
  // 16-byte loads when every frame's Dh run and the bases allow them
  const int vec = (dh * sizeof(T)) % 16 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if ((round_up(dh, 4) / 4) % 4 == 0)
    return launch_dv<T, 4>(q, k, v, out, units, t, heads, dh, wpb, vec, scale, stream);
  return launch_dv<T, 2>(q, k, v, out, units, t, heads, dh, wpb, vec, scale, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  q, k, v and out
// contiguous [rows, t, heads, dh]; wpb warps a block (1 to 4) is the
// wrapper's choice, whose shared memory it mirrors
// (kernels/temporal_attention.py:warps_per_block).
extern "C" int endodav_temporal_attention(int dtype, const void* q, const void* k, const void* v,
                                          void* out, int rows, int t, int heads, int dh, int wpb,
                                          float scale, void* stream) {
  if (rows < 1 || t < 1 || t > MAX_T || heads < 1 || dh < 1 || wpb < 1 || wpb > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = (long long)rows * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(q, k, v, out, units, t, heads, dh, wpb, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, units, t, heads, dh, wpb, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
