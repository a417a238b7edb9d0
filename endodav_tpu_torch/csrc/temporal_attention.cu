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
// ridge point (20 in f32 SIMT), so device memory bounds it; the kernel
// has to read each input once and keep enough blocks in flight.
//
// Design: T is small (16 in training, 32 at serving, at most 64), the
// batch of rows enormous.  The TPU kernel tiled 8 rows with all heads into
// VMEM and padded R to a multiple of 8.  Here one block owns one row and a
// group of HG heads (HG divides H; the wrapper picks the most heads whose
// q, k, v [T, HG*Dh] and scores [HG, T, T] stay within 48 KB of shared
// memory, so several blocks share an SM).  Phase 1: one thread per (head,
// query) computes its T scores, the row maximum, the exponentials and the
// normalised, rounded p into shared memory.  Phase 2: one thread per
// (query, head, d) output element, consecutive threads on consecutive d,
// so the PV sums read v without bank conflicts and the stores to device
// memory coalesce.  Padded shared-memory rows (HG*Dh + 1 and T + 1 floats)
// keep phase 1's per-thread rows on distinct banks.  No row is padded in
// device memory: any R works.

#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace endodav;

constexpr int MAX_T = 64;

template <typename T>
__global__ void __launch_bounds__(256)
temporal_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int t, int heads, int dh,
                     int hg, float scale) {
  extern __shared__ float4 smem4[];
  const int width = hg * dh;
  const int ld = width + 1;
  float* qs = reinterpret_cast<float*>(smem4);  // [t][ld]
  float* ks = qs + t * ld;
  float* vs = ks + t * ld;
  float* ps = vs + t * ld;                        // [hg][t][t + 1]
  const int groups = heads / hg;
  const long long row = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * hg;
  const long long tok = (long long)heads * dh;  // elements of one (row, frame)
  const long long base = row * t * tok + (long long)h0 * dh;

  for (int i = threadIdx.x; i < t * width; i += blockDim.x) {
    const int f = i / width, e = i % width;
    const long long g = base + f * tok + e;
    qs[f * ld + e] = to_f(q[g]);
    ks[f * ld + e] = to_f(k[g]);
    vs[f * ld + e] = to_f(v[g]);
  }
  __syncthreads();

  for (int pair = threadIdx.x; pair < hg * t; pair += blockDim.x) {
    const int hl = pair / t, i = pair % t;
    const float* qi = qs + i * ld + hl * dh;
    float* pi = ps + pair * (t + 1);
    float m = -CUDART_INF_F;
    for (int j = 0; j < t; ++j) {
      const float* kj = ks + j * ld + hl * dh;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qi[d], kj[d], s);
      s *= scale;
      pi[j] = s;
      m = fmaxf(m, s);
    }
    float l = 0.f;
    for (int j = 0; j < t; ++j) {
      const float e = expf(pi[j] - m);
      pi[j] = e;
      l += e;
    }
    for (int j = 0; j < t; ++j) pi[j] = round_to<T>(pi[j] / l);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < t * width; i += blockDim.x) {
    const int f = i / width, e = i % width, hl = e / dh;
    const float* pf = ps + (hl * t + f) * (t + 1);
    float acc = 0.f;
    for (int j = 0; j < t; ++j) acc = fmaf(pf[j], vs[j * ld + e], acc);
    out[base + f * tok + e] = from_f<T>(acc);
  }
}

size_t smem_bytes(int t, int dh, int hg) {
  return ((size_t)3 * t * (hg * dh + 1) + (size_t)hg * t * (t + 1)) * sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int rows, int t, int heads,
           int dh, int hg, int threads, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(t, dh, hg);
  cudaError_t err = cudaFuncSetAttribute(temporal_attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)rows * (heads / hg);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  temporal_attn_kernel<T><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), t, heads, dh, hg, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  q, k, v and out
// contiguous [rows, t, heads, dh]; hg heads a block (dividing heads) and
// `threads` a block (a multiple of 32, at most 256) are the wrapper's
// choice, whose shared-memory size it mirrors.
extern "C" int endodav_temporal_attention(int dtype, const void* q, const void* k, const void* v,
                                          void* out, int rows, int t, int heads, int dh, int hg,
                                          int threads, float scale, void* stream) {
  if (rows < 1 || t < 1 || t > MAX_T || heads < 1 || dh < 1 || hg < 1 || heads % hg != 0 ||
      threads < 32 || threads > 256 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, out, rows, t, heads, dh, hg, threads, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, rows, t, heads, dh, hg, threads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
