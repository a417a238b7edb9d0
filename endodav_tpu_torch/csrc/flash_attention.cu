// Spatial multi-head attention of the ViT blocks, for Hopper (sm_90a).
//
// Replaces: endodav_tpu/kernels/flash_attention.py:_attn_kernel (:43),
// launched by _forward (:140, pallas_call :198) through
// qkv_flash_attention (:92).
//
// Computes, per batch b, head h and query row i,
//   o[b, i, h] = sum_{j < n} softmax_j(scale * q[b, i, h] . k[b, j, h]) v[b, j, h]
// with q, k and v read as strided views of the packed [B, N, 3C] qkv
// projection (row stride ld_in, batch stride bs_in, column offsets 0, C
// and 2C folded into the three pointers), and o written contiguous
// [B, N, C] with the heads side by side.  Inputs f32 or bf16; scores,
// softmax and accumulation in f32.  As in the TPU kernel, q is scaled and
// rounded back to the input type before the q.k product.
//
// What bounds it: at the vits shapes (Dh = 64, N = 321..1703, B*H up to
// 384) the work is 4*B*H*N^2*Dh flops against only 4*B*N*C input bytes,
// so it is compute bound.  This first version runs the two products on
// the SIMT f32 pipes from shared memory (no tensor cores yet), so its
// ceiling is the card's f32 FMA rate and the shared-memory bandwidth the
// 4x4 register tiles leave.
//
// Design: the TPU kernel held the whole K/V of a batch cell in VMEM and
// did a two-pass softmax.  A Hopper block has at most 227 KB of shared
// memory and blocks run in parallel, so here one block of 128 threads
// owns a 64-row query tile of one (b, h) and streams K/V through shared
// memory in 32-key tiles with an online softmax (running max m and sum l
// per row, rescaling the accumulator by exp(m_old - m_new)).  Each row's
// softmax statistics live in the 8 consecutive lanes that own it, so the
// row reductions are three warp shuffles.  Keys at or past n are masked
// in the kernel; nothing is padded in device memory.  q and k sit in
// shared memory transposed ([dim][row]), so each thread's 4x4 score tile
// reads one float4 of q and one of k per dimension, and its 4x8 output
// tile one float4 of p and two of v per key: 16 or 32 FMAs per two or
// three shared-memory loads.  The next K/V tile is loaded into registers
// while the current one computes, hiding the global-memory latency.  43 KB
// of static shared memory.

#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace endodav;

constexpr int DH = 64;   // head width (vits and vitl)
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int THREADS = 128;
// transposed tiles, row strides padded by 4 floats: rows stay 16-byte
// aligned for float4 reads, and the transposing stores conflict 4-way at most
constexpr int QLD = BQ + 4;
constexpr int KLD = BK + 4;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void unpack(const float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

constexpr int PER_THREAD = BK * DH / THREADS;  // K/V elements each thread stages

// K and V of keys k0..k0+BK-1 into registers, in the input type (zeros
// past n), coalesced along the head dimension; converted when stored
template <typename T>
__device__ __forceinline__ void fetch_kv(const T* __restrict__ k, const T* __restrict__ v,
                                         long long base, long long ld_in, int n, int k0,
                                         T (&kr)[PER_THREAD], T (&vr)[PER_THREAD]) {
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int key = k0 + i / DH;
    kr[e] = from_f<T>(0.f);
    vr[e] = from_f<T>(0.f);
    if (key < n) {
      const long long off = base + (long long)key * ld_in + i % DH;
      kr[e] = k[off];
      vr[e] = v[off];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int n, int heads, long long ld_in, long long bs_in,
            float scale) {
  __shared__ __align__(16) float qs[DH][QLD];  // q tile, [dim][row]
  __shared__ __align__(16) float ks[DH][KLD];  // k tile, [dim][key]
  __shared__ __align__(16) float vs[BK][DH];   // v tile, [key][dim]
  __shared__ __align__(16) float ps[BK][QLD];  // probabilities, [key][row]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long base = (long long)b * bs_in + (long long)h * DH;
  const long long ld_out = (long long)heads * DH;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const int row = q0 + r;
    float val = 0.f;
    if (row < n) val = round_to<T>(to_f(q[base + (long long)row * ld_in + d]) * scale);
    qs[d][r] = val;
  }

  // thread (rg, cg): rows rg*4..rg*4+3; score columns cg*4..cg*4+3 of a
  // key tile; output dims cg*4..cg*4+3 and 32+cg*4..32+cg*4+3.  The 8
  // threads of one row group are consecutive lanes of one warp.
  const int rg = tid >> 3;
  const int cg = tid & 7;
  float m_i[4], l_i[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -CUDART_INF_F;
    l_i[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }

  // K/V tile k0 is prefetched into registers while tile k0-BK computes
  T kr[PER_THREAD], vr[PER_THREAD];
  fetch_kv(k, v, base, ld_in, n, 0, kr, vr);

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int i = tid + e * THREADS;
      ks[i % DH][i / DH] = to_f(kr[e]);
      vs[i / DH][i % DH] = to_f(vr[e]);
    }
    __syncthreads();
    if (k0 + BK < n) fetch_kv(k, v, base, ld_in, n, k0 + BK, kr, vr);

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qd[4], kd[4];
      unpack(*reinterpret_cast<const float4*>(&qs[d][rg * 4]), qd);
      unpack(*reinterpret_cast<const float4*>(&ks[d][cg * 4]), kd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qd[i], kd[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + cg * 4 + j >= n) s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key k0 < n is valid, so mx (and m_new) is finite
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = exp2f((m_i[i] - m_new) * kLog2e);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f((s[i][j] - m_new) * kLog2e);
        rs += p;
        ps[cg * 4 + j][rg * 4 + i] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pj[4], vj[8];
      unpack(*reinterpret_cast<const float4*>(&ps[j][rg * 4]), pj);
      unpack(*reinterpret_cast<const float4*>(&vs[j][cg * 4]), vj);
      unpack(*reinterpret_cast<const float4*>(&vs[j][32 + cg * 4]), vj + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(pj[i], vj[e], acc[i][e]);
    }
  }

  T* ob = o + (long long)b * n * ld_out + (long long)h * DH + cg * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row < n) {
      const float inv = 1.f / l_i[i];
      T* orow = ob + (long long)row * ld_out;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        orow[e] = from_f<T>(acc[i][e] * inv);
        orow[32 + e] = from_f<T>(acc[i][4 + e] * inv);
      }
    }
  }
}

}  // namespace

extern "C" const char* endodav_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns the cudaError_t of the launch (0 on success).
extern "C" int endodav_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                       void* o, int batch, int n, int heads, int dh,
                                       long long ld_in, long long bs_in, float scale,
                                       void* stream) {
  if (dh != DH || n < 1 || batch < 1 || heads < 1 || heads > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BQ - 1) / BQ, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    attn_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), n, heads, ld_in, bs_in, scale);
  } else if (dtype == kBFloat16) {
    attn_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n, heads, ld_in,
        bs_in, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
