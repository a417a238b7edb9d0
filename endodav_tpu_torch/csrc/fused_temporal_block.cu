// Fused attention sub-block of the temporal (motion) modules, for Hopper
// (sm_90a).
//
// Replaces: endodav_tpu/kernels/fused_temporal_block.py:_kernel (:76),
// launched by _forward (:182, pallas_call :192) through
// fused_temporal_block (:247) from models/motion.py:121-138.
//
// Computes, for every row r of x [R, T, C] (T <= 32):
//   y   = LayerNorm(x[r]; eps 1e-5) * gamma + beta + pe          [T, C]
//   q,k,v = y Wq, y Wk, y Wv                                       [T, C]
//   a_h = softmax(q_h k_h^T * scale) v_h   for 8 heads of width C/8
//   out[r] = x[r] + a Wo + bo
// with the weights in the JAX layout [C_in, C_out], gamma/beta/pe in f32
// and x, the weights and bo in f32 or bf16.  y and the attention output
// are rounded to the input type before their products, as the TPU kernel
// does; everything else is f32.
//
// What bounds it: per row the four C x C products are 8*T*C^2 flops and
// the attention 4*T^2*C, against 2*T*C activation bytes read and written;
// the weights (4*C^2 elements) are the same for every row and come from
// L2.  So the kernel is bound by how often each block re-reads the
// weights and by the SIMT f32 FMA rate, not by device memory.
//
// Design: the TPU kernel kept a block of rows and all four weight panels
// in VMEM.  Here one block of 256 threads owns `rpb` rows (1, 2 or 4, chosen
// by the wrapper from the shared-memory budget) and keeps, for those rows,
// LN(x)+pe and q|k|v of all heads in shared memory (at C=384, T=32 and
// f32 about 198 KB, so the launch raises the dynamic shared-memory
// limit).  The products are register-tiled: each thread computes 8 token
// rows x 4 output columns, reading the activations as float4 along the
// contraction and the weights straight from global memory (L2), coalesced
// along the output columns, so each weight value feeds 8 rows and each
// loaded activation 4 columns.  The T x T softmax runs one warp per
// (query, head) with one lane per key (q|k|v row stride 3C+1, odd, so the
// per-key reads hit distinct banks), and the attention output overwrites
// the LN buffer, which the projections no longer need.  The
// out-projection then adds bo and the residual x and writes the rows.
// Head widths 8, 24 and 48 (vits) need no tensor-core tile shape.
//
// grouped_kernel replaces endodav_tpu/kernels/fused_temporal_block.py:
// _grouped_kernel (:120), launched by _forward_grouped (:206, pallas_call
// :226) for C >= 512 (vitl's C=1024 motion modules): the same function,
// with the heads split into G groups (C/256 groups, halved until they
// divide the heads; 4 groups of 2 heads of width 128 at vitl).  At C=1024
// the ungrouped layout needs 525 KB of shared memory a block; here one
// block owns one row [T, C] and keeps LN(x)+pe of the whole row (128 KB
// at T=32, f32) and q|k|v of ONE group (96 KB) in shared memory, 225.5 KB
// of the 227 KB a block may use.  A loop over the groups inside the block
// takes the place of the TPU grid's sequential group axis: per group the
// q|k|v panels are projected from the resident LN(x), the group's heads
// attend (the output overwrites the group's q columns, which no later
// step reads), and the out-projection partial sum for the rows Wo[g*Cg:
// (g+1)*Cg] is added, in f32 and in group order, to a scratch row in
// device memory that only this thread ever touches (same item-to-thread
// map in every group), as JAX sums the partials in VMEM scratch: no
// atomics, the same bits every run.  The last group adds x and bo and
// writes the output.  Bound and tiling as above: SIMT f32 FMAs on
// register tiles, the weights read from L2 once per row.

#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace endodav;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// LayerNorm (two-pass variance) + pe of the t tokens at xb into ys
// [mpad][c] (rows t..mpad-1 zeroed), rounded to T; one warp per token.
template <typename T>
__device__ void layer_norm_pe(const T* xb, const float* gamma, const float* beta,
                              const float* pe, float* ys, int m_valid, int mpad, int t, int c) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < mpad; m += WARPS) {
    float* yr = ys + m * c;
    if (m >= m_valid) {
      for (int j = lane; j < c; j += 32) yr[j] = 0.f;
      continue;
    }
    const T* xr = xb + (long long)m * c;
    float sum = 0.f;
    for (int j = lane; j < c; j += 32) sum += to_f(xr[j]);
    const float mu = warp_sum(sum) / c;
    float sq = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float d = to_f(xr[j]) - mu;
      sq += d * d;
    }
    const float inv = 1.f / sqrtf(warp_sum(sq) / c + 1e-5f);
    const float* per = pe + (m % t) * c;
    for (int j = lane; j < c; j += 32)
      yr[j] = round_to<T>((to_f(xr[j]) - mu) * inv * gamma[j] + beta[j] + per[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ pe,
             const T* __restrict__ wq, const T* __restrict__ wk, const T* __restrict__ wv,
             const T* __restrict__ wo, const T* __restrict__ bo, T* __restrict__ out,
             int rows, int t, int c, int heads, int rpb, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dh = c / heads;
  const int ldq = 3 * c + 1;  // odd: the per-key reads of the softmax hit distinct banks
  const int mpad = round_up(rpb * t, RM);
  float* ys = smem;              // [mpad][c]  LN(x)*gamma+beta+pe, then the attention output
  float* qkv = ys + mpad * c;    // [mpad][ldq] q | k | v of all heads
  float* pw = qkv + mpad * ldq;  // [WARPS][32] one softmax row per warp

  const int row0 = blockIdx.x * rpb;
  const int m_valid = min(rpb, rows - row0) * t;
  const T* xb = x + (long long)row0 * t * c;
  T* ob = out + (long long)row0 * t * c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = mpad / RM;

  layer_norm_pe(xb, gamma, beta, pe, ys, m_valid, mpad, t, c);
  __syncthreads();

  // q | k | v of every head: [mpad, c] x [c, 3c]
  const int qcols = 3 * c / RN;
  for (int item = threadIdx.x; item < qcols * groups; item += THREADS) {
    const int j0 = (item % qcols) * RN, m0 = (item / qcols) * RM;
    const int which = j0 / c;
    const T* w = (which == 0 ? wq : (which == 1 ? wk : wv)) + (j0 - which * c);
    float acc[RM][RN];
    tile_product(ys + m0 * c, c, w, c, c, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int n = 0; n < RN; ++n) qkv[(m0 + i) * ldq + j0 + n] = acc[i][n];
  }
  __syncthreads();

  // softmax over the T keys of the same row: one warp per (query, head),
  // one lane per key; the head's output overwrites its columns of ys
  for (int item = warp; item < m_valid * heads; item += WARPS) {
    const int m = item / heads, h = item % heads;
    const int r0 = (m / t) * t;
    const float* qr = qkv + m * ldq + h * dh;
    float s = -CUDART_INF_F;
    if (lane < t) {
      const float* kr = qkv + (r0 + lane) * ldq + c + h * dh;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kr[d], acc);
      s = acc * scale;
    }
    const float mx = warp_max(s);
    const float p = lane < t ? expf(s - mx) : 0.f;
    pw[warp * 32 + lane] = p / warp_sum(p);
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      const float* vc = qkv + r0 * ldq + 2 * c + h * dh + d;
      float acc = 0.f;
      for (int tk = 0; tk < t; ++tk) acc = fmaf(pw[warp * 32 + tk], vc[tk * ldq], acc);
      ys[m * c + h * dh + d] = round_to<T>(acc);
    }
    __syncwarp();
  }
  __syncthreads();

  // out-projection + bo + residual
  const int ocols = c / RN;
  for (int item = threadIdx.x; item < ocols * groups; item += THREADS) {
    const int j0 = (item % ocols) * RN, m0 = (item / ocols) * RM;
    float acc[RM][RN];
    tile_product(ys + m0 * c, c, wo + j0, c, c, acc);
    float bj[RN];
#pragma unroll
    for (int n = 0; n < RN; ++n) bj[n] = to_f(bo[j0 + n]);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = m0 + i;
      if (m < m_valid) {
#pragma unroll
        for (int n = 0; n < RN; ++n) {
          const long long off = (long long)m * c + j0 + n;
          ob[off] = from_f<T>(to_f(xb[off]) + acc[i][n] + bj[n]);
        }
      }
    }
  }
}

// One block per row [T, C]; the heads in `groups` groups (see the note at
// the top).  acc is an f32 scratch [rows, T, C].
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
grouped_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ pe,
               const T* __restrict__ wq, const T* __restrict__ wk, const T* __restrict__ wv,
               const T* __restrict__ wo, const T* __restrict__ bo, T* __restrict__ out,
               float* __restrict__ acc_rows, int t, int c, int heads, int groups, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cg = c / groups, heads_g = heads / groups, dh = cg / heads_g;
  // a multiple of 4 (float4 rows for the out-projection's reads of the
  // attention output); the per-key reads of the softmax meet 4-way bank
  // conflicts, under 2% of the block's arithmetic
  const int ldq = 3 * cg + 4;
  const int mpad = round_up(t, RM);
  float* ys = smem;              // [mpad][c]   LN(x)*gamma+beta+pe
  float* qkv = ys + mpad * c;    // [mpad][ldq] q | k | v of one group; q <- attention output
  float* pw = qkv + mpad * ldq;  // [WARPS][32] one softmax row per warp

  const long long row_off = (long long)blockIdx.x * t * c;
  const T* xb = x + row_off;
  T* ob = out + row_off;
  float* ab = acc_rows + row_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mgroups = mpad / RM;

  layer_norm_pe(xb, gamma, beta, pe, ys, t, mpad, t, c);
  __syncthreads();

  for (int g = 0; g < groups; ++g) {
    // q | k | v of the group's heads: [mpad, c] x [c, 3 cg]
    const int qcols = 3 * cg / RN;
    for (int item = threadIdx.x; item < qcols * mgroups; item += THREADS) {
      const int j0 = (item % qcols) * RN, m0 = (item / qcols) * RM;
      const int which = j0 / cg;
      const T* w = (which == 0 ? wq : (which == 1 ? wk : wv)) + g * cg + (j0 - which * cg);
      float acc[RM][RN];
      tile_product(ys + m0 * c, c, w, c, c, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int n = 0; n < RN; ++n) qkv[(m0 + i) * ldq + j0 + n] = acc[i][n];
    }
    __syncthreads();

    // softmax over the T keys: one warp per (query, head of the group),
    // one lane per key; the output overwrites the (query, head) q columns
    for (int item = warp; item < t * heads_g; item += WARPS) {
      const int m = item / heads_g, h = item % heads_g;
      float* qr = qkv + m * ldq + h * dh;
      float s = -CUDART_INF_F;
      if (lane < t) {
        const float* kr = qkv + lane * ldq + cg + h * dh;
        float acc = 0.f;
        for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc * scale;
      }
      const float mx = warp_max(s);
      const float p = lane < t ? expf(s - mx) : 0.f;
      pw[warp * 32 + lane] = p / warp_sum(p);
      __syncwarp();
      for (int d = lane; d < dh; d += 32) {
        const float* vc = qkv + 2 * cg + h * dh + d;
        float acc = 0.f;
        for (int tk = 0; tk < t; ++tk) acc = fmaf(pw[warp * 32 + tk], vc[tk * ldq], acc);
        qr[d] = round_to<T>(acc);
      }
      __syncwarp();
    }
    __syncthreads();

    // out-projection partial: attention [mpad, cg] x Wo[g cg:(g+1) cg, :],
    // summed over the groups in order in the f32 scratch row
    const int ocols = c / RN;
    const bool last = g == groups - 1;
    for (int item = threadIdx.x; item < ocols * mgroups; item += THREADS) {
      const int j0 = (item % ocols) * RN, m0 = (item / ocols) * RM;
      float acc[RM][RN];
      tile_product(qkv + m0 * ldq, ldq, wo + (long long)g * cg * c + j0, c, cg, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = m0 + i;
        if (m < t) {
#pragma unroll
          for (int n = 0; n < RN; ++n) {
            const long long off = (long long)m * c + j0 + n;
            const float sum = g == 0 ? acc[i][n] : ab[off] + acc[i][n];
            if (last)
              ob[off] = from_f<T>(to_f(xb[off]) + sum + to_f(bo[j0 + n]));
            else
              ab[off] = sum;
          }
        }
      }
    }
    __syncthreads();  // the next group's projections overwrite qkv
  }
}

// Dynamic shared memory of one block, in bytes (mirrored by the wrapper,
// which checks it against the card's 227 KB before launching).
size_t smem_bytes(int t, int c, int rpb) {
  const int mpad = round_up(rpb * t, RM);
  return ((size_t)mpad * c + (size_t)mpad * (3 * c + 1) + WARPS * 32) * sizeof(float);
}

size_t grouped_smem_bytes(int t, int c, int groups) {
  const int mpad = round_up(t, RM);
  return ((size_t)mpad * c + (size_t)mpad * (3 * (c / groups) + 4) + WARPS * 32) *
         sizeof(float);
}

template <typename T>
int launch_grouped(const void* x, const float* gamma, const float* beta, const float* pe,
                   const void* wq, const void* wk, const void* wv, const void* wo,
                   const void* bo, void* out, float* acc, int rows, int t, int c, int heads,
                   int groups, float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(grouped_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_kernel<T><<<rows, THREADS, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, pe, static_cast<const T*>(wq),
      static_cast<const T*>(wk), static_cast<const T*>(wv), static_cast<const T*>(wo),
      static_cast<const T*>(bo), static_cast<T*>(out), acc, t, c, heads, groups, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, const float* pe,
           const void* wq, const void* wk, const void* wv, const void* wo, const void* bo,
           void* out, int rows, int t, int c, int heads, int rpb, float scale,
           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(block_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + rpb - 1) / rpb;
  block_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, pe, static_cast<const T*>(wq),
      static_cast<const T*>(wk), static_cast<const T*>(wv), static_cast<const T*>(wo),
      static_cast<const T*>(bo), static_cast<T*>(out), rows, t, c, heads, rpb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int endodav_fused_temporal_block(int dtype, const void* x, const void* gamma,
                                            const void* beta, const void* pe, const void* wq,
                                            const void* wk, const void* wv, const void* wo,
                                            const void* bo, void* out, int rows, int t, int c,
                                            int heads, int rpb, float scale, void* stream) {
  if (rows < 1 || t < 1 || t > 32 || heads < 1 || c % heads != 0 || c % 4 != 0 || rpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(t, c, rpb);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* p = static_cast<const float*>(pe);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, g, bt, p, wq, wk, wv, wo, bo, out, rows, t, c, heads, rpb, scale,
                         smem, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, g, bt, p, wq, wk, wv, wo, bo, out, rows, t, c, heads, rpb,
                                 scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The head-grouped kernel; acc is an f32 scratch [rows, t, c].  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int endodav_fused_temporal_block_grouped(
    int dtype, const void* x, const void* gamma, const void* beta, const void* pe,
    const void* wq, const void* wk, const void* wv, const void* wo, const void* bo, void* out,
    void* acc, int rows, int t, int c, int heads, int groups, float scale, void* stream) {
  if (rows < 1 || t < 1 || t > 32 || groups < 1 || heads % groups != 0 || c % heads != 0 ||
      (c / groups) % RN != 0 || c % RN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = grouped_smem_bytes(t, c, groups);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* p = static_cast<const float*>(pe);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_grouped<float>(x, g, bt, p, wq, wk, wv, wo, bo, out, a, rows, t, c, heads,
                                 groups, scale, smem, s);
  if (dtype == kBFloat16)
    return launch_grouped<__nv_bfloat16>(x, g, bt, p, wq, wk, wv, wo, bo, out, a, rows, t, c,
                                         heads, groups, scale, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
