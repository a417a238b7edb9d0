// Fused transformer MLP of the ViT blocks, for Hopper (sm_90a).
//
// Replaces: endodav_tpu/kernels/fused_mlp.py:_kernel (:73), launched by
// fused_mlp (:83, pallas_call :100) from models/vit.py:Mlp (:90-102).
//
// Computes, for x [R, C] and the weights in the JAX layout [in, out]:
//   h   = gelu(x W1 + b1)        [R, H]   (exact gelu, erff)
//   out = h W2 + b2              [R, C2]
// with x, W1, W2 and out in f32 or bf16, b1 and b2 in f32, h rounded to
// the input type before the second product (the TPU kernel's dtype
// chain); every sum is f32.
//
// What bounds it: 2*R*C*H + 2*R*H*C2 flops against (R*C + R*C2) activation
// bytes and the weights once: at vits (384 -> 1536 -> 384) and vitl
// (1024 -> 4096 -> 1024) widths and R in the tens of thousands it is far
// above the card's ridge point, so the FMA rate bounds it (SIMT f32 here).
//
// Design: the TPU kernel held a 512-row tile and both weight panels in
// VMEM with the hidden [512, 4C] on chip.  On Hopper the hidden of one
// row block at vitl ([16, 4096] f32, 256 KB) does not fit a block, so a
// block of 256 threads owns BM rows (32 at vits, 16 at vitl, chosen by
// the wrapper from the shared-memory budget) and walks the hidden
// dimension in tiles of HT columns: per tile it computes h = gelu(x W1 +
// b1) for [BM, HT] into shared memory, then adds h W2[tile, :] into an f32
// accumulator [BM, C2] in shared memory.  Every accumulator element
// belongs to one thread for the whole walk (the same item-to-thread map
// for every tile), so the tiles add in order without atomics or a barrier
// between a thread's updates.  x [BM, C] stays in shared memory; the
// products are the temporal block's register tiles (8 rows x 4 columns a
// thread, weights from L2 coalesced along the output columns, each
// weight value reused for 8 rows).  HT is set so that the first product
// gives every thread a tile (BM/8 x HT/4 >= 256).

#include "common.cuh"

namespace {

using namespace endodav;

constexpr int THREADS = 256;

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out,
           int rows, int c, int hdim, int c2, int bm, int ht) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [bm][c]
  float* hs = xs + bm * c;                        // [bm][ht]
  float* acc_s = hs + bm * ht;                    // [bm][c2]
  const int row0 = blockIdx.x * bm;
  const int valid = min(bm, rows - row0);
  const T* xb = x + (long long)row0 * c;
  T* ob = out + (long long)row0 * c2;
  const int mgroups = bm / RM;

  for (int i = threadIdx.x; i < bm * c; i += THREADS)
    xs[i] = i / c < valid ? to_f(xb[i]) : 0.f;
  for (int i = threadIdx.x; i < bm * c2; i += THREADS) acc_s[i] = 0.f;

  const int hcols = ht / RN, ocols = c2 / RN;
  for (int j0 = 0; j0 < hdim; j0 += ht) {
    __syncthreads();  // xs loaded; the previous tile's hs read
    for (int item = threadIdx.x; item < hcols * mgroups; item += THREADS) {
      const int n0 = (item % hcols) * RN, m0 = (item / hcols) * RM;
      float acc[RM][RN];
      tile_product(xs + m0 * c, c, w1 + j0 + n0, hdim, c, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int n = 0; n < RN; ++n)
          hs[(m0 + i) * ht + n0 + n] = round_to<T>(gelu_erf(acc[i][n] + b1[j0 + n0 + n]));
    }
    __syncthreads();
    for (int item = threadIdx.x; item < ocols * mgroups; item += THREADS) {
      const int n0 = (item % ocols) * RN, m0 = (item / ocols) * RM;
      float acc[RM][RN];
      tile_product(hs + m0 * ht, ht, w2 + (long long)j0 * c2 + n0, c2, ht, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int n = 0; n < RN; ++n) acc_s[(m0 + i) * c2 + n0 + n] += acc[i][n];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < valid * c2; i += THREADS)
    ob[i] = from_f<T>(acc_s[i] + b2[i % c2]);
}

template <typename T>
int launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
           void* out, int rows, int c, int hdim, int c2, int bm, int ht, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + bm - 1) / bm;
  mlp_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<T*>(out), rows, c, hdim, c2, bm, ht);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  Shared memory
// (bm*c + bm*ht + bm*c2) f32 is mirrored by the wrapper's budget check.
extern "C" int endodav_fused_mlp(int dtype, const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out, int rows, int c,
                                 int hdim, int c2, int bm, int ht, void* stream) {
  if (rows < 1 || bm < RM || bm % RM != 0 || ht < RN || ht % RN != 0 || hdim % ht != 0 ||
      c % 4 != 0 || c2 % RN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((size_t)bm * c + (size_t)bm * ht + (size_t)bm * c2) * sizeof(float);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, w1, fb1, w2, fb2, out, rows, c, hdim, c2, bm, ht, smem, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, w1, fb1, w2, fb2, out, rows, c, hdim, c2, bm, ht, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
