// Fused DPT ResidualConvUnit, for Hopper (sm_90a).
//
// Replaces: endodav_tpu/kernels/fused_rcu.py:_kernel (:80), launched by
// _fused_rcu_impl (:133, pallas_call :161) through fused_rcu (:184) from
// models/dpt.py:ResidualConvUnit (:77-87) under ENDODAV_FUSED_RCU.
//
// Computes, for x [B, H, W, C] channels-last and the weights as 3x3 taps
// [9][C_in][C_out] (rows ordered ky, kx, ci as the TPU kernel's [9C, C]
// panels), with SAME zero padding:
//   t   = relu(conv3x3(relu(x), w1) + b1)      zero outside the image
//   out = (conv3x3(t, w2) + b2) + x
// x, the weights and out in f32 or bf16, b1 and b2 in f32, every sum in
// f32.  In bf16 the intermediate t is rounded to bf16 before conv2 and
// conv2's output is rounded to bf16 before the skip add, as the TPU
// kernel's dtype chain (:124, :128-130).
//
// What bounds it: 2 * 2*9*C*C flops a pixel against 2*C elements read and
// written: at the vits head width C=64 that is 73,728 flops per 512 bytes
// of f32, far above the card's ridge point, so the FMA rate bounds it
// (SIMT f32 here, no tensor cores yet).
//
// Design: one block of 256 threads per (frame, 8x16 output tile).  The
// input tile with a halo of 2 ((8+4) x (16+4) x C, relu applied, zeros
// outside the image) is loaded into shared memory once; conv1 runs over
// the (8+2) x (16+2) intermediate region (the output tile with a halo of
// 1) into a second shared-memory tile, and conv2 over the output tile
// reads it from there: the intermediate never reaches device memory.
// Shared memory is 420*C floats: 107.5 KB at C=64, 215 KB at C=128 (the
// largest width the wrapper accepts).  Each thread computes 8 pixels x 4
// output channels at a time, reading the activations as float4 along the
// input channels from shared memory and the weights as rows of 4 output
// channels from L2 (the whole [9, C, C] set is 147 KB at C=64, read by
// every block and so resident in L2): 128 FMAs per 12 loads.
//
// The trap the TPU kernel masks (:114-124): conv2's SAME padding pads the
// *intermediate* with zeros at the image borders, but recomputing the
// intermediate's halo from zero-padded x would give relu(b1) there.  The
// intermediate is therefore set to 0 wherever its pixel lies outside the
// image, and the output pixels outside the image are not written.

#include "common.cuh"

namespace {

using namespace endodav;

constexpr int THREADS = 256;
constexpr int TH = 8, TW = 16;           // output tile
constexpr int IH = TH + 4, IW = TW + 4;  // input tile, halo 2
constexpr int MH = TH + 2, MW = TW + 2;  // intermediate tile, halo 1
constexpr int PX = 8;                    // pixels of a thread's register tile
constexpr int CH = 4;                    // output channels of a thread's register tile

// acc[i][n] += sum over the 9 taps and the c input channels of
// src[off[i] + shift(tap) + ci] * w[tap][ci][n0 + n]; src is a shared-memory
// tile src_w pixels wide with c floats a pixel, off[i] the offset of the
// tap-(0, 0) pixel of output pixel i.  c is a multiple of 4.
template <typename T>
__device__ __forceinline__ void conv3x3_tile(const float* src, int src_w, const int (&off)[PX],
                                             const T* __restrict__ w, int c, int n0,
                                             float (&acc)[PX][CH]) {
  for (int tap = 0; tap < 9; ++tap) {
    const float* s = src + ((tap / 3) * src_w + tap % 3) * c;
    const T* wt = w + (long long)tap * c * c + n0;
    for (int ci = 0; ci < c; ci += 4) {
      float wv[4][CH];
#pragma unroll
      for (int u = 0; u < 4; ++u) load4(wt + (long long)(ci + u) * c, wv[u]);
      float av[PX][4];
#pragma unroll
      for (int i = 0; i < PX; ++i) load4(s + off[i] + ci, av[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < PX; ++i)
#pragma unroll
          for (int n = 0; n < CH; ++n) acc[i][n] = fmaf(av[i][u], wv[u][n], acc[i][n]);
    }
  }
}

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rcu_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, int h,
           int w, int c, int tiles_h, int tiles_w) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [IH][IW][c]: relu(x), 0 outside the image
  float* ms = xs + IH * IW * c;                   // [MH][MW][c]: t, 0 outside the image
  const int tx = blockIdx.x % tiles_w;
  const int ty = (blockIdx.x / tiles_w) % tiles_h;
  const long long frame = blockIdx.x / (tiles_w * tiles_h);
  const int oy0 = ty * TH, ox0 = tx * TW;
  const long long fbase = frame * h * w * c;
  const T* xf = x + fbase;
  T* of = out + fbase;

  for (int i = threadIdx.x; i < IH * IW * c; i += THREADS) {
    const int p = i / c, ch = i % c;
    const int yy = oy0 - 2 + p / IW, xx = ox0 - 2 + p % IW;
    xs[i] = inside(yy, xx, h, w) ? fmaxf(to_f(xf[((long long)yy * w + xx) * c + ch]), 0.f) : 0.f;
  }
  __syncthreads();

  const int cgroups = c / CH;
  // conv1 over the MH x MW intermediate region
  constexpr int M_PIX = MH * MW;
  for (int item = threadIdx.x; item < (M_PIX + PX - 1) / PX * cgroups; item += THREADS) {
    const int n0 = (item % cgroups) * CH, p0 = (item / cgroups) * PX;
    int off[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const int p = min(p0 + i, M_PIX - 1);  // past the region: recompute its last pixel
      off[i] = ((p / MW) * IW + p % MW) * c;
    }
    float acc[PX][CH] = {};
    conv3x3_tile(xs, IW, off, w1, c, n0, acc);
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const int p = p0 + i;
      if (p >= M_PIX) break;
      const bool in = inside(oy0 - 1 + p / MW, ox0 - 1 + p % MW, h, w);
#pragma unroll
      for (int n = 0; n < CH; ++n)
        ms[p * c + n0 + n] = in ? round_to<T>(fmaxf(acc[i][n] + b1[n0 + n], 0.f)) : 0.f;
    }
  }
  __syncthreads();

  // conv2 over the TH x TW output tile (a pixel group lies in one tile row)
  for (int item = threadIdx.x; item < TH * TW / PX * cgroups; item += THREADS) {
    const int n0 = (item % cgroups) * CH, p0 = (item / cgroups) * PX;
    int off[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) off[i] = (((p0 + i) / TW) * MW + (p0 + i) % TW) * c;
    float acc[PX][CH] = {};
    conv3x3_tile(ms, MW, off, w2, c, n0, acc);
    const int yy = oy0 + p0 / TW;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const int xx = ox0 + (p0 + i) % TW;
      if (!inside(yy, xx, h, w)) continue;
      const long long o = ((long long)yy * w + xx) * c + n0;
#pragma unroll
      for (int n = 0; n < CH; ++n) {
        const float y = round_to<T>(acc[i][n] + b2[n0 + n]);
        of[o + n] = from_f<T>(y + to_f(xf[o + n]));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
           void* out, int b, int h, int w, int c, cudaStream_t stream) {
  const size_t smem = (size_t)(IH * IW + MH * MW) * c * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rcu_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (h + TH - 1) / TH, tiles_w = (w + TW - 1) / TW;
  const long long blocks = (long long)b * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rcu_kernel<T><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<T*>(out), h, w, c, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  x and out
// [b, h, w, c]; w1, w2 [9, c, c] in x's type; b1, b2 [c] f32.  Shared
// memory (420 * c floats) is mirrored by the wrapper's check.
extern "C" int endodav_fused_rcu(int dtype, const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out, int b, int h, int w,
                                 int c, void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < CH || c > 128 || c % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, w1, fb1, w2, fb2, out, b, h, w, c, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, w1, fb1, w2, fb2, out, b, h, w, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
