// Bilinear grid-sample (forward, backward) and forward-splat occupancy
// kernels of the self-supervised training losses, for Hopper (sm_90a).
//
// Replaces (endodav_tpu/kernels/warp_matmul.py):
//   grid_sample_fwd  <- _fwd_kernel (:327, pallas_call :839; its channel-plane
//                       twin _fwd_kernel_cp :374 computes the same function)
//   grid_sample_bwd  <- _bwd_fused_kernel (:488, pallas_call :958) with
//                       img_grad = 1, _bwd_coord_kernel (:436, pallas_call :978)
//                       with img_grad = 0, and the epilogue _mm_bwd_epilogue
//                       (:996) that turns lerp-weight grads into d_fx, d_fy
//   splat            <- _splat_kernel (:1029, pallas_call :1107)
//
// The functions are those of endodav_tpu/ops/sampling.py (:114-134 the
// 4-corner gather, :181-214 the splat), not of the one-hot-matmul
// formulation: the TPU had no fast gather and spent H MACs per pixel on
// the MXU to emulate one; an SM gathers directly.  So there are no row
// bands, lane windows, tiles or packed coordinates here.
//
// Semantics (identical to the plain versions in kernels/warp_matmul.py):
//   img [B_img, H, W, C] f32 channels-last; fx, fy [B_img * img_tile, P]
//   f32 fractional source pixel coordinates (align_corners already resolved
//   by the caller); grid element bg samples image bg / img_tile.  Corners
//   floor(f) and floor(f) + 1 are clipped into the image (border); in zeros
//   mode a corner outside [0, size - 1] gets weight 0.
//
// What bounds them: each output pixel reads two coordinates and (in the
// forward) four corners of C floats, mostly from L2 because neighbouring
// pixels share corners, and writes C floats: a few flops per byte, so the
// card's memory bandwidth is the bound.  The colour-synthesis warp of the
// training step reads a 32x256x320x3 f32 image (31 MB) and coordinates of
// 128 grids (84 MB) and writes 126 MB: about 72 us at 3.35 TB/s.  The
// design is the simplest that streams: one thread per output pixel
// (forward, backward) or source pixel (splat), consecutive threads on
// consecutive pixels so coordinate and output accesses coalesce, channels
// looped in registers (C is a template parameter, 1..4).
//
// Atomics: the fused backward accumulates d_img and the splat accumulates
// occupancy with f32 atomicAdd.  The order in which the additions land
// changes from run to run, so both results vary in their last bits between
// runs; nothing else here depends on the order.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Axis {
  int i0, i1;      // clipped corner indices floor(f), floor(f) + 1
  float w0, w1;    // lerp weights, times the inside masks in zeros mode
  float v0, v1;    // inside masks (1 in border mode)
};

// ops/sampling.py:114-131 / warp_matmul.py:_corners, in f32
__device__ __forceinline__ Axis axis_corners(float f, int size, bool zeros) {
  const float f0 = floorf(f);
  const float f1 = f0 + 1.f;
  const float hi = static_cast<float>(size - 1);
  Axis a;
  a.w1 = f - f0;
  a.w0 = 1.f - a.w1;
  a.v0 = (f0 >= 0.f && f0 <= hi) ? 1.f : 0.f;
  a.v1 = (f1 >= 0.f && f1 <= hi) ? 1.f : 0.f;
  if (zeros) {
    a.w0 *= a.v0;
    a.w1 *= a.v1;
  } else {
    a.v0 = 1.f;
    a.v1 = 1.f;
  }
  // clip in f32 before the integer conversion (fmaxf sends NaN to 0)
  a.i0 = static_cast<int>(fminf(fmaxf(f0, 0.f), hi));
  a.i1 = static_cast<int>(fminf(fmaxf(f1, 0.f), hi));
  return a;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
grid_sample_fwd_kernel(const float* __restrict__ img, const float* __restrict__ fx,
                       const float* __restrict__ fy, float* __restrict__ out, long long total,
                       int p, int h, int w, int img_tile, bool zeros) {
  const long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (i >= total) return;
  const long long bg = i / p;
  const float* im = img + (bg / img_tile) * static_cast<long long>(h) * w * C;
  const Axis ax = axis_corners(__ldg(fx + i), w, zeros);
  const Axis ay = axis_corners(__ldg(fy + i), h, zeros);
  const float* r0 = im + static_cast<long long>(ay.i0) * w * C;
  const float* r1 = im + static_cast<long long>(ay.i1) * w * C;
  const float w00 = ay.w0 * ax.w0, w01 = ay.w0 * ax.w1;
  const float w10 = ay.w1 * ax.w0, w11 = ay.w1 * ax.w1;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float v00 = __ldg(r0 + ax.i0 * C + c), v01 = __ldg(r0 + ax.i1 * C + c);
    const float v10 = __ldg(r1 + ax.i0 * C + c), v11 = __ldg(r1 + ax.i1 * C + c);
    // the plain version's corner order: (y0, x0), (y0, x1), (y1, x0), (y1, x1)
    out[i * C + c] = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
  }
}

template <int C, bool IMG_GRAD>
__global__ void __launch_bounds__(THREADS)
grid_sample_bwd_kernel(const float* __restrict__ img, const float* __restrict__ fx,
                       const float* __restrict__ fy, const float* __restrict__ g,
                       float* __restrict__ dfx, float* __restrict__ dfy, float* __restrict__ dimg,
                       long long total, int p, int h, int w, int img_tile, bool zeros) {
  const long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (i >= total) return;
  const long long bg = i / p;
  const long long plane = static_cast<long long>(h) * w * C;
  const float* im = img + (bg / img_tile) * plane;
  const Axis ax = axis_corners(__ldg(fx + i), w, zeros);
  const Axis ay = axis_corners(__ldg(fy + i), h, zeros);
  const long long o0 = static_cast<long long>(ay.i0) * w * C;
  const long long o1 = static_cast<long long>(ay.i1) * w * C;
  // gradients of the four (masked) lerp weights, as the TPU kernels'
  // dw rows (wy0, wy1, wx0, wx1)
  float dwy0 = 0.f, dwy1 = 0.f, dwx0 = 0.f, dwx1 = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float gc = __ldg(g + i * C + c);
    const float v00 = __ldg(im + o0 + ax.i0 * C + c), v01 = __ldg(im + o0 + ax.i1 * C + c);
    const float v10 = __ldg(im + o1 + ax.i0 * C + c), v11 = __ldg(im + o1 + ax.i1 * C + c);
    dwy0 += gc * (ax.w0 * v00 + ax.w1 * v01);
    dwy1 += gc * (ax.w0 * v10 + ax.w1 * v11);
    dwx0 += gc * (ay.w0 * v00 + ay.w1 * v10);
    dwx1 += gc * (ay.w0 * v01 + ay.w1 * v11);
    if (IMG_GRAD) {
      // img_tile == 1 here (the wrapper refuses anything else), so the
      // image of grid element bg is bg itself
      float* d = dimg + bg * plane;
      const float a00 = gc * ay.w0 * ax.w0, a01 = gc * ay.w0 * ax.w1;
      const float a10 = gc * ay.w1 * ax.w0, a11 = gc * ay.w1 * ax.w1;
      if (a00 != 0.f) atomicAdd(d + o0 + ax.i0 * C + c, a00);
      if (a01 != 0.f) atomicAdd(d + o0 + ax.i1 * C + c, a01);
      if (a10 != 0.f) atomicAdd(d + o1 + ax.i0 * C + c, a10);
      if (a11 != 0.f) atomicAdd(d + o1 + ax.i1 * C + c, a11);
    }
  }
  // _mm_bwd_epilogue: w1 = frac(f) * v1, w0 = (1 - frac(f)) * v0, so
  // d_f = d_w1 * v1 - d_w0 * v0 (v == 1 in border mode)
  dfx[i] = dwx1 * ax.v1 - dwx0 * ax.v0;
  dfy[i] = dwy1 * ay.v1 - dwy0 * ay.v0;
}

// ops/sampling.py:_splat_xla: unit bilinear mass at (x, y) onto the four
// corners floor and floor + 1 ("ceil"); a corner moved by the clip gets 0
__global__ void __launch_bounds__(THREADS)
splat_kernel(const float* __restrict__ xs, const float* __restrict__ ys, float* __restrict__ occ,
             long long total, int p, int h, int w) {
  const long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (i >= total) return;
  const long long b = i / p;
  const float x = __ldg(xs + i), y = __ldg(ys + i);
  const float x1 = floorf(x), y1 = floorf(y);
  const float x0 = x1 + 1.f, y0 = y1 + 1.f;
  const float xf = fminf(fmaxf(x1, 0.f), static_cast<float>(w - 1));
  const float yf = fminf(fmaxf(y1, 0.f), static_cast<float>(h - 1));
  const float xc = fminf(fmaxf(x0, 0.f), static_cast<float>(w - 1));
  const float yc = fminf(fmaxf(y0, 0.f), static_cast<float>(h - 1));
  const bool bad_xc = x0 != xc, bad_yc = y0 != yc, bad_xf = x1 != xf, bad_yf = y1 != yf;
  const float cxs[4] = {xc, xc, xf, xf};
  const float cys[4] = {yc, yf, yc, yf};
  const bool bad[4] = {bad_xc || bad_yc, bad_xc || bad_yf, bad_xf || bad_yc, bad_xf || bad_yf};
  float* o = occ + b * static_cast<long long>(h) * w;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (bad[k]) continue;
    const float val = (1.f - fabsf(x - cxs[k])) * (1.f - fabsf(y - cys[k]));
    atomicAdd(o + static_cast<int>(cys[k]) * w + static_cast<int>(cxs[k]), val);
  }
}

inline unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + THREADS - 1) / THREADS);
}

template <int C>
void launch_fwd(const float* img, const float* fx, const float* fy, float* out, long long total,
                int p, int h, int w, int img_tile, bool zeros, cudaStream_t s) {
  grid_sample_fwd_kernel<C><<<blocks_for(total), THREADS, 0, s>>>(img, fx, fy, out, total, p, h,
                                                                  w, img_tile, zeros);
}

template <int C>
void launch_bwd(const float* img, const float* fx, const float* fy, const float* g, float* dfx,
                float* dfy, float* dimg, long long total, int p, int h, int w, int img_tile,
                bool zeros, cudaStream_t s) {
  if (dimg != nullptr) {
    grid_sample_bwd_kernel<C, true><<<blocks_for(total), THREADS, 0, s>>>(
        img, fx, fy, g, dfx, dfy, dimg, total, p, h, w, img_tile, zeros);
  } else {
    grid_sample_bwd_kernel<C, false><<<blocks_for(total), THREADS, 0, s>>>(
        img, fx, fy, g, dfx, dfy, nullptr, total, p, h, w, img_tile, zeros);
  }
}

bool bad_shape(int bg, int p, int h, int w, int c, int img_tile) {
  return bg < 1 || p < 1 || h < 1 || w < 1 || c < 1 || c > 4 || img_tile < 1 ||
         bg % img_tile != 0 || static_cast<long long>(bg) * p >= (1LL << 40);
}

}  // namespace

// All entry points return the cudaError_t of the launch (0 on success).

// out [bg, p, c] = bilinear sample of img [bg / img_tile, h, w, c] at (fx, fy) [bg, p]
extern "C" int endodav_grid_sample_fwd(const float* img, const float* fx, const float* fy,
                                       float* out, int bg, int p, int h, int w, int c,
                                       int img_tile, int zeros, void* stream) {
  if (bad_shape(bg, p, h, w, c, img_tile)) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(bg) * p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: launch_fwd<1>(img, fx, fy, out, total, p, h, w, img_tile, zeros != 0, s); break;
    case 2: launch_fwd<2>(img, fx, fy, out, total, p, h, w, img_tile, zeros != 0, s); break;
    case 3: launch_fwd<3>(img, fx, fy, out, total, p, h, w, img_tile, zeros != 0, s); break;
    default: launch_fwd<4>(img, fx, fy, out, total, p, h, w, img_tile, zeros != 0, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// d_fx, d_fy [bg, p] from the cotangent g [bg, p, c]; with dimg non-null
// (the fused kernel, img_tile 1) also accumulates d_img [bg, h, w, c],
// which the caller has zeroed.
extern "C" int endodav_grid_sample_bwd(const float* img, const float* fx, const float* fy,
                                       const float* g, float* dfx, float* dfy, float* dimg,
                                       int bg, int p, int h, int w, int c, int img_tile,
                                       int zeros, void* stream) {
  if (bad_shape(bg, p, h, w, c, img_tile) || (dimg != nullptr && img_tile != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(bg) * p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool z = zeros != 0;
  switch (c) {
    case 1: launch_bwd<1>(img, fx, fy, g, dfx, dfy, dimg, total, p, h, w, img_tile, z, s); break;
    case 2: launch_bwd<2>(img, fx, fy, g, dfx, dfy, dimg, total, p, h, w, img_tile, z, s); break;
    case 3: launch_bwd<3>(img, fx, fy, g, dfx, dfy, dimg, total, p, h, w, img_tile, z, s); break;
    default: launch_bwd<4>(img, fx, fy, g, dfx, dfy, dimg, total, p, h, w, img_tile, z, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// occ [b, h, w] += unit bilinear mass of the p source pixels (x, y) [b, p];
// the caller has zeroed occ.
extern "C" int endodav_splat(const float* x, const float* y, float* occ, int b, int p, int h,
                             int w, void* stream) {
  if (b < 1 || p < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(b) * p;
  splat_kernel<<<blocks_for(total), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, occ, total, p, h, w);
  return static_cast<int>(cudaGetLastError());
}
