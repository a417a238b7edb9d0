// Bilinear grid-sample (forward, backward) and forward-splat occupancy
// kernels of the self-supervised training losses, for Hopper (sm_90a).
//
// Replaces (endodav_tpu/kernels/warp_matmul.py):
//   grid_sample_fwd  <- _fwd_kernel (:327, pallas_call :839) with planes = 0,
//                       its channel-plane twin _fwd_kernel_cp (:374, pallas_call
//                       :804) with planes = 1
//   grid_sample_bwd  <- _bwd_fused_kernel (:488, pallas_call :958) with
//                       img_grad = 1, _bwd_coord_kernel (:436, pallas_call :978)
//                       with img_grad = 0, their channel-plane twins
//                       _bwd_fused_kernel_cp (:562, pallas_call :904) and
//                       _bwd_coord_kernel_cp (:637, pallas_call :924) with
//                       planes = 1, and the epilogue _mm_bwd_epilogue (:996)
//                       that turns lerp-weight grads into d_fx, d_fy
//   splat            <- _splat_kernel (:1029, pallas_call :1107)
//
// The functions are those of endodav_tpu/ops/sampling.py (:114-134 the
// 4-corner gather, :181-214 the splat), not of the one-hot-matmul
// formulation: the TPU had no fast gather and spent H MACs per pixel on
// the MXU to emulate one; an SM gathers directly.
//
// Semantics (identical to the plain versions in kernels/warp_matmul.py):
//   img [B_img, H, W, C] f32 channels-last, or with PLANES (the
//   ENDODAV_WARP_CP route) [B_img, C, H, W] f32 channel planes, and d_img
//   in the image's layout; fx, fy [B_img * img_tile, P] f32 fractional
//   source pixel coordinates (align_corners already resolved by the
//   caller), the P pixels of a grid element being P / pw rows of pw; grid
//   element bg samples image bg / img_tile.  Corners floor(f) and
//   floor(f) + 1 are clipped into the image (border); in zeros mode a
//   corner outside [0, size - 1] gets weight 0.
//
// What bounds them: each output pixel reads two coordinates and four
// corners of C floats, mostly from L2 or L1 because neighbouring pixels
// share corners, and writes C floats (the backward: reads the cotangent,
// writes two coordinate gradients and, fused, adds into d_img): a few
// flops per byte, so the card's memory bandwidth is the bound.  The
// colour-synthesis warp of the training step reads a 32x256x320x3 f32
// image (31 MB) and coordinates of 128 grids (84 MB) and writes 126 MB:
// about 72 us at 3.35 TB/s.  What the designs do about it:
//
// Launch geometry (all three grid-sample bodies).  A grid element's output
// pixels form a [ph, pw] grid cut into tiles; blockIdx.x is the tile and
// blockIdx.y the grid element bg (a loop over bg past 65535), so
// bg / img_tile is taken once a block and the 64-bit base pointers are
// formed once a grid element.  Offsets within one image and one grid
// element are 32-bit (the entry points refuse shapes where they would not
// fit): no thread divides in 64 bits.  Blocks are issued x-fastest, so one
// image is swept before the next and its lines stay in L2 for the
// neighbouring tiles.
//
// Forward: how a warp's lanes map onto pixels decides how many cache lines
// one gather instruction touches, and that depends on C.  At C <= 2 each
// lane takes a run of 4 consecutive pixels of a row: one 16-byte streaming
// load of fx and of fy (__ldcs: read once) and 16-byte evict-first output
// stores (__stcs), so the output does not push the sampled image's lines
// out of L2; at C >= 3, where a run's 4 * C corner floats would spread one
// gather instruction over a dozen lines, each lane takes one pixel and a
// warp 32 consecutive pixels of a row.  Either way a thread takes pixels of
// two row steps, so 8 (C <= 2) or 2 pixels' corner gathers (__ldg) are in
// flight a thread.  Rows that are not aligned to the runs (pw % 4 != 0)
// take scalar accesses.  The plane layout at C >= 3 has a kernel of its own
// (grid_sample_fwd_walk_kernel, below).
//
// Backward: a block owns a tile of TILE_W x TILE_RS * BWD_PX output
// pixels, one column a lane, so a warp reads coordinates and cotangent in
// coalesced rows and the shared-memory atomics of neighbouring lanes hit
// neighbouring banks.  The fused kernel also scatters four weighted
// cotangents a pixel and channel into d_img; as global atomics (the first
// port: 78.6M of them at the depth warps) neighbouring threads serialise
// on the same words in L2's atomic units.  So, as the TPU kernel summed a
// band of rows in VMEM and wrote it back once, the block reduces its
// tile's clipped corner indices to a bounding box (warp reductions, then
// shared memory) and, when the box's floats fit BOX_FLOATS, accumulates
// into the box in shared memory, then adds the box's non-zero entries to
// d_img with coalesced global atomics (neighbouring tiles' boxes
// overlap).  A tile whose box does not fit (large or scattered
// displacements) takes per-pixel global atomics, decided per block by the
// data and counted in a device counter that the caller reads on request.
// sm_90 has no shared-memory f32 add: atomicAdd there is a compare-and-swap
// loop (ATOMS.CAST.SPIN), which with the flush is most of what the box
// costs beyond the coordinate gradients; 16-byte atomics in the flush and
// the image's box staged in shared memory for the gathers were slower.
//
// Channel planes: the TPU's plane layout existed to share its one-hot mask
// builds across channels; a gather has no masks to share.  On the card the
// two layouts differ only in where a corner's C values sit: C consecutive
// floats (interleaved) or C floats a plane apart (planes), so each corner
// read touches C sectors instead of one, and the d_img box is C planes of
// the box.  The same kernels serve both, with the layout a template
// parameter, except the forward at C >= 3, whose plane kernel walks the
// grid elements of one image; the output and the cotangent stay [Bg, P, C]
// in both.
//
// Atomics: the fused backward accumulates d_img (in shared memory, then in
// d_img) and the splat accumulates occupancy with f32 atomicAdd.  The
// order in which the additions land changes from run to run, so both
// results vary in their last bits between runs; nothing else here depends
// on the order.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// the forward's block for C channels: TPR threads a tile row, each taking a
// run of V consecutive pixels (16-byte coordinate loads and output stores
// with V = 4), for R row steps: a tile of TW = TPR * V columns and RS * R
// rows, RS = THREADS / TPR
template <int C>
struct FwdTile {
  static constexpr int V = C <= 2 ? 4 : 1;
  static constexpr int TPR = C <= 2 ? 16 : 32;
  static constexpr int R = 2;
  static constexpr int TW = TPR * V;
  static constexpr int RS = THREADS / TPR;
};
// the backward's block: TILE_W columns (one a lane) and BWD_PX pixels a
// thread, TILE_RS rows apart, so TILE_RS * BWD_PX rows
// (kernels/warp_matmul.py:BWD_TILE mirrors it)
constexpr int TILE_W = 32;
constexpr int TILE_RS = THREADS / TILE_W;
constexpr int BWD_PX = 4;
// the fused backward's d_img box: 32 KB of shared memory a block
// (kernels/warp_matmul.py:BOX_FLOATS mirrors it)
constexpr int BOX_FLOATS = 8192;

// what the kernels know of one launch
struct Shape {
  int p, pw, ph;      // output pixels of a grid element: ph rows of pw
  int h, w, plane;    // image rows, columns and floats (h * w * C)
  int img_tile, nbg;  // grid elements an image, grid elements
  int tiles_x;        // tiles across pw
  bool zeros;         // zeros padding (else border)
  bool vec;           // forward: vector access to the rows of fx, fy and out
};

// offset of pixel (y, x), channel c of one image [H, W, C] or [C, H, W]
template <int C, bool PLANES>
__device__ __forceinline__ int pix(int y, int x, int c, int h, int w) {
  return PLANES ? (c * h + y) * w + x : (y * w + x) * C + c;
}

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

// the bilinear sample of one pixel into o[0..C)
template <int C, bool PLANES>
__device__ __forceinline__ void sample(const float* __restrict__ im, float fx, float fy,
                                       const Shape& s, float* o) {
  const Axis ax = axis_corners(fx, s.w, s.zeros);
  const Axis ay = axis_corners(fy, s.h, s.zeros);
  const float w00 = ay.w0 * ax.w0, w01 = ay.w0 * ax.w1;
  const float w10 = ay.w1 * ax.w0, w11 = ay.w1 * ax.w1;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float v00 = __ldg(im + pix<C, PLANES>(ay.i0, ax.i0, c, s.h, s.w));
    const float v01 = __ldg(im + pix<C, PLANES>(ay.i0, ax.i1, c, s.h, s.w));
    const float v10 = __ldg(im + pix<C, PLANES>(ay.i1, ax.i0, c, s.h, s.w));
    const float v11 = __ldg(im + pix<C, PLANES>(ay.i1, ax.i1, c, s.h, s.w));
    // the plain version's corner order: (y0, x0), (y0, x1), (y1, x0), (y1, x1)
    o[c] = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
  }
}

// the offsets q[j] within a grid element's [ph, pw] grid of a backward
// thread's BWD_PX pixels (-1 past the grid's edge): pixel j sits in column
// threadIdx.x % TILE_W and row threadIdx.x / TILE_W + j * TILE_RS of the
// block's tile, so a warp's lanes take consecutive pixels of a row
__device__ __forceinline__ void tile_pixels(const Shape& s, int (&q)[BWD_PX]) {
  const int ty = blockIdx.x / s.tiles_x, tx = blockIdx.x - ty * s.tiles_x;
  const int col = tx * TILE_W + threadIdx.x % TILE_W;
  const int row0 = ty * TILE_RS * BWD_PX + threadIdx.x / TILE_W;
#pragma unroll
  for (int j = 0; j < BWD_PX; ++j) {
    const int r = row0 + j * TILE_RS;
    q[j] = r < s.ph && col < s.pw ? r * s.pw + col : -1;
  }
}

// an output value, written once and not read here again: evict first
__device__ __forceinline__ void store_out(float* p, float v) { __stcs(p, v); }

// N consecutive floats from (to) p, 16 or 8 bytes at a time where N allows;
// p is aligned to the access
template <int N>
__device__ __forceinline__ void load_run(const float* p, float* v) {
  if (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(p + i));
      v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
    }
  } else if (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = __ldcs(reinterpret_cast<const float2*>(p + i));
      v[i] = t.x, v[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __ldcs(p + i);
  }
}

template <int N>
__device__ __forceinline__ void store_run(float* p, const float* v) {
  if (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i), make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  } else if (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      __stcs(reinterpret_cast<float2*>(p + i), make_float2(v[i], v[i + 1]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) store_out(p + i, v[i]);
  }
}

template <int C, bool PLANES>
__global__ void __launch_bounds__(THREADS)
grid_sample_fwd_kernel(const float* __restrict__ img, const float* __restrict__ fx,
                       const float* __restrict__ fy, float* __restrict__ out, Shape s) {
  using T = FwdTile<C>;
  // this thread's runs: n[j] <= T::V pixels from q[j], row step j
  const int ty = blockIdx.x / s.tiles_x, tx = blockIdx.x - ty * s.tiles_x;
  const int col = tx * T::TW + (threadIdx.x % T::TPR) * T::V;
  const int row0 = ty * T::RS * T::R + threadIdx.x / T::TPR;
  int q[T::R], n[T::R];
#pragma unroll
  for (int j = 0; j < T::R; ++j) {
    const int r = row0 + j * T::RS;
    n[j] = r < s.ph ? min(T::V, s.pw - col) : 0;
    q[j] = r * s.pw + col;
  }
  for (int bg = blockIdx.y; bg < s.nbg; bg += gridDim.y) {
    const float* im = img + static_cast<size_t>(bg / s.img_tile) * s.plane;
    const size_t row = static_cast<size_t>(bg) * s.p;
    float* o = out + row * C;
    if (s.vec) {
      // every coordinate first, then every gather, so all are in flight
      float xs[T::R][T::V], ys[T::R][T::V];
#pragma unroll
      for (int j = 0; j < T::R; ++j) {
        if (n[j] <= 0) continue;
        load_run<T::V>(fx + row + q[j], xs[j]);
        load_run<T::V>(fy + row + q[j], ys[j]);
      }
      float res[T::R][T::V * C];
#pragma unroll
      for (int j = 0; j < T::R; ++j) {
        if (n[j] <= 0) continue;
#pragma unroll
        for (int k = 0; k < T::V; ++k)
          sample<C, PLANES>(im, xs[j][k], ys[j][k], s, res[j] + k * C);
      }
#pragma unroll
      for (int j = 0; j < T::R; ++j)
        if (n[j] > 0) store_run<T::V * C>(o + q[j] * C, res[j]);
    } else {  // rows not aligned to the vector access: one pixel at a time
#pragma unroll
      for (int j = 0; j < T::R; ++j) {
        for (int k = 0; k < n[j]; ++k) {
          float res[C];
          sample<C, PLANES>(im, __ldcs(fx + row + q[j] + k), __ldcs(fy + row + q[j] + k), s, res);
#pragma unroll
          for (int c = 0; c < C; ++c) store_out(o + (q[j] + k) * C + c, res[c]);
        }
      }
    }
  }
}

// The plane forward at C >= 3 (the ENDODAV_WARP_CP route at colour
// synthesis) gathers each corner's C values from C planes, C sectors where
// the interleaved layout reads one.  Its block takes the tile of
// FwdTile<C> (one pixel a lane, 32 x 16 pixels) for each of the img_tile
// grid elements that sample one image in turn (blockIdx.y the image), so
// the grids' corners, which fall on the same lines of the planes, meet in
// L1.
template <int C>
__global__ void __launch_bounds__(THREADS)
grid_sample_fwd_walk_kernel(const float* __restrict__ img, const float* __restrict__ fx,
                            const float* __restrict__ fy, float* __restrict__ out, Shape s) {
  using T = FwdTile<C>;
  static_assert(T::V == 1 && T::TPR == 32, "one pixel a lane");
  const int ty = blockIdx.x / s.tiles_x, tx = blockIdx.x - ty * s.tiles_x;
  const int col = tx * T::TW + threadIdx.x % 32;
  const int row0 = ty * T::RS * T::R + threadIdx.x / 32;
  const int nimg = s.nbg / s.img_tile;
  for (int bi = blockIdx.y; bi < nimg; bi += gridDim.y) {
    const float* im = img + static_cast<size_t>(bi) * s.plane;
    for (int bg = bi * s.img_tile; bg < (bi + 1) * s.img_tile; ++bg) {
      // every coordinate first, then every gather, so all are in flight
      const size_t row = static_cast<size_t>(bg) * s.p;
      float xs[T::R], ys[T::R];
#pragma unroll
      for (int j = 0; j < T::R; ++j) {
        const int r = row0 + j * T::RS;
        const bool ok = r < s.ph && col < s.pw;
        xs[j] = ok ? __ldcs(fx + row + r * s.pw + col) : 0.f;
        ys[j] = ok ? __ldcs(fy + row + r * s.pw + col) : 0.f;
      }
      float res[T::R][C];
#pragma unroll
      for (int j = 0; j < T::R; ++j) sample<C, true>(im, xs[j], ys[j], s, res[j]);
#pragma unroll
      for (int j = 0; j < T::R; ++j) {
        const int r = row0 + j * T::RS;
        if (r >= s.ph || col >= s.pw) continue;
#pragma unroll
        for (int c = 0; c < C; ++c) store_out(out + (row + r * s.pw + col) * C + c, res[j][c]);
      }
    }
  }
}

// lo[a] = min and hi[a] = max of the block's values for axes a = 0, 1, in
// every thread; part and shared are scratch in shared memory
__device__ __forceinline__ void block_min_max(int lo[2], int hi[2], int (*part)[WARPS],
                                              int* shared) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    lo[a] = __reduce_min_sync(0xffffffffu, lo[a]);
    hi[a] = __reduce_max_sync(0xffffffffu, hi[a]);
    if (lane == 0) {
      part[a][warp] = lo[a];
      part[2 + a][warp] = hi[a];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int l = __reduce_min_sync(0xffffffffu, lane < WARPS ? part[a][lane] : INT_MAX);
      const int u = __reduce_max_sync(0xffffffffu, lane < WARPS ? part[2 + a][lane] : INT_MIN);
      if (lane == 0) {
        shared[a] = l;
        shared[2 + a] = u;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    lo[a] = shared[a];
    hi[a] = shared[2 + a];
  }
}

// the offset in one image of entry i of its box [bh, bw] at (y0, x0): a box
// row is one run of bw * C floats, or with PLANES C runs of bw floats a
// plane apart
template <int C, bool PLANES>
__device__ __forceinline__ int box_to_image(int i, int x0, int y0, int bw, int bh,
                                            const Shape& s) {
  if (PLANES) {
    const int cy = i / bw, lx = i - cy * bw;
    const int c = cy / bh, ly = cy - c * bh;
    return (c * s.h + y0 + ly) * s.w + x0 + lx;
  }
  const int ly = i / (bw * C);
  return ((y0 + ly) * s.w + x0) * C + (i - ly * bw * C);
}

// six blocks an SM at C = 1 (40 registers), four above (64, where 40
// would spill more)
template <int C, bool IMG_GRAD, bool PLANES>
__global__ void __launch_bounds__(THREADS, C == 1 ? 6 : 4)
grid_sample_bwd_kernel(const float* __restrict__ img, const float* __restrict__ fx,
                       const float* __restrict__ fy, const float* __restrict__ g,
                       float* __restrict__ dfx, float* __restrict__ dfy, float* __restrict__ dimg,
                       unsigned* __restrict__ global_tiles, Shape s) {
  extern __shared__ float acc[];  // the d_img box (IMG_GRAD)
  __shared__ int part[4][WARPS];
  __shared__ int bounds[4];
  int qs[BWD_PX];
  tile_pixels(s, qs);
  for (int bg = blockIdx.y; bg < s.nbg; bg += gridDim.y) {
    const float* im = img + static_cast<size_t>(bg / s.img_tile) * s.plane;
    const size_t row = static_cast<size_t>(bg) * s.p;
    const float* gr = g + row * C;
    float fxs[BWD_PX], fys[BWD_PX];
    bool ok[BWD_PX];
#pragma unroll
    for (int j = 0; j < BWD_PX; ++j) {
      ok[j] = qs[j] >= 0;
      fxs[j] = ok[j] ? __ldcs(fx + row + qs[j]) : 0.f;
      fys[j] = ok[j] ? __ldcs(fy + row + qs[j]) : 0.f;
    }
    // the tile's box of clipped corners [y0, y0 + bh) x [x0, x0 + bw), and
    // whether its floats fit the shared-memory budget
    bool fits = false;
    int x0 = 0, y0 = 0, bw = 0, bh = 0;
    float* d = nullptr;
    if (IMG_GRAD) {
      d = dimg + static_cast<size_t>(bg) * s.plane;  // img_tile 1
      int lo[2] = {INT_MAX, INT_MAX}, hi[2] = {INT_MIN, INT_MIN};
#pragma unroll
      for (int j = 0; j < BWD_PX; ++j) {
        if (!ok[j]) continue;
        const Axis ax = axis_corners(fxs[j], s.w, s.zeros);
        const Axis ay = axis_corners(fys[j], s.h, s.zeros);
        lo[0] = min(lo[0], ax.i0);
        hi[0] = max(hi[0], ax.i1);
        lo[1] = min(lo[1], ay.i0);
        hi[1] = max(hi[1], ay.i1);
      }
      block_min_max(lo, hi, part, bounds);
      x0 = lo[0];
      y0 = lo[1];
      bw = hi[0] - lo[0] + 1;
      bh = hi[1] - lo[1] + 1;
      fits = bw * bh * C <= BOX_FLOATS;  // bw <= w and bh <= h: no overflow
      if (fits) {
        for (int i = threadIdx.x; i < bw * bh * C; i += THREADS) acc[i] = 0.f;
        __syncthreads();
      }
    }
#pragma unroll
    for (int j = 0; j < BWD_PX; ++j) {
      if (!ok[j]) continue;
      const int q = qs[j];
      const Axis ax = axis_corners(fxs[j], s.w, s.zeros);
      const Axis ay = axis_corners(fys[j], s.h, s.zeros);
      // gradients of the four (masked) lerp weights, as the TPU kernels'
      // dw rows (wy0, wy1, wx0, wx1)
      float dwy0 = 0.f, dwy1 = 0.f, dwx0 = 0.f, dwx1 = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o00 = pix<C, PLANES>(ay.i0, ax.i0, c, s.h, s.w);
        const int o01 = pix<C, PLANES>(ay.i0, ax.i1, c, s.h, s.w);
        const int o10 = pix<C, PLANES>(ay.i1, ax.i0, c, s.h, s.w);
        const int o11 = pix<C, PLANES>(ay.i1, ax.i1, c, s.h, s.w);
        const float gc = __ldcs(gr + q * C + c);
        const float v00 = __ldg(im + o00), v01 = __ldg(im + o01);
        const float v10 = __ldg(im + o10), v11 = __ldg(im + o11);
        dwy0 += gc * (ax.w0 * v00 + ax.w1 * v01);
        dwy1 += gc * (ax.w0 * v10 + ax.w1 * v11);
        dwx0 += gc * (ay.w0 * v00 + ay.w1 * v10);
        dwx1 += gc * (ay.w0 * v01 + ay.w1 * v11);
        if (IMG_GRAD) {
          const float a00 = gc * ay.w0 * ax.w0, a01 = gc * ay.w0 * ax.w1;
          const float a10 = gc * ay.w1 * ax.w0, a11 = gc * ay.w1 * ax.w1;
          if (fits) {
            // the same corners in the box [bh, bw] (C planes of it with PLANES)
            const int y = ay.i0 - y0, y1 = ay.i1 - y0, x = ax.i0 - x0, x1 = ax.i1 - x0;
            if (a00 != 0.f) atomicAdd(acc + pix<C, PLANES>(y, x, c, bh, bw), a00);
            if (a01 != 0.f) atomicAdd(acc + pix<C, PLANES>(y, x1, c, bh, bw), a01);
            if (a10 != 0.f) atomicAdd(acc + pix<C, PLANES>(y1, x, c, bh, bw), a10);
            if (a11 != 0.f) atomicAdd(acc + pix<C, PLANES>(y1, x1, c, bh, bw), a11);
          } else {
            if (a00 != 0.f) atomicAdd(d + o00, a00);
            if (a01 != 0.f) atomicAdd(d + o01, a01);
            if (a10 != 0.f) atomicAdd(d + o10, a10);
            if (a11 != 0.f) atomicAdd(d + o11, a11);
          }
        }
      }
      // _mm_bwd_epilogue: w1 = frac(f) * v1, w0 = (1 - frac(f)) * v0, so
      // d_f = d_w1 * v1 - d_w0 * v0 (v == 1 in border mode)
      store_out(dfx + row + q, dwx1 * ax.v1 - dwx0 * ax.v0);
      store_out(dfy + row + q, dwy1 * ay.v1 - dwy0 * ay.v0);
    }
    if (IMG_GRAD) {
      if (fits) {
        // the box's non-zero entries into d_img, consecutive threads on
        // consecutive floats of a box row
        __syncthreads();
        for (int i = threadIdx.x; i < bw * bh * C; i += THREADS) {
          const float v = acc[i];
          if (v != 0.f) atomicAdd(d + box_to_image<C, PLANES>(i, x0, y0, bw, bh, s), v);
        }
      } else if (threadIdx.x == 0 && global_tiles != nullptr) {
        atomicAdd(global_tiles, 1u);
      }
      __syncthreads();  // acc and bounds serve the next grid element
    }
  }
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

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// p is aligned to the widest access (16, 8 or 4 bytes) of runs of n floats
bool aligned(const void* p, int n) {
  const int bytes = n % 4 == 0 ? 16 : n % 2 == 0 ? 8 : 4;
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

Shape make_shape(int bg, int p, int pw, int h, int w, int c, int img_tile, bool zeros) {
  Shape s;
  s.p = p;
  s.pw = pw;
  s.ph = p / pw;
  s.h = h;
  s.w = w;
  s.plane = h * w * c;
  s.img_tile = img_tile;
  s.nbg = bg;
  s.tiles_x = cdiv(pw, TILE_W);
  s.zeros = zeros;
  s.vec = false;
  return s;
}

// tiles of tile_h rows on x (at most 2^31 - 1), grid elements on y (a loop
// past 65535)
dim3 grid_of(const Shape& s, int tile_h) {
  return dim3(static_cast<unsigned>(static_cast<long long>(s.tiles_x) * cdiv(s.ph, tile_h)),
              static_cast<unsigned>(s.nbg < 65535 ? s.nbg : 65535));
}

template <int C, bool PLANES>
void launch_fwd(const float* img, const float* fx, const float* fy, float* out, Shape s,
                cudaStream_t st) {
  using T = FwdTile<C>;
  s.tiles_x = cdiv(s.pw, T::TW);
  if constexpr (PLANES && C >= 3) {  // the images on y
    const int nimg = s.nbg / s.img_tile;
    dim3 grid = grid_of(s, T::RS * T::R);
    grid.y = static_cast<unsigned>(nimg < 65535 ? nimg : 65535);
    grid_sample_fwd_walk_kernel<C><<<grid, THREADS, 0, st>>>(img, fx, fy, out, s);
  } else {
    // vector access needs rows of whole runs and aligned pointers
    s.vec = s.pw % T::V == 0 && aligned(fx, T::V) && aligned(fy, T::V) && aligned(out, T::V * C);
    grid_sample_fwd_kernel<C, PLANES><<<grid_of(s, FwdTile<C>::RS * FwdTile<C>::R), THREADS, 0,
                                        st>>>(img, fx, fy, out, s);
  }
}

template <int C>
void launch_fwd(const float* img, const float* fx, const float* fy, float* out, const Shape& s,
                bool planes, cudaStream_t st) {
  if (planes)
    launch_fwd<C, true>(img, fx, fy, out, s, st);
  else
    launch_fwd<C, false>(img, fx, fy, out, s, st);
}

template <int C, bool PLANES>
void launch_bwd(const float* img, const float* fx, const float* fy, const float* g, float* dfx,
                float* dfy, float* dimg, unsigned* global_tiles, const Shape& s,
                cudaStream_t st) {
  const dim3 grid = grid_of(s, TILE_RS * BWD_PX);
  if (dimg != nullptr) {
    grid_sample_bwd_kernel<C, true, PLANES><<<grid, THREADS, BOX_FLOATS * sizeof(float), st>>>(
        img, fx, fy, g, dfx, dfy, dimg, global_tiles, s);
  } else {
    grid_sample_bwd_kernel<C, false, PLANES><<<grid, THREADS, 0, st>>>(
        img, fx, fy, g, dfx, dfy, nullptr, nullptr, s);
  }
}

template <int C>
void launch_bwd(const float* img, const float* fx, const float* fy, const float* g, float* dfx,
                float* dfy, float* dimg, unsigned* global_tiles, const Shape& s, bool planes,
                cudaStream_t st) {
  if (planes)
    launch_bwd<C, true>(img, fx, fy, g, dfx, dfy, dimg, global_tiles, s, st);
  else
    launch_bwd<C, false>(img, fx, fy, g, dfx, dfy, dimg, global_tiles, s, st);
}

// what the kernels refuse: C outside 1..4, pixels that are not whole rows
// of pw, and offsets within an image or a grid element beyond 32 bits
bool bad_shape(int bg, int p, int pw, int h, int w, int c, int img_tile) {
  return bg < 1 || p < 1 || pw < 1 || p % pw != 0 || h < 1 || w < 1 || c < 1 || c > 4 ||
         img_tile < 1 || bg % img_tile != 0 ||
         static_cast<long long>(h) * w * c >= (1LL << 31) ||
         static_cast<long long>(p) * c >= (1LL << 31);
}

}  // namespace

// All entry points return the cudaError_t of the launch (0 on success).

// out [bg, p, c] = bilinear sample of img [bg / img_tile, h, w, c] (with
// planes, [bg / img_tile, c, h, w]) at (fx, fy) [bg, p], a grid element's
// p pixels being p / pw rows of pw
extern "C" int endodav_grid_sample_fwd(const float* img, const float* fx, const float* fy,
                                       float* out, int bg, int p, int pw, int h, int w, int c,
                                       int img_tile, int zeros, int planes, void* stream) {
  if (bad_shape(bg, p, pw, h, w, c, img_tile)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(bg, p, pw, h, w, c, img_tile, zeros != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pl = planes != 0;
  switch (c) {
    case 1: launch_fwd<1>(img, fx, fy, out, s, pl, st); break;
    case 2: launch_fwd<2>(img, fx, fy, out, s, pl, st); break;
    case 3: launch_fwd<3>(img, fx, fy, out, s, pl, st); break;
    default: launch_fwd<4>(img, fx, fy, out, s, pl, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// d_fx, d_fy [bg, p] from the cotangent g [bg, p, c]; with dimg non-null
// (the fused kernel, img_tile 1) also accumulates d_img in img's layout
// ([bg, h, w, c], or [bg, c, h, w] with planes), which the caller has
// zeroed, and adds to *global_tiles (when non-null) the number of tiles
// whose d_img box did not fit shared memory and took global atomics.
extern "C" int endodav_grid_sample_bwd(const float* img, const float* fx, const float* fy,
                                       const float* g, float* dfx, float* dfy, float* dimg,
                                       unsigned* global_tiles, int bg, int p, int pw, int h,
                                       int w, int c, int img_tile, int zeros, int planes,
                                       void* stream) {
  if (bad_shape(bg, p, pw, h, w, c, img_tile) || (dimg != nullptr && img_tile != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = make_shape(bg, p, pw, h, w, c, img_tile, zeros != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pl = planes != 0;
  switch (c) {
    case 1: launch_bwd<1>(img, fx, fy, g, dfx, dfy, dimg, global_tiles, s, pl, st); break;
    case 2: launch_bwd<2>(img, fx, fy, g, dfx, dfy, dimg, global_tiles, s, pl, st); break;
    case 3: launch_bwd<3>(img, fx, fy, g, dfx, dfy, dimg, global_tiles, s, pl, st); break;
    default: launch_bwd<4>(img, fx, fy, g, dfx, dfy, dimg, global_tiles, s, pl, st); break;
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
