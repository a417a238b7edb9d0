// Fused DPT ResidualConvUnit, for Hopper (sm_90a), on the tensor cores.
//
// Replaces: endodav_tpu/kernels/fused_rcu.py:_kernel (:80), launched by
// _fused_rcu_impl (:133, pallas_call :161) through fused_rcu (:184) from
// models/dpt.py:ResidualConvUnit (:77-87) under ENDODAV_FUSED_RCU.
//
// Computes, for x [B, H, W, C] channels-last (C <= 128, a multiple of 4)
// with SAME zero padding:
//   t   = relu(conv3x3(relu(x), w1) + b1)      zero outside the image
//   out = (conv3x3(t, w2) + b2) + x
// x, the weights and out in f32 or bf16, b1 and b2 in f32, every sum in
// f32.  In bf16 the intermediate t is rounded to bf16 before conv2 and
// conv2's output is rounded to bf16 before the skip add, as the TPU
// kernel's dtype chain (:124, :128-130).
//
// What bounds it: 2 * 2*9*C*C operations a pixel against 2*C elements read
// and written: at the vits head width C=64, 73,728 operations per 512
// bytes of f32, far above the card's ridge point: the tensor-core rate
// bounds it (f32 as 3xTF32, 165 TFLOP/s; bf16 989).
//
// Design: each convolution is an implicit GEMM on the tensor-core tile
// (tc_tile.cuh), [pixels x 9C] . [9C x C], as nine taps of [pixels x C_in]
// . [C_in x C_out].  One block of 8 warps owns an 8x16 output tile of one
// frame:
//   - the input tile with a halo of 2 (12x20 pixels, relu applied, zero
//     outside the image and in the padded channels) is loaded into shared
//     memory once, a pixel a row of CP (C padded to 16, 32, 64 or 128)
//     channels plus the tile's row padding; in f32 by cp.async, all of a
//     thread's 16-byte chunks in flight beside the first weight stages;
//   - A's rows are pixel rows of that tile shifted by the tap: ldmatrix
//     takes a row address per lane, so a tap is an address offset
//     (TapRows below) and no im2col copy is made;
//   - B is the tap's K-major [C_out][C_in] slice of the weights, which the
//     wrapper lays out once per weight as [9][CP][CP] (f32: TF32 hi and lo
//     planes, kernels/tf32x3.py) and which streams through a ring of two
//     shared-memory stages (cp.async) of KC input channels of one tap
//     (KC = 64 where it fits: each stage is two block barriers);
//   - conv1 runs over the 10x18 intermediate region (the output tile with
//     a halo of 1: 1.41x the output's pixels, 12 m-tiles of 16); its
//     accumulators stay in registers until every warp has read the input
//     tile, then its epilogue (b1, relu, zero outside the image) writes
//     the intermediate over the input tile; conv2 runs over the 8x16
//     output tile from there, and its epilogue adds b2 and the raw x;
//   - f32 sums each partial of KS k-steps' 3xTF32 passes from zero and
//     adds it to the running sum rounded to nearest, over the 9*CP
//     contraction (tc_tile.cuh's order; four k-steps a partial where the
//     A tile comes split, as tc_tile.cuh's error measurements allow).  Up
//     to C=64 the activation tile (input, then intermediate) is kept as
//     TF32 hi and lo planes, split once where it is written: each element
//     is read by nine taps of every warp column, which would otherwise
//     split it each time (tc_tile.cuh:warp_tile_planes).
// Shared memory, f32: 130,560 bytes of split tile and 69,632 of weight
// stages at C=64, 200,448 in all at C=128 (tile unsplit, KC = 32); bf16
// 52,992 at C=64 (two blocks an SM).
// Measured alternatives (PERF.md): a 16x16 tile (fewer halo pixels a
// block, one block an SM in bf16), a 2x4 warp grid, 32 channels a stage.

// The trap the TPU kernel masks (:114-124): conv2's SAME padding pads the
// *intermediate* with zeros at the image borders, but recomputing the
// intermediate's halo from zero-padded x would give relu(b1) there.  The
// intermediate is therefore set to 0 wherever its pixel lies outside the
// image, and the output pixels outside the image are not written.

#include <type_traits>

#include "tc_tile.cuh"

namespace {

using namespace endodav;

constexpr int THREADS = 256;
constexpr int STAGES = 2;
constexpr int TH = 8, TW = 16;           // output tile
constexpr int IH = TH + 4, IW = TW + 4;  // input tile, halo 2
constexpr int MH = TH + 2, MW = TW + 2;  // intermediate region, halo 1
constexpr int M1 = MH * MW, M1T = (M1 + 15) / 16;  // conv1 rows, m-tiles
constexpr int M2 = TH * TW, M2T = M2 / 16;         // conv2 rows, m-tiles

// Per dtype and padded width CP: KC input channels a weight stage; a warp
// grid of WM x WN warps over (pixels, output channels), NTW 8-column
// n-tiles and MT1 / MT2 16-row m-tiles a warp.
template <typename T, int CP> struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int PAD = TilePad<T>::value, LDC = CP + PAD;
  static constexpr int KC = F32 ? (CP == 64 ? 64 : CP >= 32 ? 32 : 16) : (CP >= 64 ? 64 : CP);
  static constexpr int LDW = KC + PAD, NKC = CP / KC, NS = 9 * NKC;
  static constexpr int KS = KC % 32 == 0 ? 4 : 2;  // f32 k-steps a partial (split A)
  static constexpr int PLANES = F32 ? 2 : 1;
  static constexpr int WM = CP >= 64 ? 4 : 8, WN = 8 / WM, NTW = CP / 8 / WN;
  static constexpr int MT1 = (M1T + WM - 1) / WM, MT2 = M2T / WM;
  // f32 up to C=64 keeps the activation tile split, as TF32 hi and lo
  // planes (each element split once, not by every warp at each of its
  // nine taps); at C=128 the two planes do not fit beside the weight ring
  static constexpr bool APLANES = F32 && CP <= 64;
  static constexpr int ACT = IH * IW * LDC;  // elements of an activation plane
  static constexpr int PLANE = CP * LDW, STAGE = PLANES * PLANE;
  static constexpr size_t BYTES = (size_t)((APLANES ? 2 : 1) * ACT + STAGES * STAGE) * sizeof(T);
  // f32 (A of two k-steps beside the accumulators) and bf16 at C=128 need
  // more than the 128 registers a thread of two blocks an SM
  static constexpr int MIN_BLOCKS = !F32 && CP <= 64 ? 2 : 1;
  static_assert(NTW % 2 == 0 && KC % 16 == 0 && MT2 * WM == M2T, "tile shapes");
};

// A rows of one tap: row r of the warp's m-tiles is pixel p = m0 + r of a
// region RW pixels wide (clamped to its last pixel `last`: the rows that
// pad the region to whole m-tiles recompute it and are never stored), read
// from a source tile SW pixels wide, shifted by the tap and the weight
// stage's first channel (`shift`).
template <int RW, int SW> struct TapRows {
  int ld, last, m0, shift;
  __device__ __forceinline__ int at(int row, int col) const {
    const int p = min(m0 + row, last);
    return ((p / RW) * SW + p % RW) * ld + shift + col;
  }
};

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

// f32: relu of the 4 channels at p, in place, or (lo given) split into
// TF32 hi in place and lo at lo
__device__ __forceinline__ void relu4_inplace(float* p, float* lo) {
  float4 v = *reinterpret_cast<const float4*>(p);
  v.x = fmaxf(v.x, 0.f);
  v.y = fmaxf(v.y, 0.f);
  v.z = fmaxf(v.z, 0.f);
  v.w = fmaxf(v.w, 0.f);
  if (lo == nullptr) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  uint32_t h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// bf16: relu(x) of 4 channels into shared memory, or zeros (x's pixels are
// 8-byte aligned only, below cp.async's 16 bytes when C % 8 != 0)
__device__ __forceinline__ void relu4(__nv_bfloat16* dst, const __nv_bfloat16* src, bool valid) {
  float2 a = make_float2(0.f, 0.f), b = a;
  if (valid) {
    a = load2(src);
    b = load2(src + 2);
  }
  store2(dst, fmaxf(a.x, 0.f), fmaxf(a.y, 0.f));
  store2(dst + 2, fmaxf(b.x, 0.f), fmaxf(b.y, 0.f));
}

// C padded to the kernel's widths: 16, 32, 64 or 128
__host__ __device__ inline int rcu_padded_width(int c) {
  return c <= 16 ? 16 : c <= 32 ? 32 : c <= 64 ? 64 : 128;
}

// The NS weight steps of one convolution into acc: rows m0.. of a region
// RW pixels wide (its last pixel `last`), read from the activation tile SW
// pixels wide; step s0 + r is the ring's, whose loads `issue` starts two
// steps ahead.
template <typename T, int CP, int RW, int SW, int MT, int NT, typename Issue>
__device__ __forceinline__ void conv_steps(float (&acc)[MT][NT][4], const T* act,
                                           const T* stages, int s0, int m0, int last, int n0,
                                           Issue& issue) {
  using G = Cfg<T, CP>;
  constexpr int NS = G::NS, KC = G::KC, LDW = G::LDW;
#pragma unroll 1
  for (int r = 0; r < NS; ++r) {
    const int s = s0 + r;
    cp_async_wait<1>();  // step s has landed (s + 1 may be in flight)
    __syncthreads();
    const int tap = r / G::NKC, kc0 = (r % G::NKC) * KC;
    const TapRows<RW, SW> la{G::LDC, last, m0, ((tap / 3) * SW + tap % 3) * G::LDC + kc0};
    const T* st = stages + (s % STAGES) * G::STAGE;
    const T* lo = G::F32 ? st + G::PLANE : st;
    if constexpr (G::APLANES)
      warp_tile_planes<G::KS>(acc, act, act + G::ACT, la, st + n0 * LDW, lo + n0 * LDW,
                              Padded{LDW}, KC);
    else
      warp_tile(acc, act, la, st + n0 * LDW, lo + n0 * LDW, Padded{LDW}, KC);
    __syncthreads();  // every warp is done with this stage
    if (s + STAGES < 2 * NS) issue(s + STAGES);
    cp_async_commit();
  }
}

template <typename T, int CP>
__global__ void __launch_bounds__(THREADS, Cfg<T, CP>::MIN_BLOCKS)
rcu_kernel(const T* __restrict__ x, const T* __restrict__ w1h, const T* __restrict__ w1l,
           const float* __restrict__ b1, const T* __restrict__ w2h, const T* __restrict__ w2l,
           const float* __restrict__ b2, T* __restrict__ out, int h, int w, int c, int tiles_h,
           int tiles_w) {
  using G = Cfg<T, CP>;
  constexpr int LDC = G::LDC, LDW = G::LDW, KC = G::KC, NKC = G::NKC, NS = G::NS;
  constexpr int NTW = G::NTW;
  extern __shared__ float4 smem4[];
  T* act = reinterpret_cast<T*>(smem4);  // input tile, then the intermediate
  T* stages = act + (G::APLANES ? 2 : 1) * G::ACT;

  const int tx = blockIdx.x % tiles_w;
  const int ty = (blockIdx.x / tiles_w) % tiles_h;
  const long long frame = blockIdx.x / (tiles_w * tiles_h);
  const int oy0 = ty * TH, ox0 = tx * TW;
  const long long fbase = frame * h * w * c;
  const T* xf = x + fbase;
  T* of = out + fbase;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / G::WN, wn = warp % G::WN;
  const int n0 = wn * NTW * 8;

  // weight step s: conv s / NS, tap and KC-channel chunk of s % NS
  auto issue = [&](int s) {
    const int r = s % NS, tap = r / NKC, kc0 = (r % NKC) * KC;
    const long long off = (long long)tap * CP * CP + kc0;
    T* dst = stages + (s % STAGES) * G::STAGE;
    load_tile<THREADS>(dst, LDW, (s < NS ? w1h : w2h) + off, CP, CP, KC, CP);
    if constexpr (G::F32)
      load_tile<THREADS>(dst + G::PLANE, LDW, (s < NS ? w1l : w2l) + off, CP, CP, KC, CP);
  };
  // the input tile: relu(x), zero outside the image and past c (f32: by
  // cp.async, all of a thread's 16-byte chunks in flight at once beside the
  // first weight stages, then relu and the split in place by the thread
  // that copied them)
  constexpr int CHUNKS = IH * IW * (CP / 4);
  auto chunk = [&](int i, int& p, int& ch, const T*& src) {
    p = i / (CP / 4);
    ch = (i % (CP / 4)) * 4;
    const int yy = oy0 - 2 + p / IW, xx = ox0 - 2 + p % IW;
    const bool ok = ch < c && inside(yy, xx, h, w);
    src = ok ? xf + ((long long)yy * w + xx) * c + ch : nullptr;
  };
  if constexpr (G::F32) {
    for (int i = threadIdx.x; i < CHUNKS; i += THREADS) {
      int p, ch;
      const T* src;
      chunk(i, p, ch, src);
      cp_async16(act + p * LDC + ch, src ? src : xf, src != nullptr);
    }
    cp_async_commit();
  }
  issue(0);
  cp_async_commit();
  issue(1);
  cp_async_commit();
  if constexpr (G::F32) {
    cp_async_wait<2>();  // this thread's chunks of the input tile have landed
    for (int i = threadIdx.x; i < CHUNKS; i += THREADS) {
      const int p = i / (CP / 4), ch = (i % (CP / 4)) * 4;
      relu4_inplace(act + p * LDC + ch, G::APLANES ? act + G::ACT + p * LDC + ch : nullptr);
    }
  } else {
    for (int i = threadIdx.x; i < CHUNKS; i += THREADS) {
      int p, ch;
      const T* src;
      chunk(i, p, ch, src);
      relu4(act + p * LDC + ch, src ? src : xf, src != nullptr);
    }
  }

  // conv1 over the intermediate region, from the input tile (its first
  // step's barrier orders the stores above before the reads)
  float acc1[G::MT1][NTW][4];
  zero(acc1);
  conv_steps<T, CP, MW, IW>(acc1, act, stages, 0, wm * G::MT1 * 16, M1 - 1, n0, issue);
  // conv1's epilogue: b1, relu, rounded to T, zero outside the image; every
  // warp has read the input tile (the last step ended on a barrier), so the
  // intermediate goes over it
#pragma unroll
  for (int mt = 0; mt < G::MT1; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = wm * G::MT1 * 16 + mt * 16 + g + 8 * hf;
        if (row >= M1) continue;
        const int n = n0 + nt * 8 + 2 * t;
        float v0 = 0.f, v1 = 0.f;
        if (n < c && inside(oy0 - 1 + row / MW, ox0 - 1 + row % MW, h, w)) {
          v0 = round_to<T>(fmaxf(acc1[mt][nt][2 * hf] + b1[n], 0.f));
          v1 = round_to<T>(fmaxf(acc1[mt][nt][2 * hf + 1] + b1[n + 1], 0.f));
        }
        if constexpr (G::APLANES) {
          uint32_t h0, l0, h1, l1;
          split_tf32(v0, h0, l0);
          split_tf32(v1, h1, l1);
          store2(act + row * LDC + n, __uint_as_float(h0), __uint_as_float(h1));
          store2(act + G::ACT + row * LDC + n, __uint_as_float(l0), __uint_as_float(l1));
        } else {
          store2(act + row * LDC + n, v0, v1);
        }
      }

  // conv2 over the output tile, from the intermediate (its first step's
  // barrier orders the epilogue's stores before the reads)
  float acc2[G::MT2][NTW][4];
  zero(acc2);
  conv_steps<T, CP, TW, MW>(acc2, act, stages, NS, wm * G::MT2 * 16, M2 - 1, n0, issue);
#pragma unroll
  for (int mt = 0; mt < G::MT2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = wm * G::MT2 * 16 + mt * 16 + g + 8 * hf;
        const int yy = oy0 + row / TW, xx = ox0 + row % TW, n = n0 + nt * 8 + 2 * t;
        if (n >= c || !inside(yy, xx, h, w)) continue;
        const long long o = ((long long)yy * w + xx) * c + n;
        const float2 skip = load2(xf + o);
        const float y0 = round_to<T>(acc2[mt][nt][2 * hf] + b2[n]);
        const float y1 = round_to<T>(acc2[mt][nt][2 * hf + 1] + b2[n + 1]);
        store2(of + o, y0 + skip.x, y1 + skip.y);
      }
}

template <typename T, int CP>
int launch(const void* x, const void* w1h, const void* w1l, const float* b1, const void* w2h,
           const void* w2l, const float* b2, void* out, int b, int h, int w, int c,
           cudaStream_t stream) {
  using G = Cfg<T, CP>;
  const cudaError_t err = cudaFuncSetAttribute(
      rcu_kernel<T, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (h + TH - 1) / TH, tiles_w = (w + TW - 1) / TW;
  const long long blocks = (long long)b * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rcu_kernel<T, CP><<<static_cast<unsigned>(blocks), THREADS, G::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1h), static_cast<const T*>(w1l), b1,
      static_cast<const T*>(w2h), static_cast<const T*>(w2l), b2, static_cast<T*>(out), h, w,
      c, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const void* x, const void* w1h, const void* w1l, const float* b1,
                 const void* w2h, const void* w2l, const float* b2, void* out, int b, int h,
                 int w, int c, cudaStream_t s) {
  const int cp = rcu_padded_width(c);
  if (cp == 16) return launch<T, 16>(x, w1h, w1l, b1, w2h, w2l, b2, out, b, h, w, c, s);
  if (cp == 32) return launch<T, 32>(x, w1h, w1l, b1, w2h, w2l, b2, out, b, h, w, c, s);
  if (cp == 64) return launch<T, 64>(x, w1h, w1l, b1, w2h, w2l, b2, out, b, h, w, c, s);
  return launch<T, 128>(x, w1h, w1l, b1, w2h, w2l, b2, out, b, h, w, c, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  x and out
// [b, h, w, c], x 16-byte aligned; the weights as [9][CP][CP] taps
// (tap, output channel, input channel; CP = rcu_padded_width(c), zero
// past c) in x's type: hi and lo planes for f32, w1l and w2l ignored for
// bf16; b1, b2 [c] f32.  The wrapper (kernels/fused_rcu.py) mirrors the
// padding.
extern "C" int endodav_fused_rcu(int dtype, const void* x, const void* w1h, const void* w1l,
                                 const void* b1, const void* w2h, const void* w2l,
                                 const void* b2, void* out, int b, int h, int w, int c,
                                 void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 4 || c > 128 || c % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_width<float>(x, w1h, w1l, fb1, w2h, w2l, fb2, out, b, h, w, c, s);
  if (dtype == kBFloat16)
    return launch_width<__nv_bfloat16>(x, w1h, w1l, fb1, w2h, w2l, fb2, out, b, h, w, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
