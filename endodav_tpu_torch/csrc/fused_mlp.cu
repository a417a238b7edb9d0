// Fused transformer MLP of the ViT blocks, for Hopper (sm_90a).
//
// Replaces: endodav_tpu/kernels/fused_mlp.py:_kernel (:73), launched by
// fused_mlp (:83, pallas_call :100) from models/vit.py:Mlp (:90-102).
//
// Computes, for x [R, C] and the weights as torch's nn.Linear keeps them
// (K-major: W1 [H, C], W2 [C2, H]; the wrapper's own arguments are in the
// JAX layout [in, out]):
//   h   = gelu(x W1^T + b1)      [R, H]   (exact gelu, erff)
//   out = h W2^T + b2            [R, C2]
// with x, the weights and out in f32 or bf16, b1 and b2 in f32, h rounded
// to the input type before the second product (the TPU kernel's dtype
// chain); every sum is f32.  f32 runs as 3xTF32 (tc_tile.cuh): W1 and W2
// arrive as hi and lo planes made once by the wrapper (kernels/tf32x3.py),
// x and h are split as their fragments are built.
//
// What bounds it: 2*R*C*H + 2*R*H*C2 operations against (R*C + R*C2)
// activation bytes and the weights once: at vits (384 -> 1536 -> 384) and
// vitl (1024 -> 4096 -> 1024) widths and R = 54496 (a 32-frame 518x644
// encode batch) that is ~0.13 and ~0.91 TFLOP against ~0.1 and ~0.45 GB,
// far above the ridge point, so the tensor-core rate bounds it: in f32
// 3x the operations at 495 TFLOP/s (0.78 and 5.54 ms; 1.92 and 13.65 ms
// at the 67 TFLOP/s of SIMT f32), in bf16 989 TFLOP/s (0.13, 0.92 ms).
//
// Design.  The TPU kernel kept a 512-row tile and both weight panels in
// VMEM with the hidden [512, 4C] on chip (:83-92).  Here the hidden stays
// on chip too, in tiles: a row tile of BM rows walks the hidden dimension
// HT columns at a time; per hidden tile it computes h = gelu(x W1 + b1)
// [BM, HT] into shared memory, then adds h W2[tile] into the fc2
// accumulator [BM, C2], which lives in the registers of the block's 8
// warps for the whole walk.  So x is read from L2 once per hidden tile,
// each weight tile fetched feeds BM rows, and h never reaches device
// memory.
//   - vits (C2 = 384): a cluster of 2 CTAs shares a 128-row tile, each
//     with 192 output columns ([128, 192] f32: 96 registers a thread) and
//     a 64-column slice of each 128-column hidden tile.
//   - vitl (C2 = 1024; any C2 up to 1024 that is a multiple of 8 but 384,
//     on cl = C2/256 rounded up): [BM, C2] does not fit one SM's
//     registers, so a cluster of cl CTAs shares a 128-row tile and each
//     CTA owns 256 output columns ([128, 256]: 128 registers a thread;
//     columns past C2 get zero weights and are never stored).  Each CTA
//     computes its 32-column
//     slice of every hidden tile (HT = 32*cl) and stores it, through
//     distributed shared memory, into the h buffer of every CTA of the
//     cluster; after a cluster barrier each multiplies the whole tile by
//     its W2 columns.  fc1 is computed
//     once, h never leaves the cluster, and W1 and W2 are read once per
//     128-row tile: ~27 GB of L2 reads a vitl launch (hi and lo planes),
//     against ~109 GB for the SIMT kernel's 16-row blocks.  The barrier is
//     split: a CTA arrives when it has read the tile's h and waits only
//     before it writes the next one, after its fc1 products.
//   - vitg (C2 = 1536, a cluster of 6) and any C2 above 1024 (cl = 5..8,
//     up to Hopper's portable cluster size): the h tile [BM, 32*cl] grows
//     with the cluster, and at 128 rows in f32 it would not fit 227 KB of
//     shared memory beside the rings (cl = 6: 235 KB).  These clusters
//     take 64-row tiles (`Tall`): half the h buffer and the x stages,
//     [64, 256] accumulators (64 registers a thread), the weights read
//     once per 64 rows.  A cluster of cl CTAs holds cl SMs, one CTA an SM.
// Tiles of x, W1 and W2 reach shared memory by TMA (tma.cuh): one thread
// issues a stage's loads, which land swizzled and signal an mbarrier.  Two
// rings, one for the fc1 steps (x and W1, 128-byte rows) and one for the
// fc2 steps (W2, 64-byte rows), are kept full ahead of the schedule (the
// fc1 steps of a hidden tile, then its fc2 steps), so the next tile's x
// and W1 arrive during this tile's fc2 and W2 during fc1; the products
// never read global memory.

#include <cooperative_groups.h>

#include <type_traits>

#include "tc_tile.cuh"
#include "tma.cuh"

namespace {

using namespace endodav;
namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// BM rows a tile, NC output columns a CTA, HTC hidden columns a CTA
// computes per hidden tile; fc1 [BM, HTC] on a WM1 x WN1 warp grid, fc2
// [BM, NC] on WM2 x WN2.
template <int BM_, int NC_, int HTC_, int WM1_, int WN1_, int WM2_, int WN2_>
struct MlpConfig {
  static constexpr int BM = BM_, NC = NC_, HTC = HTC_, WN1 = WN1_, WN2 = WN2_;
  static constexpr int MT1 = BM / WM1_ / 16, NT1 = HTC / WN1_ / 8;
  static constexpr int MT2 = BM / WM2_ / 16, NT2 = NC / WN2_ / 8;
  static_assert(WM1_ * WN1_ == WARPS && WM2_ * WN2_ == WARPS, "8 warps");
  static_assert(MT1 * WM1_ * 16 == BM && NT1 * WN1_ * 8 == HTC, "fc1 warp grid");
  static_assert(MT2 * WM2_ * 16 == BM && NT2 * WN2_ * 8 == NC, "fc2 warp grid");
};
using Mid = MlpConfig<128, 192, 64, 4, 2, 2, 4>;   // C2 = 384, a cluster of 2
using Wide = MlpConfig<128, 256, 32, 4, 2, 2, 4>;  // C2 <= 256*cl, a cluster of cl <= 4
using Tall = MlpConfig<64, 256, 32, 4, 2, 2, 4>;   // the same on 64 rows, cl = 5..8
constexpr int WIDE_CL = 4, MAX_CL = 8;  // Hopper's portable cluster size

// Shared memory: the fc1 ring (S1 stages of x [BM] and W1 hi (and lo)
// [HTC] rows of 128 bytes: BK1 columns), the fc2 ring (S2 stages of W2 hi
// (and lo) [NC] rows of 64 bytes: BK2 columns), then the h buffer
// [BM][HT + pad] of T.  Deep enough that the loads in flight cover L2's
// latency.
template <typename T, typename Cfg>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int PLANES = F32 ? 2 : 1;
  static constexpr int BK1 = 128 / sizeof(T), BK2 = 64 / sizeof(T);
  static constexpr int S1 = F32 ? 3 : 4, S2 = F32 ? 2 : 3;
  static constexpr int X_BYTES = Cfg::BM * 128, W1_BYTES = Cfg::HTC * 128;
  static constexpr int FC1 = X_BYTES + PLANES * W1_BYTES;
  static constexpr int W2_BYTES = Cfg::NC * 64, FC2 = PLANES * W2_BYTES;
  static constexpr int PAD = TilePad<T>::value;
  int ht, ldh;
  __host__ __device__ explicit Layout(int cl) : ht(Cfg::HTC * cl), ldh(Cfg::HTC * cl + PAD) {}
  __host__ __device__ size_t bytes() const {
    return 1024 + (size_t)S1 * FC1 + (size_t)S2 * FC2 + (size_t)Cfg::BM * ldh * sizeof(T);
  }
};

template <typename T, typename Cfg>
__global__ void __launch_bounds__(THREADS, 1)
mlp_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw1h,
           const __grid_constant__ CUtensorMap mw1l, const __grid_constant__ CUtensorMap mw2h,
           const __grid_constant__ CUtensorMap mw2l, const float* __restrict__ b1,
           const float* __restrict__ b2, T* __restrict__ out, int rows, int c, int hdim, int c2,
           int cl) {
  using L = Layout<T, Cfg>;
  constexpr int MT1 = Cfg::MT1, NT1 = Cfg::NT1, MT2 = Cfg::MT2, NT2 = Cfg::NT2;
  constexpr int BK1 = L::BK1, BK2 = L::BK2, S1 = L::S1, S2 = L::S2;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bar1[S1], bar2[S2];
  char* ring1 = align1024(smem4);
  char* ring2 = ring1 + S1 * L::FC1;
  T* hs = reinterpret_cast<T*>(ring2 + S2 * L::FC2);
  const L lay(cl);

  const int rank = blockIdx.x % cl;  // the cluster's rank of this CTA (clusters along x)
  const int row0 = (blockIdx.x / cl) * Cfg::BM;
  const int valid = min(Cfg::BM, rows - row0);
  const int ncol0 = rank * Cfg::NC;
  const int ht = lay.ht, ldh = lay.ldh;
  const int n1 = c / BK1, n2 = ht / BK2, per_tile = n1 + n2, tiles = hdim / ht;
  const int total1 = tiles * n1, total2 = tiles * n2, total = tiles * per_tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int wm1 = warp / Cfg::WN1, wn1 = warp % Cfg::WN1;
  const int wm2 = warp / Cfg::WN2, wn2 = warp % Cfg::WN2;

  // thread 0 keeps both rings full: fc1 step i of the schedule is x and W1
  // columns (i % n1)*BK1 of hidden tile i / n1; fc2 step i is W2 columns
  // (i / n2)*ht + (i % n2)*BK2
  int issued1 = 0, issued2 = 0;
  auto fill = [&](int done1, int done2) {
    fence_proxy_async();  // the stages' earlier reads before TMA's writes
    for (; issued1 < total1 && issued1 < done1 + S1; ++issued1) {
      char* st = ring1 + (issued1 % S1) * L::FC1;
      uint64_t* bar = &bar1[issued1 % S1];
      const int j = issued1 / n1, k0 = (issued1 % n1) * BK1;
      mbar_expect_tx(bar, L::FC1);
      tma_load(st, &mx, k0, row0, bar);
      tma_load(st + L::X_BYTES, &mw1h, k0, j * ht + rank * Cfg::HTC, bar);
      if (L::F32) tma_load(st + L::X_BYTES + L::W1_BYTES, &mw1l, k0, j * ht + rank * Cfg::HTC, bar);
    }
    for (; issued2 < total2 && issued2 < done2 + S2; ++issued2) {
      char* st = ring2 + (issued2 % S2) * L::FC2;
      uint64_t* bar = &bar2[issued2 % S2];
      const int k0 = (issued2 / n2) * ht + (issued2 % n2) * BK2;
      mbar_expect_tx(bar, L::FC2);
      tma_load(st, &mw2h, k0, ncol0, bar);
      if (L::F32) tma_load(st + L::W2_BYTES, &mw2l, k0, ncol0, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < S1; ++i) mbar_init(&bar1[i], 1);
    for (int i = 0; i < S2; ++i) mbar_init(&bar2[i], 1);
    mbar_fence_init();
    fill(0, 0);
  }

  float acc1[MT1][NT1][4];
  float acc2[MT2][NT2][4];
  zero(acc2);
  if (cl > 1) cluster_arrive();  // paired with the wait before the first remote store
#pragma unroll 1
  for (int s = 0; s < total; ++s) {
    const int j = s / per_tile, r = s - j * per_tile;
    __syncthreads();  // the stages read by step s-1 are free
    if (threadIdx.x == 0 && s > 0)
      fill(j * n1 + min(r, n1), j * n2 + max(0, r - n1));
    if (r < n1) {
      const int i = j * n1 + r;
      mbar_wait(&bar1[i % S1], (i / S1) & 1);
      const T* st = reinterpret_cast<const T*>(ring1 + (i % S1) * L::FC1);
      const T* w = st + (L::X_BYTES + wn1 * NT1 * 8 * 128) / sizeof(T);
      if (r == 0) zero(acc1);
      warp_tile(acc1, st + wm1 * MT1 * 16 * BK1, Swizzled<T>{}, w, w + L::W1_BYTES / sizeof(T),
                Swizzled<T>{}, BK1);
      if (r == n1 - 1) {
        // h = gelu(fc1 + b1), rounded to T, into the h buffer of every CTA
        // of the cluster (cl == 1: the next step's __syncthreads orders the
        // stores before fc2's reads, and came after the last tile's reads)
        if (cl > 1) cluster_wait();  // every CTA has read the previous tile's h
#pragma unroll
        for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = (wm1 * MT1 + mt) * 16 + g + 8 * half;
              const int col = rank * Cfg::HTC + (wn1 * NT1 + nt) * 8 + 2 * tq;
              const float v0 =
                  round_to<T>(gelu_erf(acc1[mt][nt][2 * half] + b1[j * ht + col]));
              const float v1 =
                  round_to<T>(gelu_erf(acc1[mt][nt][2 * half + 1] + b1[j * ht + col + 1]));
              T* dst = hs + row * ldh + col;
              if (cl > 1) {
                cg::cluster_group cluster = cg::this_cluster();
                for (int d = 0; d < cl; ++d) store2(cluster.map_shared_rank(dst, d), v0, v1);
              } else {
                store2(dst, v0, v1);
              }
            }
        if (cl > 1) {
          cluster_arrive();
          cluster_wait();  // the whole tile's h is in this CTA's buffer
        }
      }
    } else {
      const int i = j * n2 + (r - n1);
      mbar_wait(&bar2[i % S2], (i / S2) & 1);
      const T* st = reinterpret_cast<const T*>(ring2 + (i % S2) * L::FC2);
      const T* w = st + wn2 * NT2 * 8 * BK2;
      warp_tile(acc2, hs + wm2 * MT2 * 16 * ldh + (r - n1) * BK2, Padded{ldh}, w,
                w + L::W2_BYTES / sizeof(T), Swizzled<T, 64>{}, BK2);
      if (r == per_tile - 1 && cl > 1) cluster_arrive();  // done reading this tile's h
    }
  }
  if (cl > 1) cluster_wait();  // no CTA leaves while the cluster still runs

#pragma unroll
  for (int mt = 0; mt < MT2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (wm2 * MT2 + mt) * 16 + g + 8 * half;
        const int col = ncol0 + (wn2 * NT2 + nt) * 8 + 2 * tq;
        if (row < valid && col < c2)
          store2(out + (long long)(row0 + row) * c2 + col, acc2[mt][nt][2 * half] + b2[col],
                 acc2[mt][nt][2 * half + 1] + b2[col + 1]);
      }
}

template <typename T, typename Cfg>
int launch(const void* x, const void* w1h, const void* w1l, const float* b1, const void* w2h,
           const void* w2l, const float* b2, void* out, int rows, int c, int hdim, int c2, int cl,
           cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const size_t smem = Layout<T, Cfg>(cl).bytes();
  CUtensorMap mx, m1h, m1l, m2h, m2l;
  int err = make_tile_map(&mx, x, F32, rows, c, c, Cfg::BM, 128);
  if (!err) err = make_tile_map(&m1h, w1h, F32, hdim, c, c, Cfg::HTC, 128);
  if (!err) err = make_tile_map(&m1l, w1l, F32, hdim, c, c, Cfg::HTC, 128);
  if (!err) err = make_tile_map(&m2h, w2h, F32, c2, hdim, hdim, Cfg::NC, 64);
  if (!err) err = make_tile_map(&m2l, w2l, F32, c2, hdim, hdim, Cfg::NC, 64);
  if (err) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mlp_kernel<T, Cfg>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((rows + Cfg::BM - 1) / Cfg::BM) * cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, mx, m1h, m1l, m2h, m2l, b1, b2, static_cast<T*>(out), rows,
                         c, hdim, c2, cl);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w1h, const void* w1l, const float* b1, const void* w2h,
             const void* w2l, const float* b2, void* out, int rows, int c, int hdim, int c2,
             cudaStream_t s) {
  if (c2 == 2 * Mid::NC) {
    if (hdim % (2 * Mid::HTC)) return static_cast<int>(cudaErrorInvalidValue);
    return launch<T, Mid>(x, w1h, w1l, b1, w2h, w2l, b2, out, rows, c, hdim, c2, 2, s);
  }
  const int cl = (c2 + Wide::NC - 1) / Wide::NC;
  if (c2 % 8 || cl < 1 || cl > MAX_CL || hdim % (Wide::HTC * cl))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cl <= WIDE_CL)
    return launch<T, Wide>(x, w1h, w1l, b1, w2h, w2l, b2, out, rows, c, hdim, c2, cl, s);
  return launch<T, Tall>(x, w1h, w1l, b1, w2h, w2l, b2, out, rows, c, hdim, c2, cl, s);
}

}  // namespace

// Widths the kernel takes (mirrored by kernels/fused_mlp.py:mlp_config):
// C a multiple of 64; C2 = 384 (2 CTAs, H a multiple of 128) or any other
// C2 up to 2048 that is a multiple of 8, on cl = ceil(C2/256) CTAs (H a
// multiple of 32*cl; 128-row tiles up to cl = 4, 64-row tiles above).  w1
// is [H, C] and w2 [C2, H]; for f32 w1h/w1l and w2h/w2l are the TF32 hi
// and lo planes (for bf16 the lo pointers are the hi ones again).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int endodav_fused_mlp(int dtype, const void* x, const void* w1h, const void* w1l,
                                 const void* b1, const void* w2h, const void* w2l,
                                 const void* b2, void* out, int rows, int c, int hdim, int c2,
                                 void* stream) {
  if (rows < 1 || c < 64 || c % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(x, w1h, w1l, fb1, w2h, w2l, fb2, out, rows, c, hdim, c2, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(x, w1h, w1l, fb1, w2h, w2l, fb2, out, rows, c, hdim, c2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
