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
// The head-grouped route replaces endodav_tpu/kernels/
// fused_temporal_block.py:_grouped_kernel (:120), launched by
// _forward_grouped (:206, pallas_call :226) for C >= 512 (vitl's C=1024
// motion modules, 8 heads of width 128): the same function in two
// launches on the tensor cores (tc_tile.cuh: f32 as 3xTF32 with the
// weights' hi and lo planes made once by the wrapper, bf16 as it is).
//
// What bounds it: per token 8*C^2 operations of the four C x C products
// against 2*C activation elements read and written, so the tensor-core
// rate: at rows=1702, T=32, C=1024 0.46 TFLOP, in f32 2.77 ms as 3xTF32
// (6.93 ms at SIMT f32's 67 TFLOP/s), in bf16 0.47 ms.
//
// Why two launches: a single block cannot hold LN(x) of a row (128 KB at
// C=1024, f32), q|k|v of even one head group (96 KB) and the ring of
// weight tiles that the tensor cores need; keeping all of it in one block
// pinned the SIMT kernel at one 32-token row a block, re-reading 16 MB of
// weights for every row.
//   (a) qkv_kernel: q|k|v [R*T, 3C] = LN(x) [Wq|Wk|Wv], a GEMM over all R*T
//       tokens in tiles of 128 tokens x 256 columns.  x, the weight
//       planes and pe arrive by TMA (tma.cuh) in 64-byte-wide stages.
//       The A operand's prologue applies LayerNorm (eps 1e-5, two-pass
//       variance, as layer_norm_pe), gamma, beta and pe to each landed x
//       stage in shared memory and rounds it to T, one stage ahead of the
//       products.  Each token's mean and rstd come from a first pass over
//       the tile's tokens, shared by a cluster of the column tiles of a
//       token tile (each block computes every cl-th token's).  q|k|v are
//       written in f32, as JAX keeps them (preferred_element_type=f32),
//       to a scratch the wrapper allocates (669 MB at rows=1702: ~0.4 ms
//       of round trip at 3.35 TB/s).
//   (b) out_kernel: out = x + A Wo + bo for a tile of 128 tokens (4 rows
//       at T=32) x 256 columns, where the block computes its A operand
//       itself: the K loop walks the heads (dh=128 a step); per head the
//       attention softmax(q_h k_h^T * scale) v_h of the tile's rows runs
//       on the SIMT cores (1.5% of the block's operations; one warp per
//       query, one lane per key), is rounded to T as JAX does at
//       att.astype(x_ref.dtype) (:165), and multiplies Wo[h*dh:(h+1)*dh,
//       n-tile] (its planes by TMA).  The C/256 column tiles of a token
//       tile form a cluster: each computes the attention of one 32-token
//       chunk and stores it into every block's A buffer (distributed
//       shared memory), so the attention runs once and not once per
//       column tile.  One f32 accumulator sums the heads in order: the
//       group partials of grouped_reference_block differ from it only in
//       rounding, and no f32 scratch is needed.
// Tokens past the last row are zero-filled and never stored.  For T < 32
// a 32-token chunk holds floor(32/T) rows and a tile four chunks.

#include <math_constants.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "tc_tile.cuh"
#include "tma.cuh"

namespace {

using namespace endodav;
namespace cg = cooperative_groups;

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

// ---- head-grouped route (C >= 512) on the tensor cores ----

constexpr int PBM = 128, PBN = 256;  // (a) the projection: 128 tokens x 256 columns
constexpr int OBM = 128, OBN = 256;  // (b) the out-projection: 4 chunks x 256 columns
constexpr int CMAX = 1024;           // widest C whose token rows the statistics hold

// (a)'s stages, filled by TMA: the x tile [PBM] and the weight tile's hi
// (and lo) plane [PBN] in rows of 64 bytes (BK columns), and pe [32] of
// the same columns (f32, one or two 64-byte boxes); then gamma and beta
// [C] and the tokens' statistics.  Four stages or more, so that
// the A prologue can run one stage ahead of the products.
template <typename T> struct ProjLayout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int PLANES = F32 ? 2 : 1;
  static constexpr int BK = 64 / sizeof(T), STAGES = F32 ? 4 : 5;
  static constexpr int A_BYTES = PBM * 64, B_BYTES = PBN * 64;
  static constexpr int PE_BOXES = BK * 4 / 64, PE_BYTES = PE_BOXES * 32 * 64;
  static constexpr int TILE = A_BYTES + PLANES * B_BYTES + PE_BYTES;
  static constexpr size_t BYTES = 1024 + (size_t)STAGES * TILE + 2 * CMAX * 4 + PBM * 16;
};

// Mean and rstd of a token row of c <= CMAX values (two passes over the
// row held in registers, as layer_norm_pe's two passes), one warp.
template <typename T>
__device__ __forceinline__ float2 row_stats(const T* xr, int c) {
  constexpr int V = 16 / sizeof(T), U = CMAX / (32 * V);
  const int lane = threadIdx.x % 32;
  float v[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = (u * 32 + lane) * V;
    if (j < c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + j);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) v[u][i] = to_f(e[i]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if ((u * 32 + lane) * V < c)
#pragma unroll
      for (int i = 0; i < V; ++i) sum += v[u][i];
  const float mu = warp_sum(sum) / c;
  float sq = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if ((u * 32 + lane) * V < c)
#pragma unroll
      for (int i = 0; i < V; ++i) sq += (v[u][i] - mu) * (v[u][i] - mu);
  return make_float2(mu, 1.f / sqrtf(warp_sum(sq) / c + 1e-5f));
}

// q|k|v [tokens, 3C] (f32) = round_T(LN(x)*gamma + beta + pe) [Wq|Wk|Wv]:
// grid (3C/256, token tiles), so that the blocks of a token tile run
// together and read its x from L2, in clusters of cl of them (cl divides
// 3C/256) that share the tile's LayerNorm statistics: each block computes
// those of every cl-th token and stores them into all the cluster's
// blocks.  mx maps x [tokens, C], mw*h/mw*l the K-major [C_out, C_in]
// weights (hi and lo planes for f32), mpe pe [T, C].
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
qkv_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mqh,
           const __grid_constant__ CUtensorMap mkh, const __grid_constant__ CUtensorMap mvh,
           const __grid_constant__ CUtensorMap mql, const __grid_constant__ CUtensorMap mkl,
           const __grid_constant__ CUtensorMap mvl, const __grid_constant__ CUtensorMap mpe,
           const T* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, float* __restrict__ qkv, int tokens, int t, int c) {
  using L = ProjLayout<T>;
  constexpr int BK = L::BK, S = L::STAGES, MT = 4, NT = 8;  // warps 2 x 4, 64 x 64 each
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[S];
  char* stages = align1024(smem4);
  float* gb = reinterpret_cast<float*>(stages + S * L::TILE);  // gamma [c], beta [c]
  float4* rowinfo = reinterpret_cast<float4*>(gb + 2 * CMAX);  // [PBM] mu, rstd, pe row
  cg::cluster_group cluster = cg::this_cluster();

  const int row0 = blockIdx.y * PBM, valid = min(PBM, tokens - row0);
  const int n0 = blockIdx.x * PBN, which = n0 / c, wrow = n0 - which * c;
  const CUtensorMap* mh = which == 0 ? &mqh : which == 1 ? &mkh : &mvh;
  const CUtensorMap* ml = which == 0 ? &mql : which == 1 ? &mkl : &mvl;
  const T* xb = x + (long long)row0 * c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const int steps = c / BK;

  auto load = [&](int s) {
    char* st = stages + (s % S) * L::TILE;
    uint64_t* bar = &bars[s % S];
    const int k0 = s * BK;
    mbar_expect_tx(bar, L::TILE);
    tma_load(st, &mx, k0, row0, bar);
    tma_load(st + L::A_BYTES, mh, k0, wrow, bar);
    if (L::F32) tma_load(st + L::A_BYTES + L::B_BYTES, ml, k0, wrow, bar);
    for (int b = 0; b < L::PE_BOXES; ++b)
      tma_load(st + L::A_BYTES + L::PLANES * L::B_BYTES + b * 32 * 64, &mpe, k0 + 16 * b, 0,
               bar);
  };
  // the A prologue of stage s: LN + gamma + beta + pe, rounded to T, in
  // place.  A thread keeps one column pk and the rows pm0 + i*RSTEP.
  constexpr int RSTEP = THREADS / BK, RN = PBM / RSTEP;
  const int pk = threadIdx.x % BK, pm0 = threadIdx.x / BK;
  // pe[row][pk] in the stage's pe boxes (32 rows of 16 f32, swizzled 64B)
  const int pe_k = (pk / 16) * 32 * 16 + pk % 4, pe_chunk = (pk % 16) / 4;
  auto prologue = [&](int s) {
    char* st = stages + (s % S) * L::TILE;
    T* a = reinterpret_cast<T*>(st) + Swizzled<T, 64>{}.at(pm0, pk);  // rows pm0 + i*RSTEP
    const float* pe_s = reinterpret_cast<const float*>(st + L::A_BYTES + L::PLANES * L::B_BYTES);
    const int kg = s * BK + pk;
    const float gk = gb[kg], bk = gb[CMAX + kg];
#pragma unroll 4
    for (int i = 0; i < RN; ++i) {
      if (pm0 + i * RSTEP < valid) {
        T* e = a + i * RSTEP * BK;  // RSTEP is a multiple of 8: the same swizzle phase
        const float4 ri = rowinfo[pm0 + i * RSTEP];  // mu, rstd, the row of pe
        const int pr = __float_as_int(ri.z);
        const float pv = pe_s[pe_k + pr * 16 + ((pe_chunk ^ ((pr >> 1) & 3)) * 4)];
        *e = from_f<T>((to_f(*e) - ri.x) * ri.y * gk + bk + pv);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    for (int s = 0; s < S - 1 && s < steps; ++s) load(s);
  }
  for (int j = threadIdx.x; j < c; j += THREADS) {
    gb[j] = gamma[j];
    gb[CMAX + j] = beta[j];
  }
  // LayerNorm statistics of every cl-th token of the tile, one warp a
  // token, four tokens' loads in flight at a time, stored into every block
  // of the cluster
  const int cl = cluster.num_blocks(), rank = cluster.block_rank();
  for (int m0 = rank + cl * warp; m0 < PBM; m0 += 4 * cl * WARPS) {
    float2 st[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = m0 + u * cl * WARPS;
      st[u] = m < valid ? row_stats(xb + (long long)m * c, c) : make_float2(0.f, 0.f);
    }
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + u * cl * WARPS;
        if (m < PBM) {
          const float4 ri = make_float4(st[u].x, st[u].y, __int_as_float((row0 + m) % t), 0.f);
          for (int r = 0; r < cl; ++r) *cluster.map_shared_rank(rowinfo + m, r) = ri;
        }
      }
  }
  cluster.sync();  // every block holds all the tile's statistics
  mbar_wait(&bars[0], 0);
  prologue(0);

  float acc[MT][NT][4];
  zero(acc);
  // step s multiplies stage s, then runs the A prologue of stage s+1: one
  // barrier a step
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // stage s prepared; stage s-1 no longer read
    if (threadIdx.x == 0 && s + S - 1 < steps) {
      fence_proxy_async();
      load(s + S - 1);
    }
    const char* st = stages + (s % S) * L::TILE;
    const T* a = reinterpret_cast<const T*>(st);
    const T* b = reinterpret_cast<const T*>(st + L::A_BYTES) + wn * NT * 8 * BK;
    warp_tile(acc, a + wm * MT * 16 * BK, Swizzled<T, 64>{}, b, b + L::B_BYTES / sizeof(T),
              Swizzled<T, 64>{}, BK);
    if (s + 1 < steps) {  // behind the products, before the next barrier
      mbar_wait(&bars[(s + 1) % S], ((s + 1) / S) & 1);
      prologue(s + 1);
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (wm * MT + mt) * 16 + g + 8 * half;
        const int col = n0 + (wn * NT + nt) * 8 + 2 * tq;
        if (row < valid)
          store2(qkv + (long long)(row0 + row) * 3 * c + col, acc[mt][nt][2 * half],
                 acc[mt][nt][2 * half + 1]);
      }
}

// (b)'s shared memory: a ring of Wo tiles filled by TMA (hi and lo planes
// [OBN] in rows of 64 bytes: BK columns), one head's attention
// [OBM][dh + pad] (T), q, k, v of a 32-token chunk [32][dh + 4] (f32) and
// a softmax row a warp.
template <typename T> struct OutLayout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int PLANES = F32 ? 2 : 1;
  static constexpr int BK = 64 / sizeof(T), STAGES = F32 ? 3 : 4;
  static constexpr int B_BYTES = OBN * 64, STAGE = PLANES * B_BYTES;
  int ldatt, ldkv;
  size_t att, kv, pw, bytes;  // byte offsets from the 1024-aligned ring, and the total
  __host__ __device__ explicit OutLayout(int dh) : ldatt(dh + TilePad<T>::value), ldkv(dh + 4) {
    att = (size_t)STAGES * STAGE;
    kv = att + (size_t)OBM * ldatt * sizeof(T);
    pw = kv + 3 * 32 * (size_t)ldkv * sizeof(float);
    bytes = 1024 + pw + WARPS * 32 * sizeof(float);
  }
};

// out = x + A Wo + bo, A = the heads' attention computed here from q|k|v:
// grid (C/256, token tiles of 4 chunks) in clusters of cl = C/256 blocks,
// the blocks of one token tile.  Per head, each block of the cluster
// computes the attention of its chunks (chunk cc on rank cc % cl) and
// stores it into the att buffer of every block (distributed shared
// memory), so the attention runs once, not once per column tile; after a
// cluster barrier each multiplies the head's whole A tile by its 256 Wo
// columns.  mwh/mwl map the K-major Wo planes.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
out_kernel(const __grid_constant__ CUtensorMap mwh, const __grid_constant__ CUtensorMap mwl,
           const T* __restrict__ x, const float* __restrict__ qkv, const T* __restrict__ bo,
           T* __restrict__ out, int rows, int t, int c, int heads, float scale) {
  using L = OutLayout<T>;
  constexpr int BK = L::BK, S = L::STAGES, MT = 4, NT = 8;  // warps 2 x 4, 64 x 64 each
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[S];
  char* ring = align1024(smem4);
  const int dh = c / heads;
  const L lay(dh);
  T* att = reinterpret_cast<T*>(ring + lay.att);      // [OBM][ldatt] one head's attention
  float* qs = reinterpret_cast<float*>(ring + lay.kv);  // [32][ldkv] q_h of a chunk
  float* ks = qs + 32 * lay.ldkv;                      // k_h
  float* vs = ks + 32 * lay.ldkv;                      // v_h
  float* pw = reinterpret_cast<float*>(ring + lay.pw);  // [WARPS][32] a softmax row a warp

  const int ldatt = lay.ldatt, ldkv = lay.ldkv, c3 = 3 * c;
  const int tpc = (32 / t) * t;  // tokens of a 32-token chunk: whole rows only
  const int tokens = rows * t;
  const int tok_base = blockIdx.y * 4 * tpc;
  const int n0 = blockIdx.x * OBN;
  const int cl = gridDim.x, rank = blockIdx.x;  // the cluster spans the column tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const int kph = dh / BK, steps = c / BK;
  cg::cluster_group cluster = cg::this_cluster();

  auto load = [&](int s) {
    char* st = ring + (s % S) * L::STAGE;
    uint64_t* bar = &bars[s % S];
    mbar_expect_tx(bar, L::STAGE);
    tma_load(st, &mwh, s * BK, n0, bar);
    if (L::F32) tma_load(st + L::B_BYTES, &mwl, s * BK, n0, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    for (int s = 0; s < S - 1 && s < steps; ++s) load(s);
  }
  // rows of A that hold no token stay zero
  for (int i = threadIdx.x; i < OBM * dh; i += THREADS)
    att[(i / dh) * ldatt + i % dh] = from_f<T>(0.f);
  cluster_arrive();  // paired with the wait before the first remote store

  float acc[MT][NT][4];
  zero(acc);
#pragma unroll 1
  for (int h = 0; h < heads; ++h) {
    cluster_wait();  // every block has multiplied the previous head's A (and started)
    for (int cc = rank; cc < 4; cc += cl) {
      const int tok0 = tok_base + cc * tpc;
      const int ntok = max(0, min(tpc, tokens - tok0));
      __syncthreads();  // the previous chunk's q, k, v read
      if (ntok > 0) {
        const float* src = qkv + (long long)tok0 * c3 + h * dh;
        load_tile<THREADS>(qs, ldkv, src, c3, 32, dh, ntok);
        load_tile<THREADS>(ks, ldkv, src + c, c3, 32, dh, ntok);
        load_tile<THREADS>(vs, ldkv, src + 2 * c, c3, 32, dh, ntok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int i = warp; i < ntok; i += WARPS) {
        const int r0 = (i / t) * t;  // the query's row inside the chunk
        float sc = -CUDART_INF_F;
        if (lane < t) {
          const float4* qr = reinterpret_cast<const float4*>(qs + i * ldkv);
          const float4* kr = reinterpret_cast<const float4*>(ks + (r0 + lane) * ldkv);
          float a = 0.f;
          for (int d = 0; d < dh / 4; ++d) {
            const float4 q = qr[d], k = kr[d];
            a = fmaf(q.x, k.x, a);
            a = fmaf(q.y, k.y, a);
            a = fmaf(q.z, k.z, a);
            a = fmaf(q.w, k.w, a);
          }
          sc = a * scale;
        }
        const float mx = warp_max(sc);
        const float p = lane < t ? expf(sc - mx) : 0.f;
        pw[warp * 32 + lane] = p / warp_sum(p);
        __syncwarp();
        for (int d = lane; d < dh; d += 32) {
          const float* vc = vs + r0 * ldkv + d;
          float o = 0.f;
          for (int j = 0; j < t; ++j) o = fmaf(pw[warp * 32 + j], vc[j * ldkv], o);
          T* dst = att + (cc * 32 + i) * ldatt + d;
          for (int r = 0; r < cl; ++r) *cluster.map_shared_rank(dst, r) = from_f<T>(o);
        }
        __syncwarp();
      }
    }
    cluster_arrive();
    cluster_wait();  // the head's attention is in every block's att
#pragma unroll 1
    for (int kk = 0; kk < kph; ++kk) {
      const int s = h * kph + kk;
      __syncthreads();  // stage s-1 no longer read
      if (threadIdx.x == 0 && s + S - 1 < steps) {
        fence_proxy_async();
        load(s + S - 1);
      }
      mbar_wait(&bars[s % S], (s / S) & 1);
      const T* st = reinterpret_cast<const T*>(ring + (s % S) * L::STAGE) + wn * NT * 8 * BK;
      warp_tile(acc, att + wm * MT * 16 * ldatt + kk * BK, Padded{ldatt}, st,
                st + L::B_BYTES / sizeof(T), Swizzled<T, 64>{}, BK);
    }
    cluster_arrive();  // done reading this head's att
  }
  cluster_wait();  // no block leaves while others may still store into it

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (wm * MT + mt) * 16 + g + 8 * half;
      const int i = row % 32, tok = tok_base + (row / 32) * tpc + i;
      if (i >= tpc || tok >= tokens) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + (wn * NT + nt) * 8 + 2 * tq;
        const long long off = (long long)tok * c + col;
        const float2 xv = load2(x + off), bv = load2(bo + col);
        store2(out + off, xv.x + acc[mt][nt][2 * half] + bv.x,
               xv.y + acc[mt][nt][2 * half + 1] + bv.y);
      }
    }
}

// The two launches of the grouped route; qkv is an f32 scratch [rows*t, 3c].
template <typename T>
int launch_grouped(const void* x, const float* gamma, const float* beta, const float* pe,
                   const void* const* wh, const void* const* wl, const void* bo, void* out,
                   float* qkv, int rows, int t, int c, int heads, float scale,
                   cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int tokens = rows * t;
  CUtensorMap mx, mpe, mh[4], ml[4];
  int bad = make_tile_map(&mx, x, F32, tokens, c, c, PBM, 64);
  bad = bad || make_tile_map(&mpe, pe, true, t, c, c, 32, 64);
  for (int i = 0; i < 3; ++i) {
    bad = bad || make_tile_map(&mh[i], wh[i], F32, c, c, c, PBN, 64);
    bad = bad || make_tile_map(&ml[i], wl[i], F32, c, c, c, PBN, 64);
  }
  bad = bad || make_tile_map(&mh[3], wh[3], F32, c, c, c, OBN, 64);
  bad = bad || make_tile_map(&ml[3], wl[3], F32, c, c, c, OBN, 64);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const size_t psmem = ProjLayout<T>::BYTES, osmem = OutLayout<T>(c / heads).bytes;
  cudaError_t err = cudaFuncSetAttribute(qkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)psmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)osmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (a): clusters of the column tiles that share a token tile's statistics
  const int ntiles = 3 * c / PBN;
  const int pcl = ntiles % 4 == 0 ? 4 : ntiles % 3 == 0 ? 3 : ntiles % 2 == 0 ? 2 : 1;
  cudaLaunchConfig_t pcfg = {};
  pcfg.gridDim = dim3(ntiles, (tokens + PBM - 1) / PBM);
  pcfg.blockDim = dim3(THREADS);
  pcfg.dynamicSmemBytes = psmem;
  pcfg.stream = stream;
  cudaLaunchAttribute pattr[1];
  pattr[0].id = cudaLaunchAttributeClusterDimension;
  pattr[0].val.clusterDim.x = pcl;
  pattr[0].val.clusterDim.y = 1;
  pattr[0].val.clusterDim.z = 1;
  pcfg.attrs = pattr;
  pcfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&pcfg, qkv_kernel<T>, mx, mh[0], mh[1], mh[2], ml[0], ml[1], ml[2],
                           mpe, static_cast<const T*>(x), gamma, beta, qkv, tokens, t, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_tile = 4 * (32 / t);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c / OBN, (rows + rows_per_tile - 1) / rows_per_tile);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = osmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c / OBN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, out_kernel<T>, mh[3], ml[3], static_cast<const T*>(x),
                           static_cast<const float*>(qkv), static_cast<const T*>(bo),
                           static_cast<T*>(out), rows, t, c, heads, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block, in bytes (mirrored by the wrapper,
// which checks it against the card's 227 KB before launching).
size_t smem_bytes(int t, int c, int rpb) {
  const int mpad = round_up(rpb * t, RM);
  return ((size_t)mpad * c + (size_t)mpad * (3 * c + 1) + WARPS * 32) * sizeof(float);
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

// The head-grouped route (C >= 512) in two launches: wh and wl hold the
// K-major [C_out, C_in] Wq, Wk, Wv, Wo (for f32 their TF32 hi and lo
// planes; wl is not read for bf16), qkv is an f32 scratch [rows*t, 3c].
// Takes C a multiple of 256 up to 1024 and heads of a width dh = C/heads
// that is a multiple of 32 and at most 128 (mirrored by
// kernels/fused_temporal_block.py:launch_grouped).  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int endodav_fused_temporal_block_grouped(
    int dtype, const void* x, const void* gamma, const void* beta, const void* pe,
    const void* wq_h, const void* wk_h, const void* wv_h, const void* wo_h, const void* wq_l,
    const void* wk_l, const void* wv_l, const void* wo_l, const void* bo, void* out, void* qkv,
    int rows, int t, int c, int heads, float scale, void* stream) {
  if (rows < 1 || t < 1 || t > 32 || heads < 1 || c % OBN != 0 || c > CMAX ||
      c % heads != 0 || (c / heads) % 32 != 0 || c / heads > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* wh[4] = {wq_h, wk_h, wv_h, wo_h};
  const void* wl[4] = {wq_l, wk_l, wv_l, wo_l};
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* p = static_cast<const float*>(pe);
  float* s = static_cast<float*>(qkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_grouped<float>(x, g, bt, p, wh, wl, bo, out, s, rows, t, c, heads, scale, st);
  if (dtype == kBFloat16)
    return launch_grouped<__nv_bfloat16>(x, g, bt, p, wh, wl, bo, out, s, rows, t, c, heads,
                                         scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
