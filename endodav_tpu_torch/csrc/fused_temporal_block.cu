// Fused attention sub-block of the temporal (motion) modules, for Hopper
// (sm_90a), on the tensor cores.
//
// Replaces: endodav_tpu/kernels/fused_temporal_block.py:_kernel (:76),
// launched by _forward (:182, pallas_call :192) for C < 512, and
// _grouped_kernel (:120), launched by _forward_grouped (:206, pallas_call
// :226) for C >= 512, both through fused_temporal_block (:247) from
// models/motion.py:121-138.  The two compute the same function, in head
// groups or not; one route serves both here, at every width the models
// build: C = 64, 192, 384 (vits), 256 and 1024 (vitl), 8 heads of width
// 8 to 128.
//
// Computes, for every row r of x [R, T, C] (T <= 32):
//   y   = LayerNorm(x[r]; eps 1e-5) * gamma + beta + pe          [T, C]
//   q,k,v = y Wq, y Wk, y Wv                                       [T, C]
//   a_h = softmax(q_h k_h^T * scale) v_h   for the heads of width C/heads
//   out[r] = x[r] + a Wo + bo
// with gamma/beta/pe in f32 and x, the weights and bo in f32 or bf16.  y
// and the attention output are rounded to the input type before their
// products, as the TPU kernels do; q|k|v are kept in f32 (JAX's
// preferred_element_type=f32) and every sum is f32.  The weights arrive
// K-major ([C_out, C_in], torch's nn.Linear layout; for f32 their TF32 hi
// and lo planes, made once by the wrapper).
//
// What bounds it: per token 8*C^2 operations of the four C x C products
// and 4*T*C of the attention, against 2*C activation elements read and
// written and a q|k|v round trip of 6*C f32 values: the tensor-core rate
// at vitl's C=1024 (rows=1702: 0.46 TFLOP, 2.77 ms at 3xTF32's 165
// TFLOP/s), and at C=64 device memory (rows=6808: 7.1 GFLOP against 0.45
// GB, 0.13 ms).
//
// Design: two launches.  A block cannot hold LN(x) of a row, q|k|v of its
// heads and the ring of weight tiles that the tensor cores need (at C=384,
// T=32 the first two alone are 197 KB, which pinned a SIMT kernel at one
// row a block re-reading all four weights from L2).
//   (a) qkv_kernel: q|k|v [R*T, 3C] = LN(x) [Wq|Wk|Wv], a GEMM over all R*T
//       tokens in tiles of 128 tokens x BN columns (BN, the widest of 64,
//       192 and 256 that divides C).  x, the weight planes and pe arrive by TMA (tma.cuh) in
//       64-byte-wide stages.  The A operand's prologue applies LayerNorm
//       (eps 1e-5, two-pass variance), gamma, beta and pe to each landed x
//       stage in shared memory and rounds it to T, one stage ahead of the
//       products.  Each token's mean and rstd come from a first pass over
//       the tile's tokens, shared by a cluster of the column tiles of a
//       token tile (each block computes every cl-th token's).  q|k|v go to
//       an f32 scratch the wrapper allocates.
//   (b) out_kernel: out = x + A Wo + bo for a tile of 128 tokens (4
//       chunks of 32: whole rows of T <= 32) x BN columns, where the block
//       computes its A operand itself: the K loop walks the heads, HS at a
//       time, HS*dh a multiple of the 64-byte stage (BK columns: 2 heads
//       at dh = 8 or 24 in f32, 4 in bf16; 1 from dh = 32 or 48).  Per
//       head group the attention softmax(q_h k_h^T * scale) v_h of the
//       tile's rows runs on the SIMT cores, one warp per (row, head) with
//       register tiles (warp_attention.cuh; p stays f32, as JAX keeps it
//       beside f32 q|k|v), is rounded to T as JAX does at
//       att.astype(x_ref.dtype) (:165), and multiplies the group's rows of
//       Wo (its planes by TMA).  The C/BN
//       column tiles of a token tile form a cluster: each computes the
//       attention of its chunks (chunk cc on rank cc % cl), loading their
//       q, k, v with one cp.async batch, and stores it into every block's A
//       buffer (distributed shared memory), so the attention runs once and
//       not once per column tile.  One f32 accumulator sums the heads in
//       order, as grouped_reference_block's single group does.
// Tokens past the last row are zero-filled and never stored.  For T < 32
// a 32-token chunk holds floor(32/T) rows and a tile four chunks.

#include <cooperative_groups.h>

#include <type_traits>

#include "tc_tile.cuh"
#include "tma.cuh"
#include "warp_attention.cuh"

namespace {

using namespace endodav;
namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 128;     // tokens a tile, in both launches: 4 chunks of 32
constexpr int CMAX = 1024;  // widest C whose token rows the statistics hold
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a Hopper block may use

// The 8 warps of a BM x BN tile: WM x WN warps of MT 16-row by NT 8-column
// fragments.  f32: 4 x 2 warps of 32 x BN/2 (the 3xTF32 order holds two
// k-steps of split A fragments and a partial beside the accumulators; 64
// rows a warp spill at BN = 256).  bf16: BN = 64 as 4 x 2 warps of 32 x
// 32; 192 and 256 as 2 x 4 warps of 64 x 48 and 64 x 64.
template <typename T, int BN> struct WarpGrid {
  static_assert(BN == 64 || BN == 192 || BN == 256, "column tiles of 64, 192 or 256");
  static constexpr int WN = std::is_same<T, float>::value || BN == 64 ? 2 : 4, WM = WARPS / WN;
  static constexpr int MT = BM / (16 * WM), NT = BN / (8 * WN);
};

// (a)'s stages, filled by TMA: the x tile [BM] and the weight tile's hi
// (and lo) plane [BN] in rows of 64 bytes (BK columns), and pe [32] of
// the same columns (f32, one or two 64-byte boxes); then gamma and beta
// [C] and the tokens' statistics.  Four stages or more, so that the A
// prologue can run one stage ahead of the products.
template <typename T, int BN> struct ProjLayout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int PLANES = F32 ? 2 : 1;
  static constexpr int BK = 64 / sizeof(T), STAGES = F32 ? 4 : 5;
  static constexpr int A_BYTES = BM * 64, B_BYTES = BN * 64;
  static constexpr int PE_BOXES = BK * 4 / 64, PE_BYTES = PE_BOXES * 32 * 64;
  static constexpr int TILE = A_BYTES + PLANES * B_BYTES + PE_BYTES;
  static constexpr size_t BYTES = 1024 + (size_t)STAGES * TILE + 2 * CMAX * 4 + BM * 16;
};

// Mean and rstd of a token row of c <= CMAX values (two passes over the
// row held in registers), one warp.
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
// grid (3C/BN, token tiles), so that the blocks of a token tile run
// together and read its x from L2, in clusters of cl of them (cl divides
// 3C/BN) that share the tile's LayerNorm statistics: each block computes
// those of every cl-th token and stores them into all the cluster's
// blocks.  mx maps x [tokens, C], mw*h/mw*l the K-major [C_out, C_in]
// weights (hi and lo planes for f32), mpe pe [T, C].
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 2 : 1)
qkv_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mqh,
           const __grid_constant__ CUtensorMap mkh, const __grid_constant__ CUtensorMap mvh,
           const __grid_constant__ CUtensorMap mql, const __grid_constant__ CUtensorMap mkl,
           const __grid_constant__ CUtensorMap mvl, const __grid_constant__ CUtensorMap mpe,
           const T* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, float* __restrict__ qkv, int tokens, int t, int c) {
  using L = ProjLayout<T, BN>;
  using G = WarpGrid<T, BN>;
  constexpr int BK = L::BK, S = L::STAGES, MT = G::MT, NT = G::NT;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[S];
  char* stages = align1024(smem4);
  float* gb = reinterpret_cast<float*>(stages + S * L::TILE);  // gamma [c], beta [c]
  float4* rowinfo = reinterpret_cast<float4*>(gb + 2 * CMAX);  // [BM] mu, rstd, pe row
  cg::cluster_group cluster = cg::this_cluster();

  const int row0 = blockIdx.y * BM, valid = min(BM, tokens - row0);
  const int n0 = blockIdx.x * BN, which = n0 / c, wrow = n0 - which * c;
  const CUtensorMap* mh = which == 0 ? &mqh : which == 1 ? &mkh : &mvh;
  const CUtensorMap* ml = which == 0 ? &mql : which == 1 ? &mkl : &mvl;
  const T* xb = x + (long long)row0 * c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int wm = warp / G::WN, wn = warp % G::WN;
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
  constexpr int RSTEP = THREADS / BK, RN = BM / RSTEP;
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
  for (int m0 = rank + cl * warp; m0 < BM; m0 += 4 * cl * WARPS) {
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
        if (m < BM) {
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
// [BN] in rows of 64 bytes: BK columns), one head group's attention
// [BM][w + pad] (T, w = HS*dh columns), q, k, v of nch 32-token chunks
// [nch*32][w + 4] (f32: an odd number of 16-byte words a row, as
// warp_attention reads them) and, for heads narrower than 32 columns, a
// softmax tile [32][PLD] a warp (from 32 columns p overwrites the warp's
// own rows of q).
constexpr int PLD = 36;  // odd_words(32)
template <typename T, int BN> struct OutLayout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int PLANES = F32 ? 2 : 1;
  static constexpr int BK = 64 / sizeof(T), STAGES = F32 ? 3 : 4;
  static constexpr int B_BYTES = BN * 64, STAGE = PLANES * B_BYTES;
  int ldatt, ldkv;
  size_t att, kv, pw, bytes;  // byte offsets from the 1024-aligned ring, and the total
  __host__ __device__ OutLayout(int w, int dh, int nch)
      : ldatt(w + TilePad<T>::value), ldkv(w + 4) {
    att = (size_t)STAGES * STAGE;
    kv = att + (size_t)BM * ldatt * sizeof(T);
    pw = kv + 3 * (size_t)nch * 32 * ldkv * sizeof(float);
    bytes = 1024 + pw + (dh < 32 ? (size_t)WARPS * 32 * PLD * sizeof(float) : 0);
  }
};

// out = x + A Wo + bo, A = the heads' attention computed here from q|k|v:
// grid (C/BN, token tiles of 4 chunks) in clusters of cl = C/BN blocks,
// the blocks of one token tile.  Per group of hs heads, each block of the
// cluster computes the attention of its chunks (chunk cc on rank cc % cl,
// nch of them a batch) and stores it into the att buffer of every block
// (distributed shared memory), so the attention runs once, not once per
// column tile; after a cluster barrier each multiplies the group's whole
// A tile by its BN Wo columns.  mwh/mwl map the K-major Wo planes.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 2 : 1)
out_kernel(const __grid_constant__ CUtensorMap mwh, const __grid_constant__ CUtensorMap mwl,
           const T* __restrict__ x, const float* __restrict__ qkv, const T* __restrict__ bo,
           T* __restrict__ out, int rows, int t, int c, int heads, int hs, int nch,
           float scale) {
  using L = OutLayout<T, BN>;
  using G = WarpGrid<T, BN>;
  constexpr int BK = L::BK, S = L::STAGES, MT = G::MT, NT = G::NT;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[S];
  char* ring = align1024(smem4);
  const int dh = c / heads, w = hs * dh;
  const L lay(w, dh, nch);
  T* att = reinterpret_cast<T*>(ring + lay.att);      // [BM][ldatt] one group's attention
  float* qs = reinterpret_cast<float*>(ring + lay.kv);  // [nch*32][ldkv] q of the group
  float* ks = qs + nch * 32 * lay.ldkv;                // k
  float* vs = ks + nch * 32 * lay.ldkv;                // v
  float* pw = reinterpret_cast<float*>(ring + lay.pw);  // [WARPS][32][PLD] if dh < 32

  const int ldatt = lay.ldatt, ldkv = lay.ldkv, c3 = 3 * c;
  const int tpc = (32 / t) * t;  // tokens of a 32-token chunk: whole rows only
  const int tokens = rows * t;
  const int tok_base = blockIdx.y * 4 * tpc;
  const int n0 = blockIdx.x * BN;
  const int cl = gridDim.x, rank = blockIdx.x;  // the cluster spans the column tiles
  const int mine = (4 - rank + cl - 1) / cl;    // chunks rank, rank + cl, ... below 4
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int wm = warp / G::WN, wn = warp % G::WN;
  const int kpg = w / BK, steps = c / BK;
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
  for (int i = threadIdx.x; i < BM * w; i += THREADS)
    att[(i / w) * ldatt + i % w] = from_f<T>(0.f);
  cluster_arrive();  // paired with the wait before the first remote store

  float acc[MT][NT][4];
  zero(acc);
#pragma unroll 1
  for (int grp = 0; grp < heads / hs; ++grp) {
    cluster_wait();  // every block has multiplied the previous group's A (and started)
    for (int m0 = 0; m0 < mine; m0 += nch) {
      const int nb = min(nch, mine - m0);
      __syncthreads();  // the previous batch's q, k, v read
      for (int b = 0; b < nb; ++b) {
        const int tok0 = tok_base + (rank + (m0 + b) * cl) * tpc;
        const int ntok = max(0, min(tpc, tokens - tok0));
        if (ntok > 0) {
          const float* src = qkv + (long long)tok0 * c3 + grp * w;
          load_tile<THREADS>(qs + b * 32 * ldkv, ldkv, src, c3, 32, w, ntok);
          load_tile<THREADS>(ks + b * 32 * ldkv, ldkv, src + c, c3, 32, w, ntok);
          load_tile<THREADS>(vs + b * 32 * ldkv, ldkv, src + 2 * c, c3, 32, w, ntok);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      // one warp per (row, head): units of the batch's chunks, their rows
      // and the group's heads
      const int rows_c = tpc / t, units = nb * rows_c * hs;
      for (int u = warp; u < units; u += WARPS) {
        const int hl = u % hs, rc = (u / hs) % rows_c, b = u / (hs * rows_c);
        const int cc = rank + (m0 + b) * cl;
        if (rc * t >= tokens - (tok_base + cc * tpc)) continue;  // past the last row
        const int off = (b * 32 + rc * t) * ldkv + hl * dh;
        const bool alias = dh >= 32;
        float* ps = alias ? qs + off : pw + warp * 32 * PLD;
        const int pld = alias ? ldkv : PLD;
        T* arow = att + (cc * 32 + rc * t) * ldatt + hl * dh;
        auto store = [&](int f, int d0, const auto& o) {
          constexpr int n = sizeof(o) / sizeof(float);
          T* dst = arow + f * ldatt + d0;
          for (int r = 0; r < cl; ++r) {
            T* p = cluster.map_shared_rank(dst, r);
#pragma unroll
            for (int e = 0; e < n; e += 2) store2(p + e, o[e], o[e + 1]);
          }
        };
        // passes of 16 queries beside the wide tiles' accumulators (registers)
        constexpr int QB = BN >= 192 ? 16 : 32;
        const bool dv4 = (dh / 4) % 4 == 0;
        if (t <= 16) {
          if (dv4)
            warp_attention<float, 16, 4>(qs + off, ks + off, vs + off, ldkv, ps, pld, t, dh,
                                         scale, store);
          else
            warp_attention<float, 16, 2>(qs + off, ks + off, vs + off, ldkv, ps, pld, t, dh,
                                         scale, store);
        } else {
          if (dv4)
            warp_attention<float, 32, 4, QB>(qs + off, ks + off, vs + off, ldkv, ps, pld, t,
                                             dh, scale, store);
          else
            warp_attention<float, 32, 2, QB>(qs + off, ks + off, vs + off, ldkv, ps, pld, t,
                                             dh, scale, store);
        }
      }
    }
    cluster_arrive();
    cluster_wait();  // the group's attention is in every block's att
#pragma unroll 1
    for (int kk = 0; kk < kpg; ++kk) {
      const int s = grp * kpg + kk;
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
    cluster_arrive();  // done reading this group's att
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

cudaError_t launch_cluster(const void* kernel, dim3 grid, int cluster, size_t smem,
                           cudaStream_t stream, void** args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The two launches; qkv is an f32 scratch [rows*t, 3c].  nch, the chunks
// whose q, k, v (b) stages at once, is the most of its 4/cl that fit.
template <typename T, int BN>
int launch(const void* x, const float* gamma, const float* beta, const float* pe,
           const void* const* wh, const void* const* wl, const void* bo, void* out, float* qkv,
           int rows, int t, int c, int heads, int hs, float scale, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int tokens = rows * t, w = hs * (c / heads), cl = c / BN;
  int nch = (4 + cl - 1) / cl;
  const int dh = c / heads;
  while (nch > 1 && OutLayout<T, BN>(w, dh, nch).bytes > SMEM_MAX) nch = (nch + 1) / 2;
  const size_t psmem = ProjLayout<T, BN>::BYTES, osmem = OutLayout<T, BN>(w, dh, nch).bytes;
  if (osmem > SMEM_MAX || psmem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mpe, mh[4], ml[4];
  int bad = make_tile_map(&mx, x, F32, tokens, c, c, BM, 64);
  bad = bad || make_tile_map(&mpe, pe, true, t, c, c, 32, 64);
  for (int i = 0; i < 4; ++i) {
    bad = bad || make_tile_map(&mh[i], wh[i], F32, c, c, c, BN, 64);
    bad = bad || make_tile_map(&ml[i], wl[i], F32, c, c, c, BN, 64);
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(qkv_kernel<T, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)psmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(out_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)osmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (a): clusters of the column tiles that share a token tile's statistics
  const int ntiles = 3 * c / BN;
  const int pcl = ntiles % 4 == 0 ? 4 : ntiles % 3 == 0 ? 3 : ntiles % 2 == 0 ? 2 : 1;
  const T* xt = static_cast<const T*>(x);
  void* pargs[] = {&mx, &mh[0], &mh[1], &mh[2], &ml[0], &ml[1], &ml[2], &mpe,
                   &xt, &gamma, &beta, &qkv, const_cast<int*>(&tokens), &t, &c};
  err = launch_cluster(reinterpret_cast<const void*>(qkv_kernel<T, BN>),
                       dim3(ntiles, (tokens + BM - 1) / BM), pcl, psmem, stream, pargs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_tile = 4 * (32 / t);
  const float* qkvc = qkv;
  const T* bot = static_cast<const T*>(bo);
  T* outt = static_cast<T*>(out);
  void* oargs[] = {&mh[3], &ml[3], &xt, &qkvc, &bot, &outt, &rows, &t, &c, &heads, &hs, &nch,
                   &scale};
  err = launch_cluster(reinterpret_cast<const void*>(out_kernel<T, BN>),
                       dim3(cl, (rows + rows_per_tile - 1) / rows_per_tile), cl, osmem, stream,
                       oargs);
  return static_cast<int>(err);
}

template <typename T>
int launch_bn(int bn, const void* x, const float* gamma, const float* beta, const float* pe,
              const void* const* wh, const void* const* wl, const void* bo, void* out,
              float* qkv, int rows, int t, int c, int heads, int hs, float scale,
              cudaStream_t stream) {
  switch (bn) {
    case 64:
      return launch<T, 64>(x, gamma, beta, pe, wh, wl, bo, out, qkv, rows, t, c, heads, hs,
                           scale, stream);
    case 192:
      return launch<T, 192>(x, gamma, beta, pe, wh, wl, bo, out, qkv, rows, t, c, heads, hs,
                            scale, stream);
    case 256:
      return launch<T, 256>(x, gamma, beta, pe, wh, wl, bo, out, qkv, rows, t, c, heads, hs,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The temporal block in two launches: wh and wl hold the K-major [C_out,
// C_in] Wq, Wk, Wv, Wo (for f32 their TF32 hi and lo planes; wl is not
// read for bf16), qkv is an f32 scratch [rows*t, 3c].  bn (the column
// tile: 64, 192 or 256, dividing c, c/bn at most 8 blocks a cluster) and
// hs (heads a K step, dividing heads, hs*dh a multiple of 64 bytes of T
// and at most 128) are the wrapper's choice
// (kernels/fused_temporal_block.py:tile_config), checked here; c is a
// multiple of 64 up to 1024, dh = c/heads a multiple of 4 up to 128.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int endodav_fused_temporal_block(
    int dtype, const void* x, const void* gamma, const void* beta, const void* pe,
    const void* wq_h, const void* wk_h, const void* wv_h, const void* wo_h, const void* wq_l,
    const void* wk_l, const void* wv_l, const void* wo_l, const void* bo, void* out, void* qkv,
    int rows, int t, int c, int heads, int bn, int hs, float scale, void* stream) {
  const int bk = dtype == kFloat32 ? 16 : 32;
  if (rows < 1 || t < 1 || t > 32 || heads < 1 || c % 64 != 0 || c > CMAX ||
      c % heads != 0 || (c / heads) % 4 != 0 || c / heads > 128 || bn < 1 || c % bn != 0 ||
      c / bn > 8 || hs < 1 || heads % hs != 0 || (hs * (c / heads)) % bk != 0 ||
      hs * (c / heads) > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* wh[4] = {wq_h, wk_h, wv_h, wo_h};
  const void* wl[4] = {wq_l, wk_l, wv_l, wo_l};
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* p = static_cast<const float*>(pe);
  float* s = static_cast<float*>(qkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_bn<float>(bn, x, g, bt, p, wh, wl, bo, out, s, rows, t, c, heads, hs, scale,
                            st);
  if (dtype == kBFloat16)
    return launch_bn<__nv_bfloat16>(bn, x, g, bt, p, wh, wl, bo, out, s, rows, t, c, heads, hs,
                                    scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
