// Spatial multi-head attention of the ViT blocks, for Hopper (sm_90a), on
// the tensor cores.
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
// softmax and the running output in f32.  As in the TPU kernel (:61), q is
// scaled and rounded back to the input type before the q.k product.
//
// What bounds it: at the ViT shapes (Dh = 64, N = 321..1703, B*H up to
// 512) the work is 4*B*H*N^2*Dh operations against 4*B*N*C bytes, far
// above the card's ridge point: the tensor-core rate bounds it.  In f32
// the products run as 3xTF32 (tc_tile.cuh): 3x the operations at the
// TF32 rate, 165 TFLOP/s; in bf16 at 989.
//
// Design.  The TPU kernel held a batch cell's whole K/V in VMEM and took a
// two-pass softmax.  Here one block of 8 warps owns 128 query rows of one
// (b, h), 16 rows a warp, and streams K and V through shared memory in
// tiles of 64 keys (cp.async, a ring of two stages: the next tile lands
// while this one computes) with an online softmax: running max m and sum
// l per row, the output rescaled by alpha = exp(m_old - m_new).
//   - Q: loaded once, scaled, and kept as A fragments in registers for
//     the whole key loop (f32: split into TF32 hi and lo once).
//   - f32: when a K/V tile has landed, the block splits it once into TF32
//     hi and lo planes (K as it is, V transposed), which all 8 warps then
//     read: splitting per fragment would cost every warp 3 instructions an
//     element beside 3/8 of an mma.
//   - S = Q K^T: K's [key][dim] tile is the K-major B operand, read by
//     ldmatrix.  Contraction over 64 dimensions.
//   - Softmax in registers: a row's 64 scores sit in the 4 lanes of a quad
//     (an accumulator fragment holds rows g and g+8, columns 2t and 2t+1),
//     so the row max is two shfl_xor; each lane keeps a partial row sum,
//     reduced across the quad once at the end.  ex2 with log2(e) folded
//     in.  Keys at or past n are masked here; nothing is padded in device
//     memory (cp.async zero-fills the rows past n).
//   - P V with P kept in registers: S's accumulator fragment is P V's A
//     fragment.  bf16 (m16n8k16): the layouts line up once pairs are
//     packed; V's B fragments come by ldmatrix.trans from its [key][dim]
//     tile.  tf32 (m16n8k8): the accumulator holds columns 2t and 2t+1
//     where A wants t and t+4, so the k-slots are permuted instead of P:
//     keys 2t and 2t+1 go to k-slots t and t+4, and V's B fragment is keys
//     2t and 2t+1 of one dimension, one float2 of each transposed plane
//     (rows padded to 72: conflict-free); the contraction over keys does
//     not care about their order.  P is split hi/lo in registers.
//   - Accumulation order.  The tensor core cuts the sum it adds into
//     toward zero at the accumulator's magnitude (tc_tile.cuh).  So the
//     output O, a sum over all N keys, is never the accumulator of an mma:
//     a key tile's P V goes into a zero-started partial (8 k-steps, 24
//     passes in f32), and O = alpha * O + partial on the FMA pipe, rounded
//     to nearest, where the online softmax rescales O anyway.  S, a 64-wide
//     contraction, is its own zero-started partial.  On the H100 this
//     order stays at 2.1e-6 of float64 at N=1703; partials of two k-steps
//     for both products, 6.9e-7, cost 19% more time (PERF.md).
//   - bf16: P is rounded to bf16 before P V, as the TPU kernel rounds p to
//     v's type (:71).  This kernel rounds the unnormalized p and divides by
//     the f32 row sum at the end, where JAX rounds the normalized p: the
//     two differ by bf16's rounding, well inside its tolerance.
// Shared memory: f32 the ring (69,632 bytes) and the planes (71,680; Q's
// tile is staged there first), one block an SM; bf16 the ring and Q's
// tile, 55,296 bytes, two blocks an SM.

#include <math_constants.h>

#include <type_traits>

#include "tc_tile.cuh"

namespace {

using namespace endodav;

constexpr int DH = 64;   // head width (vits and vitl)
constexpr int BQ = 128;  // query rows a block, 16 a warp
constexpr int BK = 64;   // keys a shared-memory tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;
constexpr int NT = BK / 8;  // 8-key n-tiles of S; 8-dim n-tiles of O
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in elements of T.  Both: a ring of STAGES raw K and V
// tiles [key][LD] (cp.async).  f32 adds the split planes of one tile: K
// hi and lo [key][LD], V hi and lo transposed [dim][LDT]; Q's raw tile
// [BQ][LD] is staged there before the first split.  bf16 has Q's tile
// [BQ][LD] of its own.
template <typename T> struct Smem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LD = DH + TilePad<T>::value;
  static constexpr int LDT = BK + 8;  // V^T rows: float2 B loads conflict-free
  static constexpr int TILE = BK * LD;
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int PLANES = F32 ? 2 * TILE + 2 * DH * LDT : BQ * LD;
  static_assert(!F32 || BQ * LD <= PLANES, "Q is staged in the planes' space");
  static constexpr size_t BYTES = (size_t)(RING + PLANES) * sizeof(T);
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Split a landed raw K/V tile into the planes, all threads: K row-major
// (16-byte chunks along a row), V transposed (consecutive lanes on
// consecutive keys, so the transposing stores hit consecutive banks).
__device__ __forceinline__ void split_tile(float* planes, const float* kraw, const float* vraw) {
  using S = Smem<float>;
  float* khi = planes;
  float* klo = khi + S::TILE;
  float* vthi = klo + S::TILE;
  float* vtlo = vthi + DH * S::LDT;
#pragma unroll
  for (int e = 0; e < BK * DH / 4 / THREADS; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int row = i / (DH / 4), col = (i % (DH / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(kraw + row * S::LD + col);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(khi + row * S::LD + col) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(klo + row * S::LD + col) = make_uint4(l[0], l[1], l[2], l[3]);
  }
#pragma unroll
  for (int e = 0; e < BK * DH / 4 / THREADS; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int key = i % BK, d = (i / BK) * 4;
    const float4 v = *reinterpret_cast<const float4*>(vraw + key * S::LD + d);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t h, l;
      split_tf32(f[c], h, l);
      vthi[(d + c) * S::LDT + key] = __uint_as_float(h);
      vtlo[(d + c) * S::LDT + key] = __uint_as_float(l);
    }
  }
}

// s = Q K^T for this warp's 16 rows and a tile's 64 keys, f32: K's split
// planes by ldmatrix; the 8 k-steps' passes summed from zero (the tile's
// scores are their own zero-started partial)
__device__ __forceinline__ void scores(float (&s)[NT][4], const uint32_t (&qh)[DH / 8][4],
                                       const uint32_t (&ql)[DH / 8][4], const float* khi) {
  constexpr int LD = Smem<float>::LD;
  const float* klo = khi + Smem<float>::TILE;
  const int lane = threadIdx.x & 31;
  const int rb = lane % 8 + 8 * (lane / 16), cb = 4 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t hi[4], lo[4];
      const int off = (np * 16 + rb) * LD + kk * 8 + cb;
      ldsm4(hi, khi + off);
      ldsm4(lo, klo + off);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int nt = 2 * np + h2;
        const uint32_t bh[2] = {hi[2 * h2], hi[2 * h2 + 1]};
        const uint32_t bl[2] = {lo[2 * h2], lo[2 * h2 + 1]};
        if (kk == 0) mma_tf32_zero(s[nt], ql[kk], bh);
        else mma_tf32(s[nt], ql[kk], bh);
        mma_tf32(s[nt], qh[kk], bl);
        mma_tf32(s[nt], qh[kk], bh);
      }
    }
  }
}

__device__ __forceinline__ void scores(float (&s)[NT][4], const uint32_t (&qa)[DH / 16][4],
                                       const __nv_bfloat16* ks) {
  constexpr int LD = Smem<__nv_bfloat16>::LD;
  const int lane = threadIdx.x & 31;
  const int rb = lane % 8 + 8 * (lane / 16), cb = 8 * ((lane / 8) % 2);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm4(b, ks + (np * 16 + rb) * LD + kk * 16 + cb);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t bf[2] = {b[2 * j], b[2 * j + 1]};
        mma_bf16(s[2 * np + j], qa[kk], bf);
      }
    }
}

// part = P V, f32: P's k-step kk is S's n-tile kk with keys 2t, 2t+1 in
// k-slots t, t+4, so V's B fragment is keys 2t and 2t+1 of dim g: one
// float2 of each transposed plane; the 8 k-steps' passes summed from zero
__device__ __forceinline__ void tile_pv(float (&part)[NT][4], const float (&p)[NT][4],
                                        const float* vthi) {
  constexpr int LDT = Smem<float>::LDT;
  const float* vtlo = vthi + DH * LDT;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kp = 0; kp < NT / 2; ++kp) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* f = p[2 * kp + j];
      const float a[4] = {f[0], f[2], f[1], f[3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[j][i], al[j][i]);
    }
#pragma unroll
    for (int dn = 0; dn < NT; ++dn) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int off = (dn * 8 + g) * LDT + (2 * kp + j) * 8 + 2 * t;
        const uint2 hv = *reinterpret_cast<const uint2*>(vthi + off);
        const uint2 lv = *reinterpret_cast<const uint2*>(vtlo + off);
        const uint32_t bh[2] = {hv.x, hv.y}, bl[2] = {lv.x, lv.y};
        if (kp == 0 && j == 0) mma_tf32_zero(part[dn], al[j], bh);
        else mma_tf32(part[dn], al[j], bh);
        mma_tf32(part[dn], ah[j], bl);
        mma_tf32(part[dn], ah[j], bh);
      }
    }
  }
}

// part = P V, bf16: P rounded to bf16 and packed in pairs; V's B
// fragments by ldmatrix.trans
__device__ __forceinline__ void tile_pv(float (&part)[NT][4], const float (&p)[NT][4],
                                        const __nv_bfloat16* vs) {
  constexpr int LD = Smem<__nv_bfloat16>::LD;
  const int lane = threadIdx.x & 31;
  const int rv = lane % 8 + 8 * ((lane / 8) % 2), cv = 8 * (lane / 16);
#pragma unroll
  for (int dn = 0; dn < NT; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[dn][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t b[4];
      ldsm4_trans(b, vs + (kk * 16 + rv) * LD + dp * 16 + cv);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t bf[2] = {b[2 * j], b[2 * j + 1]};
        mma_bf16(part[2 * dp + j], a, bf);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, Smem<T>::F32 ? 1 : 2)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int n, int heads, long long ld_in, long long bs_in,
            float scale) {
  constexpr bool F32 = Smem<T>::F32;
  using S = Smem<T>;
  constexpr int LD = S::LD;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);  // stage s: K at ring + 2*s*TILE, V after it
  T* planes = ring + S::RING;             // f32: the split planes (Q's tile first); bf16: Q

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long base = (long long)b * bs_in + (long long)h * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ntiles = (n + BK - 1) / BK;

  auto load_kv = [&](int j) {
    T* st = ring + (j % STAGES) * 2 * S::TILE;
    const long long off = base + (long long)j * BK * ld_in;
    load_tile<THREADS>(st, LD, k + off, ld_in, BK, DH, n - j * BK);
    load_tile<THREADS>(st + S::TILE, LD, v + off, ld_in, BK, DH, n - j * BK);
  };
  load_tile<THREADS>(planes, LD, q + base + (long long)q0 * ld_in, ld_in, BQ, DH, n - q0);
  load_kv(0);
  cp_async_commit();
  if (ntiles > 1) load_kv(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // Q's A fragments: scaled, rounded to T, (f32) split
  constexpr int KQ = F32 ? DH / 8 : DH / 16;
  uint32_t qh[KQ][4], ql[F32 ? KQ : 1][4];
  {
    const int ra = warp * 16 + lane % 8 + 8 * ((lane / 8) % 2);
    const int ca = (F32 ? 4 : 8) * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t raw[4];
      ldsm4(raw, planes + ra * LD + kk * (F32 ? 8 : 16) + ca);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (F32) {
          split_tf32(__uint_as_float(raw[i]) * scale, qh[kk][i], ql[kk][i]);
        } else {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i]));
          qh[kk][i] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
    }
  }

  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int dn = 0; dn < NT; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dn][c] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<1>();  // tile j has landed (tile j+1 may be in flight)
    __syncthreads();     // ... for every thread; the planes (or Q) are free
    const T* ks = ring + (j % STAGES) * 2 * S::TILE;
    const T* vs = ks + S::TILE;
    if constexpr (F32) {
      split_tile(planes, ks, vs);
      __syncthreads();  // the planes are written, the raw stage consumed
      if (j + STAGES < ntiles) load_kv(j + STAGES);
      cp_async_commit();
    }
    float s[NT][4];
    if constexpr (F32) scores(s, qh, ql, planes);
    else scores(s, qh, ks);

    const int k0 = j * BK;
    if (k0 + BK > n) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k0 + nt * 8 + 2 * t + (c & 1) >= n) s[nt][c] = -CUDART_INF_F;
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // key k0 < n is valid, so mx (and m_new) is finite
      const float m_new = fmaxf(m_r[r], mx);
      alpha[r] = ex2((m_r[r] - m_new) * kLog2e);
      m_r[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c) {
          s[nt][c] = ex2((s[nt][c] - m_new) * kLog2e);
          rs += s[nt][c];
        }
      l_r[r] = l_r[r] * alpha[r] + rs;
    }
    float part[NT][4];
    if constexpr (F32) tile_pv(part, s, planes + 2 * S::TILE);
    else tile_pv(part, s, vs);
#pragma unroll
    for (int dn = 0; dn < NT; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[dn][c] = fmaf(alpha[c >> 1], acc[dn][c], part[dn][c]);
    if constexpr (!F32) {
      __syncthreads();  // every warp is done with this stage
      if (j + STAGES < ntiles) load_kv(j + STAGES);
      cp_async_commit();
    }
  }

  const long long ld_out = (long long)heads * DH;
  T* ob = o + (long long)b * n * ld_out + (long long)h * DH + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < n) {
      const float inv = 1.f / l;
      T* orow = ob + (long long)row * ld_out;
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
        store2(orow + dn * 8, acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
           long long ld_in, long long bs_in, float scale, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<T>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ - 1) / BQ, heads, batch);
  attn_kernel<T><<<grid, THREADS, Smem<T>::BYTES, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n, heads, ld_in, bs_in, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* endodav_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns the cudaError_t of the launch (0 on success).  q, k, v and the
// row and batch strides 16-byte aligned (the wrapper checks).
extern "C" int endodav_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                       void* o, int batch, int n, int heads, int dh,
                                       long long ld_in, long long bs_in, float scale,
                                       void* stream) {
  if (dh != DH || n < 1 || batch < 1 || heads < 1 || heads > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(q, k, v, o, batch, n, heads, ld_in, bs_in, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, batch, n, heads, ld_in, bs_in, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
