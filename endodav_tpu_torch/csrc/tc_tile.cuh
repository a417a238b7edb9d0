// Tensor-core tile of the port's GEMM-shaped kernels, for Hopper (sm_90a).
//
// A warp multiplies an A tile in shared memory (row-major [rows][lda],
// the contraction along a row) by a B tile in shared memory (K-major
// [n][ldb]: torch's nn.Linear layout [C_out, C_in]) into f32
// accumulators in registers, on `mma.sync`:
//   bf16: m16n8k16, bf16 operands as they are;
//   f32:  3xTF32 on m16n8k8.  a = a_hi + a_lo with a_hi = tf32(a) and
//         a_lo = tf32(a - a_hi) (`cvt.rna.tf32.f32`), split here while the
//         A fragments are built; B comes as two planes, hi and lo, split
//         the same way once by the wrapper (kernels/tf32x3.py).  Each
//         k-step sums a_lo*b_hi and a_hi*b_lo first, then a_hi*b_hi, so the
//         small terms are not lost under the large one (the a_lo*b_lo
//         term, below 2^-22 of the product, is left out).
//
// How a k-step's passes reach the accumulator.  The tensor core adds its
// products to the accumulator it is given and cuts the sum toward zero at
// the accumulator's magnitude, not to nearest; the error of one pass is up
// to about an ulp of the running sum, always of one sign.  Passes straight
// into the running sum add 3*K/8 such cuts, which grow with K (on an H100
// 3.1e-5 of max(1, |ref|) at K = 4096, 5.0e-5 on same-sign operands;
// PERF.md).  So the passes of two k-steps run into a partial that starts
// from zero, whose cuts are at the magnitude of sixteen products, and the
// partial is added to the running sum on the FMA pipe, rounded to
// nearest: f32's own error level (1.2e-6 at K = 4096), for MT*4 f32 adds
// a pair of n-tiles every two k-steps and the A fragments of two k-steps
// in registers.  bench/tensor_core_tile.cu measures the other orders.
//
// Why mma.sync and not wgmma: 3xTF32 at a third of the 495 TFLOP/s TF32
// rate (165 TFLOP/s) is 2.5x the f32 SIMT rate of 67, and mma.sync at
// half the tensor-core rate already passes cuBLAS's f32 sgemm; mma.sync
// takes A from registers, where the split happens, and any warp layout,
// so one tile serves the fused MLP's two products, the temporal block's
// projections and the fused RCU's taps (flash attention uses the same
// primitives with its own fragment order).  wgmma would need the split A in shared memory
// (a second pass over every A tile) and 64-row warpgroup tiles.
//
// Fragments come from shared memory by ldmatrix, in either of two tile
// layouts (Padded, Swizzled below), both free of bank conflicts.  Weight
// and activation tiles reach shared memory by TMA (tma.cuh) in rings of
// stages that the kernels keep full ahead of the products; small tiles by
// `cp.async` (16 bytes a thread, zero-filled past the valid rows).
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace endodav {

// Row-stride padding of a shared-memory tile of E (in elements).
template <typename E> struct TilePad;
template <> struct TilePad<float> { static constexpr int value = 4; };
template <> struct TilePad<__nv_bfloat16> { static constexpr int value = 8; };

__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a*b on a zero accumulator (the first pass of a promoted k-step)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 matrices of 16-byte rows from shared memory (ldmatrix.x4):
// lanes 8i..8i+7 give the row addresses of matrix i; a lane receives the
// 32-bit word (lane % 4) of row lane / 4 of each.  For 32-bit (tf32) data
// a 16-byte row is 4 values, for bf16 8.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The same, transposed (ldmatrix.trans, 16-bit data only): a lane receives
// elements (2*(lane%4), lane/4) and (2*(lane%4)+1, lane/4) of each matrix,
// packed: the B fragment of a [k][n] tile stored row-major.
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// hi and lo TF32 halves of an f32 value (the 3xTF32 split)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Shared-memory tile layouts: element (row, col) of a tile.  Padded: rows
// of `ld` elements.  Swizzled: rows of ROWB (128 or 64) bytes whose
// 16-byte chunks are XOR-ed with bits 7-9 (or 7-8) of their byte offset,
// as TMA's SWIZZLE_128B (SWIZZLE_64B) writes them, the tile 1024-byte
// (512-byte) aligned.  Both are conflict-free for ldmatrix.
struct Padded {
  int ld;
  __device__ __forceinline__ int at(int row, int col) const { return row * ld + col; }
};
template <typename E, int ROWB = 128> struct Swizzled {
  static constexpr int CH = 16 / sizeof(E), ROW = ROWB / sizeof(E);
  __device__ __forceinline__ int at(int row, int col) const {
    const int phase = ROWB == 128 ? row & 7 : (row >> 1) & 3;
    return row * ROW + (((col / CH) ^ phase) * CH) + col % CH;
  }
};

// The B side of KS promoted f32 k-steps at k0: acc[mt][nt] += the
// partial of the k-steps' 3xTF32 passes (A's hi and lo fragments given),
// the partial started from zero and added rounded to nearest.
template <int KS, int MT, int NT, typename LB>
__device__ __forceinline__ void promoted_steps(float (&acc)[MT][NT][4],
                                               const uint32_t (&ahi)[KS][MT][4],
                                               const uint32_t (&alo)[KS][MT][4], const float* bh,
                                               const float* bl, LB lb, int k0) {
  const int lane = threadIdx.x & 31;
  const int rb = lane % 8 + 8 * (lane / 16), cb = 4 * ((lane / 8) % 2);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = lb.at(np * 16 + rb, k0 + 8 * ks + cb);
      ldsm4(hi[ks], bh + off);
      ldsm4(lo[ks], bl + off);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nt = 2 * np + j;
      // pass-major: MT independent products between two on one partial
      float part[MT][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t bhi[2] = {hi[ks][2 * j], hi[ks][2 * j + 1]};
        const uint32_t blo[2] = {lo[ks][2 * j], lo[ks][2 * j + 1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (ks == 0) mma_tf32_zero(part[mt], alo[ks][mt], bhi);
          else mma_tf32(part[mt], alo[ks][mt], bhi);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt], ahi[ks][mt], blo);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt], ahi[ks][mt], bhi);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = __fadd_rn(acc[mt][nt][c], part[mt][c]);
    }
  }
}

// acc[mt][nt] += A[mt*16.., 0:kdim] * B[nt*8.., 0:kdim]^T for one warp:
// A at `a` in layout la, B at `bh` (and `bl`, the lo plane, for f32;
// ignored for bf16) in layout lb.  kdim is a multiple of 16, NT is even.
// Accumulator element c of acc[mt][nt] is at row mt*16 + lane/4 (+8 for
// c >= 2), column nt*8 + 2*(lane%4) + c%2.  Fragments come by ldmatrix:
// A one x4 a 16-row tile (rows 0-7 and 8-15, the two k halves), B one x4
// a pair of 8-column tiles.
template <int MT, int NT, typename LA, typename LB,
          typename = std::enable_if_t<!std::is_integral<LA>::value>>
__device__ __forceinline__ void warp_tile(float (&acc)[MT][NT][4], const float* a, LA la,
                                          const float* bh, const float* bl, LB lb, int kdim) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  constexpr int KS = 2;  // k-steps a partial
  const int lane = threadIdx.x & 31;
  const int ra = lane % 8 + 8 * ((lane / 8) % 2), ca = 4 * (lane / 16);
#pragma unroll 1
  for (int k0 = 0; k0 < kdim; k0 += 8 * KS) {
    uint32_t ahi[KS][MT][4], alo[KS][MT][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t v[4];
        ldsm4(v, a + la.at(mt * 16 + ra, k0 + 8 * ks + ca));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(__uint_as_float(v[i]), ahi[ks][mt][i], alo[ks][mt][i]);
      }
    promoted_steps(acc, ahi, alo, bh, bl, lb, k0);
  }
}

// The same, f32, with A already split: its hi and lo planes at `ah` and
// `al`, in the one layout la (an A tile that many warps read is split once
// where it is written, not by every warp at every read); KS k-steps a
// partial, kdim a multiple of 8*KS.
template <int KS, int MT, int NT, typename LA, typename LB>
__device__ __forceinline__ void warp_tile_planes(float (&acc)[MT][NT][4], const float* ah,
                                                 const float* al, LA la, const float* bh,
                                                 const float* bl, LB lb, int kdim) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  const int lane = threadIdx.x & 31;
  const int ra = lane % 8 + 8 * ((lane / 8) % 2), ca = 4 * (lane / 16);
#pragma unroll 1
  for (int k0 = 0; k0 < kdim; k0 += 8 * KS) {
    uint32_t ahi[KS][MT][4], alo[KS][MT][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int off = la.at(mt * 16 + ra, k0 + 8 * ks + ca);
        ldsm4(ahi[ks][mt], ah + off);
        ldsm4(alo[ks][mt], al + off);
      }
    promoted_steps(acc, ahi, alo, bh, bl, lb, k0);
  }
}

template <int MT, int NT, typename LA, typename LB,
          typename = std::enable_if_t<!std::is_integral<LA>::value>>
__device__ __forceinline__ void warp_tile(float (&acc)[MT][NT][4], const __nv_bfloat16* a,
                                          LA la, const __nv_bfloat16* bh,
                                          const __nv_bfloat16* /*bl*/, LB lb, int kdim) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  const int lane = threadIdx.x & 31;
  const int ra = lane % 8 + 8 * ((lane / 8) % 2), ca = 8 * (lane / 16);
  const int rb = lane % 8 + 8 * (lane / 16), cb = 8 * ((lane / 8) % 2);
#pragma unroll 2
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm4(af[mt], a + la.at(mt * 16 + ra, k0 + ca));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm4(b, bh + lb.at(np * 16 + rb, k0 + cb));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t bf[2] = {b[2 * j], b[2 * j + 1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][2 * np + j], af[mt], bf);
      }
    }
  }
}

// The same on padded tiles with row strides lda and ldb.
template <int MT, int NT, typename E>
__device__ __forceinline__ void warp_tile(float (&acc)[MT][NT][4], const E* a, int lda,
                                          const E* bh, const E* bl, int ldb, int kdim) {
  warp_tile(acc, a, Padded{lda}, bh, bl, Padded{ldb}, kdim);
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid (src
// must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [0, rows) x cols [0, cols) of a global matrix (row stride ldg
// elements) into shared memory (row stride lds), all `threads` threads of
// the block taking part; rows >= valid_rows are zero-filled.  cols*sizeof(E)
// and the row starts are multiples of 16 bytes.
template <int THREADS, typename E>
__device__ __forceinline__ void load_tile(E* dst, int lds, const E* src, long long ldg,
                                          int rows, int cols, int valid_rows) {
  constexpr int V = 16 / sizeof(E);
  const int per_row = cols / V;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * lds + c, ok ? src + r * ldg + c : src, ok);
  }
}

// Split barrier of a thread-block cluster: every thread of every block
// arrives, then waits; arrive releases the stores made before it
// (distributed shared memory included), wait acquires them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Two adjacent output values of an accumulator fragment, stored as E.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

}  // namespace endodav
