// Attention of one (row, head) along T by one warp, for Hopper (sm_90a):
// the body of the temporal attention kernel (temporal_attention.cu) and of
// the temporal block's out-projection kernel (fused_temporal_block.cu).
//
// q, k, v are the head's t rows in shared memory, f32, with row stride ld
// (an odd number of 16-byte words, so that the float4 reads below hit
// distinct banks) and dp = dh rounded up to 4 columns (q and k zero in
// columns dh..dp-1).  Rows past t are never read: row indices are clamped
// to t - 1, where the softmax masks the key or p is 0.
//   QK: lane (li, lj) = (lane / 4, lane % 4) holds the scores of queries
//       li + 8a (a < TI) and keys lj + 4b (b < TJ), summed over dp four at
//       a time from float4 reads: (TI + TJ) reads for 4*TI*TJ FMAs.  A
//       query's softmax runs over the 4 lanes that hold it (a maximum and
//       a sum in registers, two shuffles each).  p, rounded to PT (v's type
//       where the caller rounds it), goes to ps: rows < t of [QB][pld].
//   PV: the same lane holds the outputs of queries li + 8a and DV columns
//       at a time, from DV*lj in steps of 4*DV, reading p as float4 along
//       the keys and v as DV-wide vectors; store(f, d0, o) takes the DV
//       outputs o of query f < t at columns d0.. (d0 < dp).
// Queries go in passes of QB (16 or 32; 16 holds fewer scores in
// registers), the keys padded to TM (16, 32 or 64).  ps may alias q: pass
// q0 writes p rows 0..QB-1, whose q rows earlier passes have read; pld >=
// TM.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace endodav {

// n rounded to an odd number of 4-float (16-byte) words, at least n
__host__ __device__ inline int odd_words(int n) { return (((n + 3) / 4) | 1) * 4; }

template <typename PT, int TM, int DV, int QB = (TM >= 32 ? 32 : 16), typename Store>
__device__ __forceinline__ void warp_attention(const float* qs, const float* ks,
                                               const float* vs, int ld, float* ps, int pld,
                                               int t, int dp, float scale, Store&& store) {
  static_assert(QB == 16 || QB == 32, "passes of 16 or 32 queries");
  constexpr int TI = QB / 8, TJ = TM / 4;
  static_assert(DV == 2 || DV == 4, "two or four output columns a lane a step");
  const int lane = threadIdx.x % 32, li = lane / 4, lj = lane % 4;
  const int tp = round_up(t, 4), last = t - 1;
  for (int q0 = 0; q0 < t; q0 += QB) {
    float s[TI][TJ];
#pragma unroll
    for (int a = 0; a < TI; ++a)
#pragma unroll
      for (int b = 0; b < TJ; ++b) s[a][b] = 0.f;
    for (int d = 0; d < dp; d += 4) {
      float4 qv[TI];
#pragma unroll
      for (int a = 0; a < TI; ++a)
        qv[a] = *reinterpret_cast<const float4*>(qs + min(q0 + li + 8 * a, last) * ld + d);
#pragma unroll
      for (int b = 0; b < TJ; ++b) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + min(lj + 4 * b, last) * ld + d);
#pragma unroll
        for (int a = 0; a < TI; ++a) {
          s[a][b] = fmaf(qv[a].x, kv.x, s[a][b]);
          s[a][b] = fmaf(qv[a].y, kv.y, s[a][b]);
          s[a][b] = fmaf(qv[a].z, kv.z, s[a][b]);
          s[a][b] = fmaf(qv[a].w, kv.w, s[a][b]);
        }
      }
    }
    // softmax over the keys, across the 4 lanes of a query
#pragma unroll
    for (int a = 0; a < TI; ++a) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < TJ; ++b) {
        s[a][b] = lj + 4 * b < t ? s[a][b] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[a][b]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < TJ; ++b) {
        s[a][b] = expf(s[a][b] - mx);
        sum += s[a][b];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
      const int f = q0 + li + 8 * a;
      __syncwarp();  // every lane has read q (which ps may alias)
      if (f < t) {
        float* pr = ps + (f - q0) * pld;
#pragma unroll
        for (int b = 0; b < TJ; ++b) pr[lj + 4 * b] = round_to<PT>(s[a][b] * inv);
      }
    }
    __syncwarp();
    for (int d0 = lj * DV; d0 < dp; d0 += 4 * DV) {
      float o[TI][DV];
#pragma unroll
      for (int a = 0; a < TI; ++a)
#pragma unroll
        for (int e = 0; e < DV; ++e) o[a][e] = 0.f;
      for (int j = 0; j < tp; j += 4) {
        float4 pv[TI];
#pragma unroll
        for (int a = 0; a < TI; ++a)
          pv[a] = *reinterpret_cast<const float4*>(
              ps + (min(q0 + li + 8 * a, last) - q0) * pld + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vr = vs + min(j + u, last) * ld + d0;
          float vv[DV];
          if constexpr (DV == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vr);
            vv[0] = x.x, vv[1] = x.y, vv[2] = x.z, vv[3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vr);
            vv[0] = x.x, vv[1] = x.y;
          }
#pragma unroll
          for (int a = 0; a < TI; ++a) {
            const float pj = u == 0 ? pv[a].x : u == 1 ? pv[a].y : u == 2 ? pv[a].z : pv[a].w;
#pragma unroll
            for (int e = 0; e < DV; ++e) o[a][e] = fmaf(pj, vv[e], o[a][e]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < TI; ++a)
        if (q0 + li + 8 * a < t) store(q0 + li + 8 * a, d0, o[a]);
    }
    __syncwarp();  // p is read before the next pass writes it
  }
}

}  // namespace endodav
