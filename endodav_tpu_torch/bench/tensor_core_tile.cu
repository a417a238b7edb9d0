// Micro-benchmark of the tensor-core tile (csrc/tc_tile.cuh) on one card:
// what the fused MLP's and the grouped temporal block's products can reach.
//
//   mkdir -p endodav_tpu_torch/_build && \
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -I endodav_tpu_torch/csrc -o endodav_tpu_torch/_build/tensor_core_tile \
//        endodav_tpu_torch/bench/tensor_core_tile.cu && endodav_tpu_torch/_build/tensor_core_tile
//
// 1. The warp tile alone: 8 warps of 64x64 tiles (a 128x256 block tile;
//    also 32x128 tiles, "32x128") multiplying operands that stay in shared
//    memory, bf16 and 3xTF32, with and without a barrier a step: the
//    ceiling of mma.sync.  3xTF32
//    in the kernels' accumulation order (warp_tile: a zero-started partial
//    of two k-steps added rounded to nearest) and in the other orders
//    below (order_tile), for what each costs there.
// 2. A 128x256 GEMM (K=1024, B as hi and lo planes) fed by a cp.async ring
//    of 4 stages: the loads alone, and with one or two products a stage.
// 3. The same GEMM fed by TMA (tma.cuh), checked against a host reference.
// 4. The f32 error of each accumulation order against a float64 product
//    at K = 1024 and 4096 (one warp a 16x16 output tile, K in chunks of 32
//    as bench/tile_error.cu walks it), on N(0,1) x N(0,1/K) operands and
//    on their absolute values, as max |err| / max(1, max |ref|).
// TFLOP/s count the function's own operations (f32 work for 3xTF32).
//
// The orders (3xTF32's three passes a k-step of 8: a_lo*b_hi, a_hi*b_lo,
// a_hi*b_hi; the tensor core cuts each sum toward zero at the
// accumulator's magnitude):
//   kernels     a partial of 2 k-steps (warp_tile, csrc/tc_tile.cuh);
//   direct      every pass straight into the running sum (before the repair);
//   partial-1/4 a partial of 1 or 4 k-steps;
//   cross       a_lo*b_hi and a_hi*b_lo into an accumulator of their own,
//               added once at the end; a_hi*b_hi straight into the sum.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <type_traits>
#include <vector>

#include "tc_tile.cuh"
#include "tma.cuh"

using namespace endodav;

constexpr int K = 1024, BLOCKS = 132 * 8;

// The other orders, on padded tiles: KS = 0 every pass straight into acc;
// KS > 0 a zero-started partial of KS k-steps added to acc rounded to
// nearest; CROSS (with KS = 0) the two small passes into `cross`, which
// the caller adds to acc at the end.  kdim a multiple of 8 * max(KS, 1).
template <int KS, bool CROSS, int MT, int NT>
__device__ __forceinline__ void order_tile(float (&acc)[MT][NT][4], float (&cross)[MT][NT][4],
                                           const float* a, int lda, const float* bh,
                                           const float* bl, int ldb, int kdim) {
  constexpr int KK = KS > 0 ? KS : 1;
  const int lane = threadIdx.x & 31;
  const int ra = lane % 8 + 8 * ((lane / 8) % 2), ca = 4 * (lane / 16);
  const int rb = lane % 8 + 8 * (lane / 16), cb = 4 * ((lane / 8) % 2);
#pragma unroll 1
  for (int k0 = 0; k0 < kdim; k0 += 8 * KK) {
    uint32_t ahi[KK][MT][4], alo[KK][MT][4];
#pragma unroll
    for (int ks = 0; ks < KK; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t v[4];
        ldsm4(v, a + (mt * 16 + ra) * lda + k0 + 8 * ks + ca);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ahi[ks][mt][i] = tf32_rna(__uint_as_float(v[i]));
          alo[ks][mt][i] = tf32_rna(__uint_as_float(v[i]) - __uint_as_float(ahi[ks][mt][i]));
        }
      }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t hi[KK][4], lo[KK][4];
#pragma unroll
      for (int ks = 0; ks < KK; ++ks) {
        const int off = (np * 16 + rb) * ldb + k0 + 8 * ks + cb;
        ldsm4(hi[ks], bh + off);
        ldsm4(lo[ks], bl + off);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * np + j;
        if constexpr (KS == 0) {
          const uint32_t bhi[2] = {hi[0][2 * j], hi[0][2 * j + 1]};
          const uint32_t blo[2] = {lo[0][2 * j], lo[0][2 * j + 1]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_tf32(CROSS ? cross[mt][nt] : acc[mt][nt], alo[0][mt], bhi);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_tf32(CROSS ? cross[mt][nt] : acc[mt][nt], ahi[0][mt], blo);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], ahi[0][mt], bhi);
        } else {
          float part[MT][4];
#pragma unroll
          for (int ks = 0; ks < KK; ++ks) {
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
  }
}

// One of the f32 orders: ORDER -1 the kernels' (warp_tile), else KS of
// order_tile with CROSS = ORDER == 100.
template <int ORDER, int MT, int NT>
__device__ __forceinline__ void f32_tile(float (&acc)[MT][NT][4], float (&cross)[MT][NT][4],
                                         const float* a, int lda, const float* bh,
                                         const float* bl, int ldb, int kdim) {
  if constexpr (ORDER < 0)
    warp_tile(acc, a, Padded{lda}, bh, bl, Padded{ldb}, kdim);
  else if constexpr (ORDER == 100)
    order_tile<0, true>(acc, cross, a, lda, bh, bl, ldb, kdim);
  else
    order_tile<ORDER, false>(acc, cross, a, lda, bh, bl, ldb, kdim);
}

constexpr int KERNELS = -1, DIRECT = 0, CROSS = 100;

float elapsed(cudaEvent_t a, cudaEvent_t b) {
  float ms;
  cudaEventSynchronize(b);
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

// WR rows a warp: 64 (2 x 4 warps of 64x64) or 32 (4 x 2 warps of 32x128)
template <typename T, bool SYNC, int ORDER, int WR>
__global__ void __launch_bounds__(256, 1) tile_only(float* out, int iters) {
  extern __shared__ float4 sm4[];
  constexpr int LD = std::is_same<T, float>::value ? 32 + 4 : 32 + 8, BK = LD - TilePad<T>::value;
  constexpr int WM = 128 / WR, WN = 8 / WM, MT = WR / 16, NT = 256 / WN / 8;
  T* a = reinterpret_cast<T*>(sm4);
  T* b = a + 128 * LD;
  for (int i = threadIdx.x; i < (128 + 512) * LD; i += 256) a[i] = from_f<T>(0.001f * (i % 7));
  __syncthreads();
  float acc[MT][NT][4], cross[MT][NT][4];
  zero(acc);
  zero(cross);
  const int warp = threadIdx.x / 32, wm = warp / WN, wn = warp % WN;
  const T* aw = a + wm * WR * LD;
  const T* bw = b + wn * NT * 8 * LD;
  for (int it = 0; it < iters; ++it) {
    if constexpr (std::is_same<T, float>::value)
      f32_tile<ORDER>(acc, cross, aw, LD, bw, bw + 256 * LD, LD, BK);
    else
      warp_tile(acc, aw, LD, bw, bw + 256 * LD, LD, BK);
    if (SYNC) __syncthreads();
  }
  float s = 0;
  for (int i = 0; i < MT; ++i)
    for (int j = 0; j < NT; ++j)
      for (int c = 0; c < 4; ++c) s += acc[i][j][c] + cross[i][j][c];
  if (s == 12345.f) out[0] = s;
}

template <typename T, bool SYNC, int ORDER = KERNELS, int WR = 64>
void run_tile_only(const char* name, float* out) {
  constexpr int LD = std::is_same<T, float>::value ? 32 + 4 : 32 + 8, BK = LD - TilePad<T>::value;
  const int iters = 1000;
  const size_t smem = (size_t)(128 + 512) * LD * sizeof(T);
  auto kernel = tile_only<T, SYNC, ORDER, WR>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<BLOCKS / 2, 256, smem>>>(out, 10);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<BLOCKS / 2, 256, smem>>>(out, iters);
  cudaEventRecord(e1);
  const float ms = elapsed(e0, e1);
  printf("[tile] %-34s %s %.3f ms %.1f TFLOP/s\n", name, cudaGetErrorString(cudaGetLastError()),
         ms, 2.0 * 128 * 256 * BK * iters * (BLOCKS / 2) / ms / 1e9);
}

template <int REPS>
__global__ void __launch_bounds__(256, 1) cp_ring(const float* a, const float* bm, float* out) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  constexpr int BK = 16, S = 4, LD = BK + 4, STAGE = (128 + 512) * LD;
  const float* ab = a + (long long)(blockIdx.x % 8) * 128 * K;
  const float* bh = bm + (long long)(blockIdx.x % 24) * 512 * K;
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4, steps = K / BK;
  auto load = [&](int s) {
    float* st = sm + (s % S) * STAGE;
    load_tile<256>(st, LD, ab + s * BK, K, 128, BK, 128);
    load_tile<256>(st + 128 * LD, LD, bh + s * BK, K, 512, BK, 512);
  };
  for (int s = 0; s < S - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  float acc[4][8][4];
  zero(acc);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (s + S - 1 < steps) load(s + S - 1);
    cp_async_commit();
    const float* st = sm + (s % S) * STAGE;
    for (int r = 0; r < REPS; ++r)
      warp_tile(acc, st + wm * 64 * LD, LD, st + 128 * LD + wn * 64 * LD,
                st + 384 * LD + wn * 64 * LD, LD, BK);
  }
  float x = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j)
      for (int c = 0; c < 4; ++c) x += acc[i][j][c];
  if (x == 12345.f) out[0] = x;
}

template <int REPS>
void run_cp_ring(const char* name, const float* a, const float* b, float* out) {
  const size_t smem = (size_t)4 * 640 * 20 * 4;
  cudaFuncSetAttribute(cp_ring<REPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cp_ring<REPS><<<BLOCKS, 256, smem>>>(a, b, out);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  for (int r = 0; r < 5; ++r) cp_ring<REPS><<<BLOCKS, 256, smem>>>(a, b, out);
  cudaEventRecord(e1);
  const float ms = elapsed(e0, e1) / 5;
  printf("[cp.async ring] %-25s %s %.3f ms %.1f TFLOP/s, %.2f TB/s into the SMs\n", name,
         cudaGetErrorString(cudaGetLastError()), ms, 2.0 * 128 * 256 * K * REPS * BLOCKS / ms / 1e9,
         (double)BLOCKS * 640 * K * 4 / ms / 1e9);
}

template <typename T, int S>
__global__ void __launch_bounds__(256, 1)
tma_ring(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mbh,
         const __grid_constant__ CUtensorMap mbl, float* out, int tiles) {
  extern __shared__ float4 sm4[];
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int BK = 128 / sizeof(T), ABYTES = 128 * 128, BBYTES = 256 * 128;
  constexpr int STAGE = ABYTES + (F32 ? 2 : 1) * BBYTES;
  __shared__ uint64_t bars[S];
  char* base = align1024(sm4);
  const int row0 = (blockIdx.x % tiles) * 128;
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4, lane = threadIdx.x % 32;
  const int steps = K / BK;
  auto load = [&](int s) {
    char* st = base + (s % S) * STAGE;
    mbar_expect_tx(&bars[s % S], STAGE);
    tma_load(st, &ma, s * BK, row0, &bars[s % S]);
    tma_load(st + ABYTES, &mbh, s * BK, 0, &bars[s % S]);
    if (F32) tma_load(st + ABYTES + BBYTES, &mbl, s * BK, 0, &bars[s % S]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    for (int s = 0; s < S - 1; ++s) load(s);
  }
  float acc[4][8][4];
  zero(acc);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();
    if (threadIdx.x == 0 && s + S - 1 < steps) {
      fence_proxy_async();
      load(s + S - 1);
    }
    mbar_wait(&bars[s % S], (s / S) & 1);
    const T* st = reinterpret_cast<const T*>(base + (s % S) * STAGE);
    const T* b = st + ABYTES / sizeof(T) + wn * 64 * BK;
    warp_tile(acc, st + wm * 64 * BK, Swizzled<T>{}, b, b + BBYTES / sizeof(T), Swizzled<T>{}, BK);
  }
  if (gridDim.x == tiles) {
    const int g = lane >> 2, tq = lane & 3;
    for (int mt = 0; mt < 4; ++mt)
      for (int nt = 0; nt < 8; ++nt)
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + wm * 64 + mt * 16 + g + 8 * h, c = wn * 64 + nt * 8 + 2 * tq;
          out[r * 256 + c] = acc[mt][nt][2 * h];
          out[r * 256 + c + 1] = acc[mt][nt][2 * h + 1];
        }
  }
}

template <typename T> T host_cast(float x);
template <> float host_cast<float>(float x) { return x; }
template <> __nv_bfloat16 host_cast<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

float rna_tf32(float x) {
  uint32_t b;
  memcpy(&b, &x, 4);
  b = (b + 0x1000) & 0xFFFFE000u;
  memcpy(&x, &b, 4);
  return x;
}

template <typename T, int S>
void run_tma_ring(const char* name) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int tiles = 8, M = tiles * 128;
  std::vector<float> a(M * K), b(256 * K);
  srand(1);
  // bf16: multiples of 1/8 in [-1, 1], exact in bf16 and in the sums
  for (auto& v : a) v = F32 ? rand() / (float)RAND_MAX - 0.5f : (float)(rand() % 17 - 8) / 8;
  for (auto& v : b) v = F32 ? rand() / (float)RAND_MAX - 0.5f : (float)(rand() % 17 - 8) / 8;
  std::vector<T> ah(M * K), bh(256 * K), bl(256 * K);
  for (int i = 0; i < M * K; ++i) ah[i] = host_cast<T>(a[i]);
  for (int i = 0; i < 256 * K; ++i) {
    const float hi = F32 ? rna_tf32(b[i]) : b[i];
    bh[i] = host_cast<T>(hi);
    bl[i] = host_cast<T>(F32 ? rna_tf32(b[i] - hi) : hi);
  }
  T *da, *dh, *dl;
  float* dout;
  cudaMalloc(&da, M * K * sizeof(T));
  cudaMalloc(&dh, 256 * K * sizeof(T));
  cudaMalloc(&dl, 256 * K * sizeof(T));
  cudaMalloc(&dout, M * 256 * 4);
  cudaMemcpy(da, ah.data(), M * K * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(dh, bh.data(), 256 * K * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(dl, bl.data(), 256 * K * sizeof(T), cudaMemcpyHostToDevice);
  CUtensorMap ma, mh, ml;
  const int bad = make_tile_map(&ma, da, F32, M, K, K, 128, 128) ||
                  make_tile_map(&mh, dh, F32, 256, K, K, 256, 128) ||
                  make_tile_map(&ml, dl, F32, 256, K, K, 256, 128);
  const size_t smem = (size_t)S * (128 * 128 + (F32 ? 2 : 1) * 256 * 128) + 1024;
  cudaFuncSetAttribute(tma_ring<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  tma_ring<T, S><<<tiles, 256, smem>>>(ma, mh, ml, dout, tiles);
  const cudaError_t err = cudaDeviceSynchronize();
  std::vector<float> out(M * 256);
  cudaMemcpy(out.data(), dout, M * 256 * 4, cudaMemcpyDeviceToHost);
  double maxerr = 0, scale = 0;
  for (int s = 0; s < 2000; ++s) {
    const int m = (s * 7919) % M, n = (s * 104729) % 256;
    double ref = 0;
    for (int k = 0; k < K; ++k) ref += (double)a[m * K + k] * b[n * K + k];
    maxerr = fmax(maxerr, fabs(ref - out[m * 256 + n]));
    scale = fmax(scale, fabs(ref));
  }
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  tma_ring<T, S><<<BLOCKS, 256, smem>>>(ma, mh, ml, dout, tiles);
  cudaEventRecord(e0);
  for (int r = 0; r < 5; ++r) tma_ring<T, S><<<BLOCKS, 256, smem>>>(ma, mh, ml, dout, tiles);
  cudaEventRecord(e1);
  const float ms = elapsed(e0, e1) / 5;
  printf("[TMA ring] %-30s maps %s, %s, max |err| %.3e of %.3e, %.3f ms %.1f TFLOP/s\n", name,
         bad ? "failed" : "ok", cudaGetErrorString(err), maxerr, scale, ms,
         2.0 * 128 * 256 * K * BLOCKS / ms / 1e9);
  cudaFree(da);
  cudaFree(dh);
  cudaFree(dl);
  cudaFree(dout);
}

// 4. out [m, n] = a [m, k] b^T, b as hi and lo planes [n, k]: one warp a
// 16x16 tile, K in chunks of 32 staged in padded shared memory.
template <int ORDER>
__global__ void __launch_bounds__(32)
order_error(const float* a, const float* bh, const float* bl, float* out, int n, int k) {
  constexpr int KC = 32, LD = KC + 4;
  __shared__ __align__(16) float as[16 * LD], hs[16 * LD], ls[16 * LD];
  const int row0 = blockIdx.y * 16, col0 = blockIdx.x * 16, lane = threadIdx.x;
  float acc[1][2][4], cross[1][2][4];
  zero(acc);
  zero(cross);
  for (int k0 = 0; k0 < k; k0 += KC) {
    for (int i = lane; i < 16 * KC; i += 32) {
      const int r = i / KC, c = i % KC;
      as[r * LD + c] = a[(long long)(row0 + r) * k + k0 + c];
      hs[r * LD + c] = bh[(long long)(col0 + r) * k + k0 + c];
      ls[r * LD + c] = bl[(long long)(col0 + r) * k + k0 + c];
    }
    __syncwarp();
    f32_tile<ORDER>(acc, cross, as, LD, hs, ls, LD, KC);
    __syncwarp();
  }
  const int g = lane >> 2, tq = lane & 3;
  for (int nt = 0; nt < 2; ++nt)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e)
        out[(long long)(row0 + g + 8 * h) * n + col0 + nt * 8 + 2 * tq + e] =
            acc[0][nt][2 * h + e] + cross[0][nt][2 * h + e];
}

template <int ORDER>
void run_order_error(const char* name) {
  const int m = 256, n = 128;
  for (int k : {1024, 4096})
    for (int positive = 0; positive < 2; ++positive) {
      std::vector<float> a((size_t)m * k), b((size_t)n * k), bh(b.size()), bl(b.size());
      srand(k + positive);
      auto normal = [] {  // Box-Muller
        const double u = (rand() + 1.0) / (RAND_MAX + 2.0), v = (rand() + 1.0) / (RAND_MAX + 2.0);
        return sqrt(-2 * log(u)) * cos(6.283185307179586 * v);
      };
      for (auto& x : a) x = positive ? fabs(normal()) : normal();
      for (auto& x : b) x = (positive ? fabs(normal()) : normal()) / sqrt((double)k);
      for (size_t i = 0; i < b.size(); ++i) {
        bh[i] = rna_tf32(b[i]);
        bl[i] = rna_tf32(b[i] - bh[i]);
      }
      float *da, *dh, *dl, *dout;
      cudaMalloc(&da, a.size() * 4);
      cudaMalloc(&dh, b.size() * 4);
      cudaMalloc(&dl, b.size() * 4);
      cudaMalloc(&dout, (size_t)m * n * 4);
      cudaMemcpy(da, a.data(), a.size() * 4, cudaMemcpyHostToDevice);
      cudaMemcpy(dh, bh.data(), b.size() * 4, cudaMemcpyHostToDevice);
      cudaMemcpy(dl, bl.data(), b.size() * 4, cudaMemcpyHostToDevice);
      order_error<ORDER><<<dim3(n / 16, m / 16), 32>>>(da, dh, dl, dout, n, k);
      const cudaError_t err = cudaDeviceSynchronize();
      std::vector<float> out((size_t)m * n);
      cudaMemcpy(out.data(), dout, out.size() * 4, cudaMemcpyDeviceToHost);
      double maxerr = 0, scale = 1;
      for (int i = 0; i < m; ++i)
        for (int j = 0; j < n; ++j) {
          double ref = 0;
          for (int q = 0; q < k; ++q) ref += (double)a[(size_t)i * k + q] * b[(size_t)j * k + q];
          maxerr = fmax(maxerr, fabs(ref - out[(size_t)i * n + j]));
          scale = fmax(scale, fabs(ref));
        }
      printf("[order error] %-12s K=%d %-8s %s max |err| / max(1, |ref|) %.3e\n", name, k,
             positive ? "positive" : "signed", cudaGetErrorString(err), maxerr / scale);
      cudaFree(da);
      cudaFree(dh);
      cudaFree(dl);
      cudaFree(dout);
    }
}

int main() {
  float *out, *a, *b;
  cudaMalloc(&out, 4);
  cudaMalloc(&a, (size_t)8 * 128 * K * 4);
  cudaMalloc(&b, (size_t)24 * 512 * K * 4);
  cudaMemset(a, 0, (size_t)8 * 128 * K * 4);
  cudaMemset(b, 0, (size_t)24 * 512 * K * 4);
  run_tile_only<__nv_bfloat16, false>("bf16", out);
  run_tile_only<__nv_bfloat16, true>("bf16, a barrier a step", out);
  run_tile_only<float, false>("3xTF32 kernels' order", out);
  run_tile_only<float, true>("3xTF32 kernels' order, a barrier", out);
  run_tile_only<float, false, DIRECT>("3xTF32 direct", out);
  run_tile_only<float, false, 1>("3xTF32 partial-1", out);
  run_tile_only<float, false, 4>("3xTF32 partial-4", out);
  run_tile_only<float, false, CROSS>("3xTF32 cross", out);
  run_tile_only<float, false, KERNELS, 32>("3xTF32 kernels' order, 32x128", out);
  run_tile_only<float, false, DIRECT, 32>("3xTF32 direct, 32x128", out);
  run_tile_only<__nv_bfloat16, false, KERNELS, 32>("bf16, 32x128", out);
  run_cp_ring<0>("3xTF32 loads only", a, b, out);
  run_cp_ring<1>("3xTF32", a, b, out);
  run_cp_ring<2>("3xTF32, 2 products a stage", a, b, out);
  run_tma_ring<float, 2>("3xTF32, 2 stages");
  run_tma_ring<__nv_bfloat16, 3>("bf16, 3 stages");
  run_order_error<KERNELS>("kernels");
  run_order_error<DIRECT>("direct");
  run_order_error<1>("partial-1");
  run_order_error<4>("partial-4");
  run_order_error<CROSS>("cross");
  return 0;
}
