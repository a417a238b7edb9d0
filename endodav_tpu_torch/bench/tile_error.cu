// The f32 error of the 3xTF32 tensor-core tile (csrc/tc_tile.cuh) against
// K, for Hopper (sm_90a).
//
// Not a port of a TPU kernel: a measurement of the tile that the fused
// MLP's and the temporal block's products run on, in their accumulation
// order.  out = A B^T for A [M, K] (row-major f32) and B given as its TF32
// hi and lo planes [N, K] (K-major, kernels/tf32x3.py), through warp_tile.
// One warp computes a 16 x 16 output tile, walking K in chunks of 32
// staged in padded shared memory; the order of the products on one output
// element is the kernels' own, so the error against a float64 product is
// theirs at the same K.  bench/tile_error.py builds and calls it (for
// chip_smoke.py's tile phase and the card's tests); it is not timed, and
// it is not part of the kernels' library.

#include "tc_tile.cuh"

namespace {

using namespace endodav;

constexpr int KC = 32, LD = KC + 4;

__global__ void __launch_bounds__(32)
tile_error_kernel(const float* __restrict__ a, const float* __restrict__ bh,
                  const float* __restrict__ bl, float* __restrict__ out, int n, int k) {
  __shared__ __align__(16) float as[16 * LD], hs[16 * LD], ls[16 * LD];
  const int row0 = blockIdx.y * 16, col0 = blockIdx.x * 16, lane = threadIdx.x;
  float acc[1][2][4];
  zero(acc);
  for (int k0 = 0; k0 < k; k0 += KC) {
    for (int i = lane; i < 16 * KC; i += 32) {
      const int r = i / KC, c = i % KC;
      as[r * LD + c] = a[(long long)(row0 + r) * k + k0 + c];
      hs[r * LD + c] = bh[(long long)(col0 + r) * k + k0 + c];
      ls[r * LD + c] = bl[(long long)(col0 + r) * k + k0 + c];
    }
    __syncwarp();
    warp_tile(acc, as, Padded{LD}, hs, ls, Padded{LD}, KC);
    __syncwarp();
  }
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* o = out + (long long)(row0 + g + 8 * half) * n + col0 + nt * 8 + 2 * tq;
      o[0] = acc[0][nt][2 * half];
      o[1] = acc[0][nt][2 * half + 1];
    }
}

}  // namespace

// M and N multiples of 16, K a multiple of 32.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int endodav_tile_error(const void* a, const void* bh, const void* bl, void* out,
                                  int m, int n, int k, void* stream) {
  if (m < 16 || n < 16 || k < KC || m % 16 || n % 16 || k % KC)
    return static_cast<int>(cudaErrorInvalidValue);
  tile_error_kernel<<<dim3(n / 16, m / 16), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(bh),
      static_cast<const float*>(bl), static_cast<float*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}
