// Staged BQCS encode (scale -> project -> quantize, paper eqs. 9-10), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bqcs_encode.py
// (_encode_kernel, launched by bqcs_encode_pallas).  Per block-row x:
//   alpha  = sqrt(M) / ||x||, 0 for a dead row
//   y_j    = sum_k (alpha * x_k) * A^T[k, j]      (dense product over N)
//   code_j = #{tau < y_j}                          (uint8)
// The TPU kernel computes the dense product inside its body on the MXU; here
// it is a hand-written fp32 FMA product (no library call), with the row norm,
// the scale and the bucketize fused around it.
//
// What bounds it on the card: 2 x rows x N x M FLOPs, 0.51 GFLOP at the
// paper's 300 x 1591 -> 530 (~7.6 us at the 67 TFLOP/s fp32 peak), against
// ~5.6 MB of x, A^T and codes (~1.7 us at 3.35 TB/s): operations.  Design: a
// plain shared-memory tiled product.  A block owns a 16-row x 64-column tile
// of y (171 blocks at the paper's shape) and walks N in steps of 32: it
// stages the scaled x tile and the A^T tile in shared memory, and each thread
// accumulates 4 rows of one column in registers.  Each block first takes the
// norms of its 16 rows (a warp per 2 rows), so the scale is applied as the x
// tile is staged, as the plain version scales before its product.  alpha and
// y are sums in another order than the plain version's (alpha to ~1e-7
// relative; a code can differ only on a lane within float rounding of a
// threshold).  Tensor cores (wgmma) are left to a later change.

#include "common.cuh"

using namespace fedqcs;

namespace {

constexpr int kTileRows = 16;
constexpr int kTileCols = 64;
constexpr int kTileK = 32;
constexpr int kRowsPerThread = kTileRows / (kThreads / kTileCols);  // 4

__global__ void __launch_bounds__(kThreads)
bqcs_encode_kernel(const float* __restrict__ x, const float* __restrict__ a_t,
                   const float* __restrict__ taus_g, uint8_t* __restrict__ codes,
                   float* __restrict__ alpha_out, int nb, int n, int m, int n_taus) {
  __shared__ float xs[kTileRows][kTileK];
  __shared__ float as[kTileK][kTileCols];
  __shared__ float alpha_s[kTileRows];
  __shared__ float taus[256];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * kTileRows;
  const int col = blockIdx.x * kTileCols + (tid % kTileCols);
  const int r0 = (tid / kTileCols) * kRowsPerThread;

  for (int i = tid; i < n_taus; i += kThreads) taus[i] = taus_g[i];
  // alpha of the tile's rows: warp w takes rows 2w and 2w + 1
  for (int rr = warp; rr < kTileRows; rr += kWarps) {
    const int row = row0 + rr;
    float sq = 0.f;
    if (row < nb) {
      const float* xr = x + (size_t)row * n;
      for (int i = lane; i < n; i += 32) sq = fmaf(xr[i], xr[i], sq);
    }
    sq = warp_sum(sq);
    if (lane == 0) {
      const bool alive = sq > 1e-30f;
      alpha_s[rr] = alive ? sqrtf((float)m) * (1.0f / sqrtf(sq)) : 0.f;
    }
  }
  __syncthreads();

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTileK) {
    for (int i = tid; i < kTileRows * kTileK; i += kThreads) {
      const int rr = i / kTileK, kk = i % kTileK;
      const int row = row0 + rr, k = k0 + kk;
      xs[rr][kk] = (row < nb && k < n) ? x[(size_t)row * n + k] * alpha_s[rr] : 0.f;
    }
    for (int i = tid; i < kTileK * kTileCols; i += kThreads) {
      const int kk = i / kTileCols, cc = i % kTileCols;
      const int k = k0 + kk, c = blockIdx.x * kTileCols + cc;
      as[kk][cc] = (k < n && c < m) ? __ldg(a_t + (size_t)k * m + c) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float av = as[kk][tid % kTileCols];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = fmaf(xs[r0 + r][kk], av, acc[r]);
    }
    __syncthreads();
  }

  if (col < m) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = row0 + r0 + r;
      if (row >= nb) continue;
      uint32_t code = 0u;
      for (int l = 0; l < n_taus; ++l) code += acc[r] > taus[l] ? 1u : 0u;
      codes[(size_t)row * m + col] = (uint8_t)code;
    }
  }
  if (blockIdx.x == 0 && tid < kTileRows && row0 + tid < nb) alpha_out[row0 + tid] = alpha_s[tid];
}

}  // namespace

extern "C" int bqcs_encode_launch(const float* x, const float* a_t, const float* taus,
                                  uint8_t* codes, float* alpha, int nb, int n, int m, int n_taus,
                                  cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (n_taus < 1 || n_taus > 255) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kTileCols - 1) / kTileCols, (nb + kTileRows - 1) / kTileRows);
  bqcs_encode_kernel<<<grid, kThreads, 0, stream>>>(x, a_t, taus, codes, alpha, nb, n, m, n_taus);
  return (int)cudaGetLastError();
}
