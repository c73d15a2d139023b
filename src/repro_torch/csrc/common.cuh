// Shared device helpers of the FedQCS kernels: block-wide reductions, the
// bisection top-S threshold and keep rule of the two encoders, and the two
// row-times-A products of a GAMP step.
//
// Every kernel here runs 256 threads per block (8 warps).  Reductions go
// warp shuffle -> shared scratch -> every thread sums the 8 warp partials in
// the same order, so all threads hold identical totals and control flow that
// depends on them stays uniform.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fedqcs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sums NV per-thread values over the block; every thread gets the totals.
// scratch: at least kWarps * NV floats of shared memory.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  __syncthreads();  // the previous user of scratch has finished reading
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) scratch[warp * NV + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += scratch[w * NV + i];
    v[i] = s;
  }
}

__device__ __forceinline__ float block_sum1(float v, float* scratch) {
  float a[1] = {v};
  block_sum<1>(a, scratch);
  return a[0];
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, scratch[w]);
  return m;
}

// Top-S threshold of one row held in shared memory, by the plain version's
// exact fp32 bisection (kernels/ref.py::block_topk_ref): iters halvings of
// [0, mx], mid = 0.5f * (lo + hi), and count(|x| >= mid) > S moves lo up,
// else hi down.  Counts <= n are exact in fp32.  Returns hi, the same on
// every thread.  Both encoders (bqcs_encode_fused.cu, block_topk.cu) call
// it, so their kept sets are the same bits.
__device__ __forceinline__ float topk_threshold(const float* row, int n, int s, int iters,
                                                float mx, float* scratch) {
  float lo = 0.f, hi = mx;
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float cnt = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) cnt += fabsf(row[i]) >= mid ? 1.f : 0.f;
    cnt = block_sum1(cnt, scratch);
    if (cnt > (float)s) lo = mid; else hi = mid;
  }
  return hi;
}

// The keep rule after the bisection: |x| >= hi, plus the row max (so ties
// and the max survive).
__device__ __forceinline__ bool topk_keep(float x, float hi, float mx) {
  const float mag = fabsf(x);
  return (mag >= hi) | (mag == mx);
}

// out[r * m + j] = <g[r * n : (r+1) * n], A[j, :]> for the TB rows of a tile
// (g and out in shared memory, A (m, n) row-major in device memory).  One
// warp per output j: lanes stride the contiguous A row, so each load is one
// coalesced 128-byte line, and one pass over A serves all TB rows.
template <int TB>
__device__ __forceinline__ void rows_dot_a(const float* g, const float* __restrict__ a,
                                           int m, int n, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < m; j += kWarps) {
    const float* arow = a + (size_t)j * n;
    float acc[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float av = __ldg(arow + i);
#pragma unroll
      for (int r = 0; r < TB; ++r) acc[r] = fmaf(g[r * n + i], av, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0) out[r * m + j] = s;
    }
  }
}

// g[r * n + i] += nu_r[r] * (alpha[r] * <s[r * m : (r+1) * m], A[:, i]>):
// the r-hat update of a GAMP step, in place over the tile's ghat rows.  One
// thread per output i, looping over the m rows of A: neighbouring threads
// read neighbouring addresses, and s[r * m + j] is a shared-memory broadcast.
template <int TB>
__device__ __forceinline__ void rows_times_a_into(const float* s, const float* __restrict__ a,
                                                  int m, int n, const float* nu_r,
                                                  const float* alpha, float* g) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float acc[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float av = __ldg(a + (size_t)j * n + i);
#pragma unroll
      for (int r = 0; r < TB; ++r) acc[r] = fmaf(s[r * m + j], av, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < TB; ++r) g[r * n + i] = g[r * n + i] + nu_r[r] * (alpha[r] * acc[r]);
  }
}

}  // namespace fedqcs
