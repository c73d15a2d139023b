// Shared device helpers of the FedQCS kernels: block-wide and cluster-wide
// reductions, the bisection top-S threshold and keep rule of the two
// encoders, and the row-times-A products of a GAMP step split by columns over
// a thread-block cluster.
//
// Every kernel here runs 256 threads per block (8 warps).  Reductions go
// warp shuffle -> shared scratch -> every thread sums the 8 warp partials in
// the same order, so all threads hold identical totals and control flow that
// depends on them stays uniform.  The cluster reduction keeps the same rule:
// every block sums the ranks' partials in rank order 0..C-1.
#pragma once

#include <cooperative_groups.h>
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

// tot[k] = sum of part[k] over the blocks of this cluster, k < cnt, read
// through distributed shared memory in rank order 0..C-1, so every block
// gets bit-identical totals.  part lies at the same shared-memory offset in
// every block.  Call it after a cluster.sync() that follows the writes of
// part; the caller syncs the block before reading tot, and the cluster again
// before a block may exit (another block may still be reading its part).
constexpr int kMaxCluster = 16;  // the largest cluster a kernel here launches (non-portable)

__device__ __forceinline__ void cluster_sum(const float* part, int cnt, float* tot) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  for (int k = threadIdx.x; k < cnt; k += kThreads) {
    float v[kMaxCluster];  // all C remote loads in flight at once
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) v[q] = q < c ? cluster.map_shared_rank(part, q)[k] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) s += v[q];  // + 0 past C leaves s exact
    tot[k] = s;
  }
}

// The column-slice products stream A in tiles of kSliceRows rows x kColTile
// columns: each thread keeps 32 independent scalar loads in flight (rows of
// A are 1591 floats at the paper's width, so not 16-byte aligned), and the
// lanes of a warp read 128 contiguous bytes per load.  8 rows beat 4 on the
// H100 (PERF.md).
constexpr int kSliceRows = 8;
constexpr int kColLoads = 4;
constexpr int kColTile = 32 * kColLoads;

// out[r * m + j] = <g[r * ld : r * ld + ns], A[j, 0:ns]> for the TB rows of a
// tile: product 1 of a GAMP step over one column slice (a points at the
// slice's first column, row stride n; g and out in shared memory).  A warp
// owns groups of kSliceRows outputs j and sums over the slice with shuffles.
template <int TB>
__device__ __forceinline__ void slice_dot_a(const float* g, int ld, const float* __restrict__ a,
                                            int m, int n, int ns, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = warp * kSliceRows; j0 < m; j0 += kWarps * kSliceRows) {
    const float* arow[kSliceRows];
#pragma unroll
    for (int b = 0; b < kSliceRows; ++b) arow[b] = a + (size_t)min(j0 + b, m - 1) * n;
    float acc[kSliceRows][TB];
#pragma unroll
    for (int b = 0; b < kSliceRows; ++b)
#pragma unroll
      for (int r = 0; r < TB; ++r) acc[b][r] = 0.f;
    for (int ib = 0; ib < ns; ib += kColTile) {
      float av[kSliceRows][kColLoads];
#pragma unroll
      for (int u = 0; u < kColLoads; ++u) {
        const int i = ib + lane + 32 * u;
#pragma unroll
        for (int b = 0; b < kSliceRows; ++b) av[b][u] = i < ns ? __ldg(arow[b] + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kColLoads; ++u) {
        const int i = ib + lane + 32 * u;
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          const float gv = i < ns ? g[r * ld + i] : 0.f;
#pragma unroll
          for (int b = 0; b < kSliceRows; ++b) acc[b][r] = fmaf(gv, av[b][u], acc[b][r]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kSliceRows; ++b)
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const float s = warp_sum(acc[b][r]);
        if (lane == 0 && j0 + b < m) out[r * m + j0 + b] = s;
      }
  }
}

// g[r * ld + i] += nu_r[r] * <s[r * m : (r+1) * m], A[:, i]> for i < ns: the
// r-hat update of a GAMP step over one column slice (a at the slice's first
// column, row stride n), in place over the tile's ghat slice; with alpha,
// g += nu_r[r] * (alpha[r] * <...>), the quantized step's update.  Warp w
// sums a contiguous eighth of the m rows of A for kColTile columns at a
// time; the 8 warp partials meet in red (kWarps * TB * kColTile floats of
// shared memory) and are added in warp order.
template <int TB>
__device__ __forceinline__ void slice_times_a_into(const float* s, const float* __restrict__ a,
                                                   int m, int n, int ns, const float* nu_r,
                                                   float* g, int ld, float* red,
                                                   const float* alpha = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (m + kWarps - 1) / kWarps;
  const int jlo = min(m, warp * per), jhi = min(m, jlo + per);
  for (int ib = 0; ib < ns; ib += kColTile) {
    bool ok[kColLoads];
    const float* col[kColLoads];
#pragma unroll
    for (int u = 0; u < kColLoads; ++u) {
      ok[u] = ib + lane + 32 * u < ns;
      col[u] = a + ib + lane + 32 * u;
    }
    float acc[TB][kColLoads];
#pragma unroll
    for (int r = 0; r < TB; ++r)
#pragma unroll
      for (int u = 0; u < kColLoads; ++u) acc[r][u] = 0.f;
    int j = jlo;
    for (; j + kSliceRows <= jhi; j += kSliceRows) {
      float av[kSliceRows][kColLoads];
#pragma unroll
      for (int b = 0; b < kSliceRows; ++b)
#pragma unroll
        for (int u = 0; u < kColLoads; ++u)
          av[b][u] = ok[u] ? __ldg(col[u] + (size_t)(j + b) * n) : 0.f;
#pragma unroll
      for (int b = 0; b < kSliceRows; ++b)
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          const float sv = s[r * m + j + b];
#pragma unroll
          for (int u = 0; u < kColLoads; ++u) acc[r][u] = fmaf(sv, av[b][u], acc[r][u]);
        }
    }
    for (; j < jhi; ++j) {
      float av[kColLoads];
#pragma unroll
      for (int u = 0; u < kColLoads; ++u) av[u] = ok[u] ? __ldg(col[u] + (size_t)j * n) : 0.f;
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const float sv = s[r * m + j];
#pragma unroll
        for (int u = 0; u < kColLoads; ++u) acc[r][u] = fmaf(sv, av[u], acc[r][u]);
      }
    }
#pragma unroll
    for (int r = 0; r < TB; ++r)
#pragma unroll
      for (int u = 0; u < kColLoads; ++u)
        red[(warp * TB + r) * kColTile + lane + 32 * u] = acc[r][u];
    __syncthreads();
    for (int k = threadIdx.x; k < TB * kColTile; k += kThreads) {
      const int r = k / kColTile, c = k % kColTile;
      if (ib + c < ns) {
        float t = 0.f;
        for (int w = 0; w < kWarps; ++w) t += red[(w * TB + r) * kColTile + c];
        g[r * ld + ib + c] += nu_r[r] * (alpha ? alpha[r] * t : t);
      }
    }
    __syncthreads();
  }
}

}  // namespace fedqcs
