// Shared device helpers of the FedQCS kernels: block-wide and cluster-wide
// reductions, the bisection top-S threshold and keep rule of the two
// encoders, the row-times-A products of a GAMP step split by columns over a
// thread-block cluster, the register-tiled fp32 tile product of the staged
// encoder, and the host-side launch of a kernel on thread-block clusters.
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

constexpr int kLevels = 7;                         // levels per pass (PERF.md: the sweep)
constexpr int kPivots = (1 << kLevels) - 1;
constexpr int kBinsPerLane = (kPivots + 1 + 31) / 32;  // bins 0..kPivots over a warp
constexpr int kRowChunk = 8;  // elements a thread holds at once: N = 1591 in one chunk

// Marks the chunk's elements inside [lo, hi) and counts those at or above hi.
__device__ __forceinline__ unsigned chunk_between(const float (&v)[kRowChunk], float lo, float hi,
                                                  int& n_top) {
  unsigned inner = 0u;
#pragma unroll
  for (int e = 0; e < kRowChunk; ++e) {
    n_top += v[e] >= hi ? 1 : 0;
    inner |= v[e] >= lo && v[e] < hi ? 1u << e : 0u;
  }
  return inner;
}

// Adds the marked elements to bin c of h, c = the number of the np sorted
// pivots p <= v.  The pivots lie near lo + t / scale, so c starts from the
// estimate (v - lo) * scale and is checked against its two neighbouring
// pivots; it steps on only where they crowd (an interval a few ulps wide).
__device__ __forceinline__ void chunk_count(const float (&v)[kRowChunk], unsigned inner, float lo,
                                            float scale, const float* p, int np, int* h) {
  if (!__any_sync(0xffffffffu, inner != 0u)) return;
  int c[kRowChunk];
  float below[kRowChunk], above[kRowChunk];
#pragma unroll
  for (int e = 0; e < kRowChunk; ++e) {
    c[e] = (int)fminf(fmaxf((v[e] - lo) * scale, 0.f), (float)np);
    below[e] = c[e] > 0 ? p[c[e] - 1] : 0.f;                            // pivot c
    above[e] = c[e] < np ? p[c[e]] : __int_as_float(0x7f800000);  // pivot c + 1
  }
#pragma unroll
  for (int e = 0; e < kRowChunk; ++e) {
    if (inner >> e & 1u) {
      if (!(below[e] <= v[e] && v[e] < above[e])) {
        while (c[e] < np && p[c[e]] <= v[e]) ++c[e];
        while (c[e] > 0 && p[c[e] - 1] > v[e]) --c[e];
      }
      atomicAdd(&h[c[e]], 1);
    }
  }
}

// Top-S threshold of one row held in shared memory, by the plain version's
// exact fp32 bisection (kernels/ref.py::block_topk_ref) run in passes of
// kLevels levels.  The plain version halves [0, mx] iters times: mid =
// 0.5f * (lo + hi), and count(|x| >= mid) > S moves lo up, else hi down.
// Its midpoints form a binary tree: a node's midpoint follows from the
// decisions above it alone, and an in-order listing of a subtree's
// midpoints is non-decreasing (round-to-nearest keeps each midpoint inside
// its interval).  So a pass of lv = min(kLevels, iters - done) levels
//   1. writes the np = 2^lv - 1 midpoints of the next lv levels in in-order
//      order, each from its own node's (lo, hi) with the plain version's two
//      rounded operations (__fadd_rn, __fmul_rn: nothing to contract);
//   2. counts |x| >= p for all of them in one sweep over the row.  With c
//      the number of pivots <= |x|, count(|x| >= pivot t) = #(c >= t).
//      Every pivot lies in [lo, hi], so c = 0 below lo and c = np at or
//      above hi (counted in registers, one word a warp); only elements in
//      [lo, hi) need c and go to bin c of a shared histogram -- all of them
//      in the first pass, a few a row after it (the (S+1)-th largest always
//      stays inside).  c is found from the estimate (|x| - lo) 2^lv /
//      (hi - lo), checked against its two neighbouring pivots;
//   3. walks the lv levels with those counts.  The walk's test, count > S,
//      holds for a prefix 1..T of the in-order pivots (the counts do not
//      rise along them), and a descent of the tree on such a test ends
//      between pivots T and T + 1, both on its path: lo becomes pivot T and
//      hi pivot T + 1 (each unchanged where T = 0 or T = np).  So each warp
//      sums the histogram's suffixes with shuffles and counts T with ballots.
// The result is the (lo, hi) of lv sequential halvings, bit for bit.  Counts
// are exact integers, so the order of the shared atomics cannot move them;
// every warp reads the same bins, so all threads hold the same (lo, hi) and
// control flow stays uniform.  A pass costs two barriers (the plain loop:
// two per level); the pivots and the histogram alternate between two
// buffers, so a pass need not wait for the last one's readers.  The first
// kRowChunk elements of each thread stay in registers for every pass.
// scratch is not used (the passes keep their own shared arrays).  Returns
// hi, the same on every thread.  Both encoders (bqcs_encode_fused.cu,
// block_topk.cu) call it, so their kept sets are the same bits.
__device__ __forceinline__ float topk_threshold(const float* row, int n, int s, int iters,
                                                float mx, float* /*scratch*/) {
  __shared__ float piv[2][kPivots];
  __shared__ int hist[2][32 * kBinsPerLane];
  __shared__ int tops[2][kWarps];  // each warp's count of |x| >= hi (bin np)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kChunk = kRowChunk * kThreads;
  // -1 (past the row) lies below every pivot
  float v0[kRowChunk];
#pragma unroll
  for (int e = 0; e < kRowChunk; ++e) {
    const int i = e * kThreads + threadIdx.x;
    v0[e] = i < n ? fabsf(row[i]) : -1.f;
  }
  float lo = 0.f, hi = mx;
  for (int done = 0, buf = 0; done < iters; buf ^= 1) {
    const int lv = min(kLevels, iters - done);
    const int np = (1 << lv) - 1, root = 1 << (lv - 1);  // in-order positions 1..np
    float* p = piv[buf];
    int* h = hist[buf];
    // 1. pivot t at p[t - 1], found by descending from the root as the plain
    //    loop would (lv steps on every thread, no divergence); bins 1..np
    //    cleared.  Marking the first chunk needs no pivot, so it overlaps.
    for (int t = threadIdx.x + 1; t <= np; t += kThreads) {
      float l = lo, u = hi, at_t = 0.f;
      for (int d = 0, node = root, step = root >> 1; d < lv; ++d, step >>= 1) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(l, u));
        at_t = node == t ? mid : at_t;  // below t the descent turns left for good
        const bool right = t > node;
        l = right ? mid : l;
        u = right ? u : mid;
        node += right ? step : -step;
      }
      p[t - 1] = at_t;
      h[t] = 0;
    }
    int n_top = 0;
    const unsigned inner0 = chunk_between(v0, lo, hi, n_top);
    __syncthreads();
    // 2. bin c for the elements in [lo, hi); the rest are counted in n_top
    const float scale = (float)(np + 1) / (hi - lo);
    chunk_count(v0, inner0, lo, scale, p, np, h);
    for (int i0 = kChunk; i0 < n; i0 += kChunk) {
      float v[kRowChunk];
#pragma unroll
      for (int e = 0; e < kRowChunk; ++e) {
        const int i = i0 + e * kThreads + threadIdx.x;
        v[e] = i < n ? fabsf(row[i]) : -1.f;
      }
      chunk_count(v, chunk_between(v, lo, hi, n_top), lo, scale, p, np, h);
    }
    n_top = (int)__reduce_add_sync(0xffffffffu, (unsigned)n_top);
    if (lane == 0) tops[buf][warp] = n_top;
    __syncthreads();
    // 3. sfx[k] = count(|x| >= pivot b) for this lane's bins b = lane * kBinsPerLane + k
    int n_hi = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n_hi += tops[buf][w];
    int sfx[kBinsPerLane], tot = 0;
#pragma unroll
    for (int k = kBinsPerLane - 1; k >= 0; --k) {
      const int b = lane * kBinsPerLane + k;
      tot += (b >= 1 && b <= np) ? h[b] + (b == np ? n_hi : 0) : 0;
      sfx[k] = tot;
    }
    int above = tot;  // then the sum over lanes >= this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_down_sync(0xffffffffu, above, o);
      above += lane + o < 32 ? x : 0;
    }
    above -= tot;
    int t_up = 0;  // T: the pivots whose count exceeds S
#pragma unroll
    for (int k = 0; k < kBinsPerLane; ++k) {
      const int b = lane * kBinsPerLane + k;
      t_up += __popc(__ballot_sync(0xffffffffu, b >= 1 && b <= np && sfx[k] + above > s));
    }
    if (t_up > 0) lo = p[t_up - 1];
    if (t_up < np) hi = p[t_up];
    done += lv;
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

// The same sum for a slice: s[j] = sum of part[lo + threadIdx.x + kThreads j]
// over the blocks of this cluster, in rank order 0..C-1, for j < per (per <=
// P), under the same rules as cluster_sum.  Blocks may reduce different
// slices.  A thread keeps its P loads from one rank in flight at once, where
// cluster_sum keeps one element's C loads in flight: the staged encoder's
// slice is many elements a thread and few ranks.
template <int P>
__device__ __forceinline__ void cluster_sum_slice(const float* part, int lo, int per,
                                                  float (&s)[P]) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
#pragma unroll
  for (int j = 0; j < P; ++j) s[j] = 0.f;
  for (int q = 0; q < c; ++q) {
    const float* src = cluster.map_shared_rank(part, q) + lo + threadIdx.x;
    float v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = j < per ? src[kThreads * j] : 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) s[j] += v[j];
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

// -- the register-tiled fp32 tile product ---------------------------------
//
// A block of kThreads threads computes one kTileRows x kTileCols tile of X @
// B over a K range [k_lo, k_hi): X row-major with row stride ldx, B
// row-major with row stride ldb, both in device memory.  What sets the pace
// of such a product is the shared-memory datapath (128 bytes a clock an SM,
// however many lanes share an address): a thread that holds a x b outputs
// loads a + b values per k for a b FMAs.  So each thread holds 8 x 8 outputs
// in registers (4 16-byte shared loads feed 64 FMAs, which just balances the
// SM's 128 FMAs a clock), and the block's threads form kTileGroups groups of
// 64 threads that each cover the whole tile and split every stage's K step
// between them: group g takes its kTileGroupK consecutive k.  Thread (ty,
// tx) of a group holds rows h 32 + 4 ty + i and columns h' 32 + 4 tx + j (h,
// h' < 2; i, j < 4); the 8 lanes of a quarter warp share ty, so their loads
// of X are broadcasts and their loads of B one 128-byte row segment.  Each
// sum runs over its k in increasing order with IEEE fmaf (no TF32).  The
// caller adds the groups' partial tiles.
//
// The K range is walked in steps of kTileK through a ring of kStages stages
// in shared memory, filled with 4-byte cp.async while the previous stage is
// multiplied (rows of X and B need not be 16-byte aligned: at the paper's
// shape they are 6364 and 2120 bytes long); one barrier per stage.  X is
// staged transposed (k-major, rows padded to kTileXStride floats), so a
// thread's 4 rows at one k are one 16-byte load; each copy instruction of a
// warp takes 8 k of 4 rows (four 32-byte sectors of X), which the padding
// spreads over all 32 banks.  Entries past k_hi, past x_rows rows or past
// b_cols columns are zero-filled.  On the H100 the copies and the product's
// shared loads add up rather than overlap (they share the SM's L1 and
// shared-memory path; tools/probe_staged_encode.py, PERF.md); versions with
// 16-byte copies, more stages, a 64-deep K step, 128-column tiles or the
// copies spread between the FMAs were no faster.  The PROBE: comments mark
// the lines that the probe's cut-down builds skip.
constexpr int kTileRows = 64;  // output rows of a tile
constexpr int kTileCols = 64;  // output columns of a tile
constexpr int kTileK = 32;     // K step, one ring stage
constexpr int kStages = 3;
constexpr int kTileGroups = kThreads / 64;              // groups that split each K step
constexpr int kTileGroupK = kTileK / kTileGroups;       // k of a stage per group
constexpr int kTileXStride = kTileRows + 4;             // floats per k of the staged X
constexpr int kTileStage = kTileK * kTileXStride + kTileK * kTileCols;
constexpr int kTileRing = kStages * kTileStage;         // floats of the ring

// 4 bytes from src to dst, or 4 zero bytes when !full (src is not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Queues this thread's copies of one stage: X rows r < kTileRows and k in
// [k0, k0 + kTileK) to xs[k * kTileXStride + r] (lane l of warp w takes rows
// l / 8 + 4 w + 32 u and k0 + l % 8 + 8 v: each copy instruction of a warp
// reads 8 k of 4 rows and writes all 32 banks), then B rows k0 + kk, columns
// c < kTileCols (thread t takes column t % 64 of rows t / 64 + 4 j).
__device__ __forceinline__ void tile_load_stage(float* st, const float* __restrict__ x, int ldx,
                                                int x_rows, const float* __restrict__ b, int ldb,
                                                int b_cols, int k0, int k_hi) {
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kTileRows * kTileK / kThreads; ++i) {
    const int r = (lane >> 3) + 4 * warp + 32 * (i / (kTileK / 8));
    const int kk = (lane & 7) + 8 * (i % (kTileK / 8));
    const bool ok = r < x_rows && k0 + kk < k_hi;
    cp_async4(st + kk * kTileXStride + r, ok ? x + (size_t)r * ldx + k0 + kk : x, ok);
  }
  const int c = (int)threadIdx.x & (kTileCols - 1);
#pragma unroll
  for (int i = 0; i < kTileK * kTileCols / kThreads; ++i) {
    const int kk = (int)threadIdx.x / kTileCols + (kThreads / kTileCols) * i;
    const bool ok = k0 + kk < k_hi && c < b_cols;
    cp_async4(st + kTileK * kTileXStride + kk * kTileCols + c,
              ok ? b + (size_t)(k0 + kk) * ldb + c : b, ok);
  }
}

// This thread's place in the tile: its group, and (ty, tx) inside it.
struct TileThread {
  int g, ty, tx;
  __device__ __forceinline__ TileThread()
      : g((int)threadIdx.x / 64), ty((int)threadIdx.x % 64 / 8), tx((int)threadIdx.x % 8) {}
  // output row of acc[a][.] and column of acc[.][b] within the tile
  __device__ __forceinline__ int row(int a) const {
    return (a >> 2) * (kTileRows / 2) + 4 * ty + (a & 3);
  }
  __device__ __forceinline__ int col(int b) const {
    return (b >> 2) * (kTileCols / 2) + 4 * tx + (b & 3);
  }
};

// acc[a][b] += sum over this group's k of the stage of X[row(a)][k] B[k][col(b)]
__device__ __forceinline__ void tile_mul_stage(const float* st, const TileThread& th,
                                               float (&acc)[8][8]) {
  const float* xs = st + th.g * kTileGroupK * kTileXStride + 4 * th.ty;
  const float* bs = st + kTileK * kTileXStride + th.g * kTileGroupK * kTileCols + 4 * th.tx;
#pragma unroll
  for (int kk = 0; kk < kTileGroupK; ++kk) {
    const float4 x0 = *reinterpret_cast<const float4*>(xs + kk * kTileXStride);
    const float4 x1 = *reinterpret_cast<const float4*>(xs + kk * kTileXStride + kTileRows / 2);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kTileCols);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kTileCols + kTileCols / 2);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(xv[a], bv[b], acc[a][b]);
  }
}

// acc = this group's part of X[0:x_rows, k_lo:k_hi] @ B[k_lo:k_hi, 0:b_cols]
// for this thread's outputs (TileThread::row, col; zero past x_rows and
// b_cols): the sum over the k that the group takes from each stage.  x points
// at the tile's first row, b at its first column; ring holds kTileRing floats
// of shared memory, 16-byte aligned.  on_stage(xs) is called by every thread
// once per stage, after the barrier that makes the stage visible: xs is the
// stage's X tile, xs[k * kTileXStride + r] for k < kTileK, r < kTileRows,
// zero past the range.  Ends with a barrier, so the caller may reuse the
// ring.  Needs k_lo <= k_hi.
template <class StageFn>
__device__ __forceinline__ void tile_product(const float* __restrict__ x, int ldx, int x_rows,
                                             const float* __restrict__ b, int ldb, int b_cols,
                                             int k_lo, int k_hi, float* ring, const TileThread& th,
                                             float (&acc)[8][8], StageFn&& on_stage) {
  const int steps = (k_hi - k_lo + kTileK - 1) / kTileK;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      tile_load_stage(ring + s * kTileStage, x, ldx, x_rows, b, ldb, b_cols, k_lo + s * kTileK,
                      k_hi);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage t have landed
    __syncthreads();               // everyone's have, and stage t - 1 is no longer read
    const int next = t + kStages - 1;
    if (next < steps)  // PROBE:staging
      tile_load_stage(ring + (next % kStages) * kTileStage, x, ldx, x_rows, b, ldb, b_cols,
                      k_lo + next * kTileK, k_hi);
    cp_async_commit();
    const float* st = ring + (t % kStages) * kTileStage;
    on_stage(st);
    tile_mul_stage(st, th, acc);  // PROBE:product
  }
  cp_async_wait<0>();
  __syncthreads();
}

// -- host: launching a kernel on thread-block clusters ---------------------
//
// Launches Kernel on a 1-D grid of `blocks` blocks of kThreads threads, in
// which each run of `cluster` consecutive blocks is one thread-block cluster,
// with `smem` bytes of dynamic shared memory, on `stream`.  Returns the CUDA
// error: cudaErrorInvalidClusterSize when no such cluster fits on the card
// (the caller raises; there is no smaller fallback).  Setting the
// attributes and checking the fit cost host time, and a caller repeats one
// shape, so they run only when a launch needs more than was set or checked
// before in this process (a cluster that fits fits with less shared
// memory).  Those records are statics of this instantiation, so each kernel
// keeps its own.
template <auto Kernel, typename... Args>
int launch_cluster(unsigned blocks, int cluster, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidClusterSize;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  static size_t attr_smem = 0, checked[kMaxCluster + 1] = {};
  static bool non_portable = false;
  cudaError_t e;
  if (smem > attr_smem) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_smem = smem;
  }
  if (cluster > 8 && !non_portable) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    non_portable = true;
  }
  if (smem > checked[cluster]) {
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, Kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) return (int)cudaErrorInvalidClusterSize;
    checked[cluster] = smem;
  }
  e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace fedqcs
