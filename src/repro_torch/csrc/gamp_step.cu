// One fused scalar-variance EM-GAMP iteration on the AWGN channel (the AE
// decode of FedQCS, paper Sec. IV-B), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/gamp_step.py
// (_gamp_step_kernel, launched by gamp_step_pallas).  Per block-row:
//   nu_p  = max(sum(nu_g) / M, eps)
//   phat  = ghat @ A^T - nu_p * shat                     (product 1, over N)
//   xpost = (phat nu_d + y nu_p) / (nu_p + nu_d);  nu_x = nu_p nu_d / (nu_p + nu_d)
//   shat' = (xpost - phat) / nu_p;  nu_r = 1 / max((1 - nu_x / nu_p) / nu_p, eps)
//   rhat  = ghat + nu_r * (shat' @ A)                    (product 2, over M)
//   GM input channel + EM refresh (gm_prior.cuh)
//
// What bounds it on the card: at the paper's width the AE decode has only
// nb = 10 rows, so one step is ~34 MFLOP (0.5 us at the fp32 peak) against
// the 3.4 MB of A that must be read (~1.1 us at 3.35 TB/s): memory-bound in
// principle, and in practice bound by how fast the SMs that run it can
// stream A from L2.  Whole rows per block put 10 rows on 10 SMs.
//
// Design: a thread-block cluster of C blocks (C in {1, 2, 4, 8, 16}, set at
// launch) shares a tile of TB rows (TB in {1, 2, 4}); block rank k owns the
// columns [k * ceil(N / C), (k + 1) * ceil(N / C)) clipped to N, and streams
// only that slice of A, once per product, for all TB rows.  The grid is
// (row tiles) x C, so 10 rows at TB = 1, C = 8 read A on 80 SMs at once.
// One step:
//   1. partial sums of nu_g and partial phat (all M outputs) over the slice;
//   2. a cluster reduction (common.cuh cluster_sum, rank order) gives nu_p
//      and the full phat, identical in every block;
//   3. every block forms all M lanes of shat' (rank 0 stores them);
//   4. product 2 for the block's own slice of rhat;
//   5. the GM posterior on the slice, one cluster reduction for the EM sums,
//      one for the scatter around mu_new; rank 0 stores theta;
//   6. a last cluster.sync(), so no block exits while another still reads
//      its shared memory.
// What bounds the cluster form: each block's slice of A (2 x M x N / C
// floats per step, streamed from L2 with 32 loads in flight per thread),
// and a cost that does not shrink with C: each warp still walks its eighth
// of the M rows of A in ~9 dependent steps per product, plus 2 (em off) to
// 4 cluster barriers and the distributed-shared-memory reads of the
// reductions (C x TB x M floats per block for phat).  On the H100 that
// fixed part is ~27 us of the 34 us step at 10 rows (PERF.md).  The
// launch bounds ask for two blocks per SM (<= 128 registers), so 160 blocks
// (10 rows x 16) or 150 (300 rows / 4 x 2) run in one wave.  C = 1 is the
// whole-row structure.  No atomics: sums run in a fixed order, so a step is
// deterministic.  A ragged last tile clamps its row index and stores
// nothing for rows past nb.

#include "common.cuh"
#include "gm_prior.cuh"

using namespace fedqcs;
namespace cg = cooperative_groups;

namespace {

// Dynamic shared memory of one block, in floats.
template <int TB>
size_t smem_floats(int n, int m, int cluster) {
  const size_t chunk = (size_t)((n + cluster - 1) / cluster);
  return TB * chunk + 2 * ((size_t)TB * m + TB) + (size_t)kWarps * TB * kColTile;
}

template <int TB>
__global__ void __launch_bounds__(kThreads, 2)
gamp_step_kernel(const float* __restrict__ ghat, const float* __restrict__ nu_g,
                 const float* __restrict__ shat, const float* __restrict__ theta,
                 const float* __restrict__ y, const float* __restrict__ nu_d,
                 const float* __restrict__ a, float* __restrict__ ghat_out,
                 float* __restrict__ nug_out, float* __restrict__ shat_out,
                 float* __restrict__ theta_out, int nb, int n, int m, int L, int em) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int chunk = (n + C - 1) / C;
  const int c0 = min(n, rank * chunk);
  const int ns = min(n, c0 + chunk) - c0;  // this block's columns (0 past N)

  extern __shared__ float smem[];
  float* g = smem;                // TB x chunk: the ghat slice, then the rhat slice
  float* part = g + TB * chunk;   // TB x m partial phat, then TB partial sum(nu_g): published
  float* s = part + TB * m + TB;  // the cluster's totals of part: phat, then shat'
  float* red = s + TB * m + TB;   // kWarps x TB x kColTile: product 2's warp partials
  __shared__ float scratch[kWarps * kEmSums];
  __shared__ float em_part[TB * kEmSums], em_tot[TB * kEmSums];  // em_part, sc_part: published
  __shared__ float sc_part[TB * kMaxComponents], sc_tot[TB * kMaxComponents];
  __shared__ float nu_r_s[TB];

  const int tl = 1 + 3 * L;
  const int row0 = (blockIdx.x / C) * TB;
  int rows[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) rows[r] = min(row0 + r, nb - 1);

  // 1. the slice's partial sum(nu_g) and partial phat
  float nsum[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    nsum[r] = 0.f;
    const size_t off = (size_t)rows[r] * n + c0;
    for (int i = threadIdx.x; i < ns; i += kThreads) {
      nsum[r] += nu_g[off + i];
      g[r * chunk + i] = ghat[off + i];
    }
  }
  block_sum<TB>(nsum, scratch);  // its barriers also publish g
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < TB; ++r) part[TB * m + r] = nsum[r];
  }
  slice_dot_a<TB>(g, chunk, a + c0, m, n, ns, part);
  cluster.sync();

  // 2. totals, the same in every block
  cluster_sum(part, TB * m + TB, s);
  __syncthreads();

  // 3. the output channel on all M lanes, in every block
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    const bool store = rank == 0 && row0 + r < nb;
    const size_t off = (size_t)rows[r] * m;
    const float np = fmaxf(s[TB * m + r] / m, kEps), nd = fmaxf(nu_d[rows[r]], kEps);
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const float phat = s[r * m + j] - np * shat[off + j];
      const float xpost = (phat * nd + y[off + j] * np) / (np + nd);
      const float sh = (xpost - phat) / np;
      s[r * m + j] = sh;
      if (store) shat_out[off + j] = sh;
    }
    if (threadIdx.x == 0) {
      const float nu_x = np * nd / (np + nd);
      nu_r_s[r] = 1.0f / fmaxf((1.0f - nu_x / np) / np, kEps);
    }
  }
  __syncthreads();

  // 4. rhat on the slice
  slice_times_a_into<TB>(s, a + c0, m, n, ns, nu_r_s, g, chunk, red);

  // 5. GM input channel on the slice, then the EM refresh over the cluster
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    GmRow row;
    row.load(theta + (size_t)rows[r] * tl, L, nu_r_s[r]);
    const size_t off = (size_t)rows[r] * n + c0;
    gm_input_slice(row, g + r * chunk, ns, row0 + r < nb, ghat_out + off, nug_out + off,
                   em ? em_part + r * kEmSums : nullptr, scratch);
  }
  if (em) {
    cluster.sync();
    cluster_sum(em_part, TB * kEmSums, em_tot);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      GmRow row;
      row.load(theta + (size_t)rows[r] * tl, L, nu_r_s[r]);
      float mu_new[kMaxComponents], safe[kMaxComponents];
      em_means(em_tot + r * kEmSums, L, mu_new, safe);
      gm_scatter_slice(row, g + r * chunk, ns, mu_new, sc_part + r * kMaxComponents, scratch);
    }
    cluster.sync();
    cluster_sum(sc_part, TB * kMaxComponents, sc_tot);
    __syncthreads();
    const int r = threadIdx.x;
    if (rank == 0 && r < TB && row0 + r < nb)
      em_store_theta(em_tot + r * kEmSums, sc_tot + r * kMaxComponents, n, L,
                     theta_out + (size_t)(row0 + r) * tl);
  } else if (rank == 0) {
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      if (row0 + r < nb && threadIdx.x < tl)
        theta_out[(size_t)rows[r] * tl + threadIdx.x] = theta[(size_t)rows[r] * tl + threadIdx.x];
    }
  }

  // 6. no block leaves while another may still read its shared memory
  cluster.sync();
}

// Launches one step at TB rows per tile on clusters of `cluster` blocks
// (common.cuh launch_cluster: a cluster that does not fit on the card
// returns cudaErrorInvalidClusterSize, and the caller raises).
template <int TB>
int launch(const float* ghat, const float* nu_g, const float* shat, const float* theta,
           const float* y, const float* nu_d, const float* a, float* ghat_out, float* nug_out,
           float* shat_out, float* theta_out, int nb, int n, int m, int L, int em, int cluster,
           cudaStream_t stream) {
  return launch_cluster<gamp_step_kernel<TB>>(
      (unsigned)(((nb + TB - 1) / TB) * cluster), cluster,
      sizeof(float) * smem_floats<TB>(n, m, cluster), stream, ghat, nu_g, shat, theta, y, nu_d,
      a, ghat_out, nug_out, shat_out, theta_out, nb, n, m, L, em);
}

}  // namespace

extern "C" int gamp_step_launch(const float* ghat, const float* nu_g, const float* shat,
                                const float* theta, const float* y, const float* nu_d,
                                const float* a, float* ghat_out, float* nug_out, float* shat_out,
                                float* theta_out, int nb, int n, int m, int L, int em,
                                int rows_per_cta, int cluster, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (L < 1 || L > kMaxComponents) return (int)cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16)
    return (int)cudaErrorInvalidClusterSize;
  switch (rows_per_cta) {
#define FEDQCS_CASE(R)                                                                       \
  case R:                                                                                    \
    return launch<R>(ghat, nu_g, shat, theta, y, nu_d, a, ghat_out, nug_out, shat_out,     \
                     theta_out, nb, n, m, L, em, cluster, stream);
    FEDQCS_CASE(1)
    FEDQCS_CASE(2)
    FEDQCS_CASE(4)
#undef FEDQCS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
