// One fused scalar-variance Q-EM-GAMP iteration on the quantized channel
// (the EA decode of FedQCS, paper Procedure 2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/qgamp_step.py
// (_qgamp_step_kernel, launched by qgamp_step_pallas).  Per block-row:
//   nu_p  = max(alpha^2 / M * sum(nu_g), eps)
//   phat  = alpha * (ghat @ A^T) - nu_p * shat           (product 1, over N)
//   truncated-normal moment match in the observed Lloyd-Max cell, with the
//   far-tail fallback of repro/core/gamp.py::trunc_channel_moments
//   shat' = (xpost - phat) / nu_p;  nu_r = 1 / max(alpha^2 / M * sum(nu_s), eps)
//   rhat  = ghat + nu_r * (alpha * (shat' @ A))          (product 2, over M)
//   GM input channel + EM refresh (gm_prior.cuh)
//
// What bounds it on the card: the two products are 4 * rows * M * N fp32
// FMAs per step (~1.0 GFLOP at the EA decode's 300 x 530 x 1591), about
// 15 us at the 67 TFLOP/s fp32 peak, against ~12 MB of state and A to move
// (~4 us at 3.35 TB/s): compute-bound in principle, and in practice bound by
// how often A (3.4 MB, resident in the 50 MB L2) is streamed from L2.
//
// Design: gamp_step.cu's thread-block cluster structure, with the quantized
// output channel in its step 3.  A cluster of C blocks (C in {1, 2, 4, 8,
// 16}, set at launch) shares a tile of TB rows (TB in {1, 2, 4}); block rank
// k owns the columns [k * ceil(N / C), (k + 1) * ceil(N / C)) clipped to N
// and streams only that slice of A, once per product, for all TB rows, so A
// is read 2 x ceil(nb / TB) times a step, split over C blocks.  One step:
//   1. partial sums of nu_g and partial ghat @ A^T (all M outputs) over the
//      slice; the bin edges go to shared memory;
//   2. a cluster reduction (common.cuh cluster_sum, rank order) gives the
//      full dot products and sum(nu_g), identical in every block, so nu_p is;
//   3. every block runs the output channel on all M lanes (unpack, clamp,
//      trunc_moments) and block-sums nu_s: the same lanes in the same order
//      in every block give the same nu_r, with no cluster reduction; rank 0
//      stores shat';
//   4. product 2 (with the alpha scale) for the block's own slice of rhat;
//   5. the GM posterior on the slice, one cluster reduction for the EM sums,
//      one for the scatter around mu_new; rank 0 stores theta;
//   6. a last cluster.sync(), so no block exits while another still reads
//      its shared memory.
// Step 3 costs C x TB x M erfc/exp lanes per tile, a few us at C = 2.  The
// launch bounds ask for two blocks per SM (<= 128 registers), so 150 blocks
// (300 rows / 4 x 2) run in one wave.  C = 1 is the whole-row structure.  No
// atomics: sums run in a fixed order, so a step is deterministic.  Plain
// fp32 FMAs on the CUDA cores (TF32 would flip codes at the thresholds).
//
// Observation: bits > 0 reads the (rows, W) uint32 wire words and unpacks
// code lane c from word c % W at bit (c / W) * bits in-kernel, so the index
// view never exists in device memory; bits == 0 reads (rows, M) int32 codes.
// The bin-edge lookup is an indexed load from the 2^Q-entry tables in
// shared memory.  A ragged last tile clamps its row index and stores nothing
// for rows past nb.

#include "common.cuh"
#include "gm_prior.cuh"

using namespace fedqcs;
namespace cg = cooperative_groups;

namespace {

constexpr float kTruncClip = 9.0f;

// Truncated-normal posterior of x ~ N(phat, nu_p) given x in (lo, hi]; the
// same steps as trunc_channel_moments (nu_p already clamped positive).
__device__ __forceinline__ void trunc_moments(float phat, float nu_p, float lo, float hi,
                                              float& xpost, float& nu_x) {
  const float inv_sqrt2 = 1.0f / sqrtf(2.0f);
  const float sqrt_2pi = sqrtf(6.28318530717958647692f);
  const float sd = sqrtf(nu_p);
  const float a = (lo - phat) / sd;
  const float b = (hi - phat) / sd;
  const bool far = (a > kTruncClip) | (b < -kTruncClip);
  const float ac = fminf(fmaxf(a, -kTruncClip), kTruncClip);
  const float bc = fminf(fmaxf(b, -kTruncClip), kTruncClip);
  const float z_up = 0.5f * (erfcf(ac * inv_sqrt2) - erfcf(bc * inv_sqrt2));
  const float z_dn = 0.5f * (erfcf(-bc * inv_sqrt2) - erfcf(-ac * inv_sqrt2));
  const float z = fmaxf(ac > 0.f ? z_up : z_dn, 1e-30f);
  const float pa = expf(-0.5f * (ac * ac)) / sqrt_2pi;
  const float pb = expf(-0.5f * (bc * bc)) / sqrt_2pi;
  const float ratio1 = (pa - pb) / z;
  const float ratio2 = (ac * pa - bc * pb) / z;
  float xp, nx;
  if (far) {
    const float amin = fminf(fabsf(a), fabsf(b));
    const float edge = fminf(fmaxf(phat, lo), hi);
    const float inward = phat < lo ? 1.0f : -1.0f;
    xp = edge + inward * sd / fmaxf(amin, 1.0f);
    nx = nu_p / fmaxf(amin * amin, 1.0f);
  } else {
    xp = phat + sd * ratio1;
    nx = nu_p * fmaxf(1.0f + ratio2 - ratio1 * ratio1, 1e-8f);
  }
  xpost = xp;
  nu_x = fminf(nx, nu_p);
}

// Dynamic shared memory of one block, in floats: gamp_step.cu's layout plus
// the two bin-edge tables.
template <int TB>
size_t smem_floats(int n, int m, int cluster, int n_lev) {
  const size_t chunk = (size_t)((n + cluster - 1) / cluster);
  return TB * chunk + 2 * ((size_t)TB * m + TB) + (size_t)kWarps * TB * kColTile +
         2 * (size_t)n_lev;
}

template <int TB>
__global__ void __launch_bounds__(kThreads, 2)
qgamp_step_kernel(const float* __restrict__ ghat, const float* __restrict__ nu_g,
                  const float* __restrict__ shat, const float* __restrict__ theta,
                  const void* __restrict__ obs, const float* __restrict__ alpha,
                  const float* __restrict__ lo_tau, const float* __restrict__ hi_tau,
                  const float* __restrict__ a, float* __restrict__ ghat_out,
                  float* __restrict__ nug_out, float* __restrict__ shat_out,
                  float* __restrict__ theta_out, int nb, int n, int m, int L, int em, int bits,
                  int obs_w, int n_lev) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int chunk = (n + C - 1) / C;
  const int c0 = min(n, rank * chunk);
  const int ns = min(n, c0 + chunk) - c0;  // this block's columns (0 past N)

  extern __shared__ float smem[];
  float* g = smem;                // TB x chunk: the ghat slice, then the rhat slice
  float* part = g + TB * chunk;   // TB x m partial dots, then TB partial sum(nu_g): published
  float* s = part + TB * m + TB;  // the cluster's totals of part: dots, then shat'
  float* red = s + TB * m + TB;   // kWarps x TB x kColTile: product 2's warp partials
  float* lo_s = red + kWarps * TB * kColTile;  // n_lev bin lower edges
  float* hi_s = lo_s + n_lev;                  // n_lev bin upper edges
  __shared__ float scratch[kWarps * kEmSums];
  __shared__ float em_part[TB * kEmSums], em_tot[TB * kEmSums];  // em_part, sc_part: published
  __shared__ float sc_part[TB * kMaxComponents], sc_tot[TB * kMaxComponents];
  __shared__ float al_s[TB], nu_r_s[TB];

  const int tl = 1 + 3 * L;
  const int row0 = (blockIdx.x / C) * TB;
  int rows[TB];
  float al[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    rows[r] = min(row0 + r, nb - 1);
    al[r] = alpha[rows[r]];
  }
  for (int k = threadIdx.x; k < n_lev; k += kThreads) {
    lo_s[k] = lo_tau[k];
    hi_s[k] = hi_tau[k];
  }

  // 1. the slice's partial sum(nu_g) and partial ghat @ A^T
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
  block_sum<TB>(nsum, scratch);  // its barriers also publish g, lo_s, hi_s
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < TB; ++r) part[TB * m + r] = nsum[r];
  }
  slice_dot_a<TB>(g, chunk, a + c0, m, n, ns, part);
  cluster.sync();

  // 2. totals, the same in every block
  cluster_sum(part, TB * m + TB, s);
  __syncthreads();

  // 3. the output channel on all M lanes, in every block; nu_s reduces to
  // the scalar nu_r
  const uint32_t mask = bits ? ((1u << bits) - 1u) : 0u;
  float nus[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    nus[r] = 0.f;
    const bool store = rank == 0 && row0 + r < nb;
    const size_t off = (size_t)rows[r] * m;
    const float np = fmaxf(al[r] * al[r] / m * s[TB * m + r], kEps);
    for (int j = threadIdx.x; j < m; j += kThreads) {
      int code;
      if (bits) {
        const uint32_t word =
            static_cast<const uint32_t*>(obs)[(size_t)rows[r] * obs_w + j % obs_w];
        code = (int)((word >> ((j / obs_w) * bits)) & mask);
      } else {
        code = static_cast<const int*>(obs)[off + j];
      }
      code = min(max(code, 0), n_lev - 1);
      const float phat = al[r] * s[r * m + j] - np * shat[off + j];
      float xpost, nu_x;
      trunc_moments(phat, np, lo_s[code], hi_s[code], xpost, nu_x);
      const float sh = (xpost - phat) / np;
      nus[r] += fmaxf((1.0f - nu_x / np) / np, kEps);
      s[r * m + j] = sh;
      if (store) shat_out[off + j] = sh;
    }
  }
  block_sum<TB>(nus, scratch);  // its barriers also publish shat' in s
  if (threadIdx.x < TB) {
    const int r = threadIdx.x;
    al_s[r] = al[r];
    nu_r_s[r] = 1.0f / fmaxf(al[r] * al[r] / m * nus[r], kEps);
  }
  __syncthreads();

  // 4. rhat on the slice
  slice_times_a_into<TB>(s, a + c0, m, n, ns, nu_r_s, g, chunk, red, al_s);

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
           const void* obs, const float* alpha, const float* lo_tau, const float* hi_tau,
           const float* a, float* ghat_out, float* nug_out, float* shat_out, float* theta_out,
           int nb, int n, int m, int L, int em, int bits, int obs_w, int n_lev, int cluster,
           cudaStream_t stream) {
  return launch_cluster<qgamp_step_kernel<TB>>(
      (unsigned)(((nb + TB - 1) / TB) * cluster), cluster,
      sizeof(float) * smem_floats<TB>(n, m, cluster, n_lev), stream, ghat, nu_g, shat, theta,
      obs, alpha, lo_tau, hi_tau, a, ghat_out, nug_out, shat_out, theta_out, nb, n, m, L, em,
      bits, obs_w, n_lev);
}

}  // namespace

extern "C" int qgamp_step_launch(const float* ghat, const float* nu_g, const float* shat,
                                 const float* theta, const void* obs, const float* alpha,
                                 const float* lo_tau, const float* hi_tau, const float* a,
                                 float* ghat_out, float* nug_out, float* shat_out,
                                 float* theta_out, int nb, int n, int m, int L, int em, int bits,
                                 int obs_w, int n_lev, int rows_per_tile, int cluster,
                                 cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (L < 1 || L > kMaxComponents || n_lev < 1 || n_lev > 256 || bits < 0 || bits > 8)
    return (int)cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16)
    return (int)cudaErrorInvalidClusterSize;
  switch (rows_per_tile) {
#define FEDQCS_CASE(R)                                                                        \
  case R:                                                                                     \
    return launch<R>(ghat, nu_g, shat, theta, obs, alpha, lo_tau, hi_tau, a, ghat_out,      \
                     nug_out, shat_out, theta_out, nb, n, m, L, em, bits, obs_w, n_lev,      \
                     cluster, stream);
    FEDQCS_CASE(1)
    FEDQCS_CASE(2)
    FEDQCS_CASE(4)
#undef FEDQCS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
