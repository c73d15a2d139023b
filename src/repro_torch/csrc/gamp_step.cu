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
// principle, latency-bound in practice.  Design: the same whole-rows-per-
// block structure as qgamp_step (all row reductions in one block, one launch
// per iteration).  With 10 rows that leaves most of the 132 SMs idle; a
// split of N across blocks needs a cross-block reduction for the EM sums and
// nu_p and is left to a later change.

#include "common.cuh"
#include "gm_prior.cuh"

using namespace fedqcs;

namespace {

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
gamp_step_kernel(const float* __restrict__ ghat, const float* __restrict__ nu_g,
                 const float* __restrict__ shat, const float* __restrict__ theta,
                 const float* __restrict__ y, const float* __restrict__ nu_d,
                 const float* __restrict__ a, float* __restrict__ ghat_out,
                 float* __restrict__ nug_out, float* __restrict__ shat_out,
                 float* __restrict__ theta_out, int nb, int n, int m, int L, int em) {
  extern __shared__ float smem[];
  float* g = smem;          // ROWS x n: ghat, then rhat
  float* s = g + ROWS * n;  // ROWS x m: dot products, then shat'
  __shared__ float scratch[kWarps * (1 + 2 * kMaxComponents)];
  __shared__ float one_s[ROWS], nu_r_s[ROWS];

  const int tl = 1 + 3 * L;
  const int row0 = blockIdx.x * ROWS;
  int rows[ROWS];
  float nud[ROWS], nu_p[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    rows[r] = min(row0 + r, nb - 1);
    nud[r] = fmaxf(nu_d[rows[r]], kEps);
  }

  float part[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    part[r] = 0.f;
    const size_t off = (size_t)rows[r] * n;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      part[r] += nu_g[off + i];
      g[r * n + i] = ghat[off + i];
    }
  }
  block_sum<ROWS>(part, scratch);  // its barriers also publish g
#pragma unroll
  for (int r = 0; r < ROWS; ++r) nu_p[r] = fmaxf(part[r] / m, kEps);

  rows_dot_a<ROWS>(g, a, m, n, s);
  __syncthreads();

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool store = row0 + r < nb;
    const size_t off = (size_t)rows[r] * m;
    const float np = nu_p[r], nd = nud[r];
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const float phat = s[r * m + j] - np * shat[off + j];
      const float xpost = (phat * nd + y[off + j] * np) / (np + nd);
      const float sh = (xpost - phat) / np;
      s[r * m + j] = sh;
      if (store) shat_out[off + j] = sh;
    }
  }
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    const float np = nu_p[r], nd = nud[r];
    const float nu_x = np * nd / (np + nd);
    one_s[r] = 1.0f;
    nu_r_s[r] = 1.0f / fmaxf((1.0f - nu_x / np) / np, kEps);
  }
  __syncthreads();

  rows_times_a_into<ROWS>(s, a, m, n, nu_r_s, one_s, g);
  __syncthreads();

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool store = row0 + r < nb;
    const size_t off = (size_t)rows[r] * n;
    gm_input_and_em(g + r * n, nu_r_s[r], theta + (size_t)rows[r] * tl, n, L, em != 0, store,
                    ghat_out + off, nug_out + off, theta_out + (size_t)rows[r] * tl, scratch);
  }
}

template <int ROWS>
int launch(const float* ghat, const float* nu_g, const float* shat, const float* theta,
           const float* y, const float* nu_d, const float* a, float* ghat_out, float* nug_out,
           float* shat_out, float* theta_out, int nb, int n, int m, int L, int em,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)ROWS * (n + m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gamp_step_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (nb + ROWS - 1) / ROWS;
  gamp_step_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
      ghat, nu_g, shat, theta, y, nu_d, a, ghat_out, nug_out, shat_out, theta_out, nb, n, m, L,
      em);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gamp_step_launch(const float* ghat, const float* nu_g, const float* shat,
                                const float* theta, const float* y, const float* nu_d,
                                const float* a, float* ghat_out, float* nug_out, float* shat_out,
                                float* theta_out, int nb, int n, int m, int L, int em,
                                int rows_per_cta, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (L < 1 || L > kMaxComponents) return (int)cudaErrorInvalidValue;
  switch (rows_per_cta) {
#define FEDQCS_CASE(R)                                                                     \
  case R:                                                                                  \
    return launch<R>(ghat, nu_g, shat, theta, y, nu_d, a, ghat_out, nug_out, shat_out,   \
                     theta_out, nb, n, m, L, em, stream);
    FEDQCS_CASE(1)
    FEDQCS_CASE(2)
#undef FEDQCS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
