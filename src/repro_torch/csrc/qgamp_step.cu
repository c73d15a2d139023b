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
// FMAs per step (~1.0 GFLOP at 300 x 530 x 1591), about 15 us at the
// 67 TFLOP/s fp32 peak, against ~12 MB of state and A to move (~4 us at
// 3.35 TB/s): it is compute-bound, and A (3.4 MB) stays in the 50 MB L2
// across blocks.  Design: a block owns ROWS whole block-rows, so every row
// reduction (sum nu_g, sum nu_s, the EM sums) stays inside the block and one
// launch is one full iteration.  A block streams A from L2 twice (once per
// product) and uses each loaded element for all its ROWS rows, so ROWS
// divides the L2 traffic; the state rows live in shared memory between the
// two products.  ROWS is 1 or 2: 2 when that still gives every SM a block
// (the decode's 300 EA rows), else 1 (the wrapper's rows_per_cta picks).  Plain fp32 FMAs on the CUDA cores (no tensor cores: TF32
// would flip codes at the thresholds), no cp.async/TMA yet.
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

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
qgamp_step_kernel(const float* __restrict__ ghat, const float* __restrict__ nu_g,
                  const float* __restrict__ shat, const float* __restrict__ theta,
                  const void* __restrict__ obs, const float* __restrict__ alpha,
                  const float* __restrict__ lo_tau, const float* __restrict__ hi_tau,
                  const float* __restrict__ a, float* __restrict__ ghat_out,
                  float* __restrict__ nug_out, float* __restrict__ shat_out,
                  float* __restrict__ theta_out, int nb, int n, int m, int L, int em, int bits,
                  int obs_w, int n_lev) {
  extern __shared__ float smem[];
  float* g = smem;                 // ROWS x n: ghat, then rhat
  float* s = g + ROWS * n;         // ROWS x m: dot products, then shat'
  float* lo_s = s + ROWS * m;      // n_lev bin lower edges
  float* hi_s = lo_s + n_lev;      // n_lev bin upper edges
  __shared__ float scratch[kWarps * (1 + 2 * kMaxComponents)];
  __shared__ float al_s[ROWS], nu_r_s[ROWS];

  const int tl = 1 + 3 * L;
  const int row0 = blockIdx.x * ROWS;
  int rows[ROWS];
  float al[ROWS], nu_p[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    rows[r] = min(row0 + r, nb - 1);
    al[r] = alpha[rows[r]];
  }
  for (int k = threadIdx.x; k < n_lev; k += kThreads) {
    lo_s[k] = lo_tau[k];
    hi_s[k] = hi_tau[k];
  }

  // nu_p from the row sums of nu_g; stage ghat rows in shared memory.
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
  block_sum<ROWS>(part, scratch);  // its barriers also publish g, lo_s, hi_s
#pragma unroll
  for (int r = 0; r < ROWS; ++r) nu_p[r] = fmaxf(al[r] * al[r] / m * part[r], kEps);

  rows_dot_a<ROWS>(g, a, m, n, s);
  __syncthreads();

  // Output channel, entry by entry; nu_s reduces to the scalar nu_r.
  const uint32_t mask = bits ? ((1u << bits) - 1u) : 0u;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    part[r] = 0.f;
    const bool store = row0 + r < nb;
    const size_t off = (size_t)rows[r] * m;
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
      const float phat = al[r] * s[r * m + j] - nu_p[r] * shat[off + j];
      float xpost, nu_x;
      trunc_moments(phat, nu_p[r], lo_s[code], hi_s[code], xpost, nu_x);
      const float sh = (xpost - phat) / nu_p[r];
      part[r] += fmaxf((1.0f - nu_x / nu_p[r]) / nu_p[r], kEps);
      s[r * m + j] = sh;
      if (store) shat_out[off + j] = sh;
    }
  }
  block_sum<ROWS>(part, scratch);  // its barriers also publish shat' in s
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    al_s[r] = al[r];
    nu_r_s[r] = 1.0f / fmaxf(al[r] * al[r] / m * part[r], kEps);
  }
  __syncthreads();

  rows_times_a_into<ROWS>(s, a, m, n, nu_r_s, al_s, g);
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
           const void* obs, const float* alpha, const float* lo_tau, const float* hi_tau,
           const float* a, float* ghat_out, float* nug_out, float* shat_out, float* theta_out,
           int nb, int n, int m, int L, int em, int bits, int obs_w, int n_lev,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)ROWS * (n + m) + 2 * (size_t)n_lev);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(qgamp_step_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (nb + ROWS - 1) / ROWS;
  qgamp_step_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
      ghat, nu_g, shat, theta, obs, alpha, lo_tau, hi_tau, a, ghat_out, nug_out, shat_out,
      theta_out, nb, n, m, L, em, bits, obs_w, n_lev);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qgamp_step_launch(const float* ghat, const float* nu_g, const float* shat,
                                 const float* theta, const void* obs, const float* alpha,
                                 const float* lo_tau, const float* hi_tau, const float* a,
                                 float* ghat_out, float* nug_out, float* shat_out,
                                 float* theta_out, int nb, int n, int m, int L, int em, int bits,
                                 int obs_w, int n_lev, int rows_per_cta, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (L < 1 || L > kMaxComponents || n_lev < 1 || n_lev > 256 || bits < 0 || bits > 8)
    return (int)cudaErrorInvalidValue;
  switch (rows_per_cta) {
#define FEDQCS_CASE(R)                                                                        \
  case R:                                                                                     \
    return launch<R>(ghat, nu_g, shat, theta, obs, alpha, lo_tau, hi_tau, a, ghat_out,      \
                     nug_out, shat_out, theta_out, nb, n, m, L, em, bits, obs_w, n_lev, stream);
    FEDQCS_CASE(1)
    FEDQCS_CASE(2)
#undef FEDQCS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
