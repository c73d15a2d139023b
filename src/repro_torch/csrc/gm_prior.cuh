// Input side shared by the two GAMP step kernels: the Bernoulli
// Gaussian-mixture posterior (paper eq. 11) and the EM hyperparameter
// refresh (eq. 17), on the packed theta layout
//
//     theta = [lam0 | lam_1..L | mu_1..L | phi_1..L]   (1 + 3L floats per row).
//
// Replaces repro/kernels/gm_prior.py (gm_input_channel, em_refresh), whose
// functions the Pallas kernels inline.  The steps and clamps follow the
// plain version (repro_torch/kernels/gm_prior.py) line for line: lam0 in
// [1e-6, 1 - 1e-6], lam >= 1e-8, phi >= 1e-12, and the EM variance is the
// scatter around the SAME-STEP refreshed mean mu_new.  Sums over N run in
// another order than the plain version's, so results agree to float
// rounding, not bit for bit.
#pragma once

#include "common.cuh"

namespace fedqcs {

constexpr int kMaxComponents = 8;  // L <= 8 (the paper uses L = 3)
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

struct GmRow {
  int L;
  float v;  // nu_r, the scalar input-channel variance of this row
  float lam0, lam[kMaxComponents], mu[kMaxComponents], phi[kMaxComponents];
  float var[kMaxComponents];    // max(v + phi_l, eps)
  float coef[kMaxComponents];   // lam_l / sqrt(2 pi var_l)
  float coef0;                  // lam0 / sqrt(2 pi v)

  __device__ __forceinline__ void load(const float* th, int L_, float v_) {
    L = L_;
    v = v_;
    lam0 = th[0];
    coef0 = lam0 * (kInvSqrt2Pi * rsqrtf(v));
#pragma unroll
    for (int l = 0; l < kMaxComponents; ++l) {
      if (l < L) {
        lam[l] = th[1 + l];
        mu[l] = th[1 + L + l];
        phi[l] = th[1 + 2 * L + l];
        var[l] = fmaxf(v + phi[l], kEps);
        coef[l] = lam[l] * (kInvSqrt2Pi * rsqrtf(var[l]));
      }
    }
  }

  // Posterior of one entry: weights lp0/lp_l, component means mp_l and
  // variances pp_l given rhat = r.
  __device__ __forceinline__ void posterior(float r, float& lp0, float (&lp)[kMaxComponents],
                                            float (&mp)[kMaxComponents],
                                            float (&pp)[kMaxComponents]) const {
    const float beta0 = coef0 * expf(-0.5f * r * r / v);
    float bsum = 0.f;
#pragma unroll
    for (int l = 0; l < kMaxComponents; ++l) {
      if (l < L) {
        const float d = r - mu[l];
        lp[l] = coef[l] * expf(-0.5f * d * d / var[l]);
        bsum += lp[l];
      }
    }
    const float denom = fmaxf(beta0 + bsum, kEps);
    lp0 = beta0 / denom;
#pragma unroll
    for (int l = 0; l < kMaxComponents; ++l) {
      if (l < L) {
        lp[l] = lp[l] / denom;
        mp[l] = (r * phi[l] + mu[l] * v) / var[l];
        pp[l] = v * phi[l] / var[l];
      }
    }
  }
};

// --- The input side of a row split over a thread-block cluster -------------
// Each block of the cluster holds one column slice of the row.  The EM
// refresh needs two row sums, each one cluster reduction (common.cuh
// cluster_sum) of the blocks' partials: the em sums below, then the scatter
// around mu_new.  With a cluster of one block the slice is the whole row.

constexpr int kEmSums = 1 + 2 * kMaxComponents;  // [sum lp0 | sum lp_l | sum lp_l mp_l]

// Part 1: the posterior of the ns entries of this block's slice (rhat in
// shared memory), stored to ghat_out/nug_out when `store`, and, when em_part
// is given, this block's em sums written there by thread 0.
__device__ __forceinline__ void gm_input_slice(const GmRow& row, const float* rhat, int ns,
                                               bool store, float* __restrict__ ghat_out,
                                               float* __restrict__ nug_out, float* em_part,
                                               float* scratch) {
  float acc[kEmSums];
#pragma unroll
  for (int k = 0; k < kEmSums; ++k) acc[k] = 0.f;
  float lp0, lp[kMaxComponents], mp[kMaxComponents], pp[kMaxComponents];
  for (int i = threadIdx.x; i < ns; i += kThreads) {
    row.posterior(rhat[i], lp0, lp, mp, pp);
    float gh = 0.f, second = 0.f;
#pragma unroll
    for (int l = 0; l < kMaxComponents; ++l) {
      if (l < row.L) {
        gh += lp[l] * mp[l];
        second += lp[l] * (pp[l] + mp[l] * mp[l]);
        acc[1 + l] += lp[l];
        acc[1 + kMaxComponents + l] += lp[l] * mp[l];
      }
    }
    acc[0] += lp0;
    if (store) {
      ghat_out[i] = gh;
      nug_out[i] = fmaxf(second - gh * gh, kEps);
    }
  }
  if (em_part == nullptr) return;
  block_sum<kEmSums>(acc, scratch);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kEmSums; ++k) em_part[k] = acc[k];
  }
}

// The refreshed means from the cluster's em sums `tot`.
__device__ __forceinline__ void em_means(const float* tot, int L, float (&mu_new)[kMaxComponents],
                                         float (&safe)[kMaxComponents]) {
#pragma unroll
  for (int l = 0; l < kMaxComponents; ++l) {
    if (l < L) {
      safe[l] = fmaxf(tot[1 + l], kEps);
      mu_new[l] = tot[1 + kMaxComponents + l] / safe[l];
    }
  }
}

// Part 2: this block's scatter around mu_new over its slice, written to
// sc_part (kMaxComponents floats) by thread 0.
__device__ __forceinline__ void gm_scatter_slice(const GmRow& row, const float* rhat, int ns,
                                                 const float (&mu_new)[kMaxComponents],
                                                 float* sc_part, float* scratch) {
  float sc[kMaxComponents];
#pragma unroll
  for (int l = 0; l < kMaxComponents; ++l) sc[l] = 0.f;
  float lp0, lp[kMaxComponents], mp[kMaxComponents], pp[kMaxComponents];
  for (int i = threadIdx.x; i < ns; i += kThreads) {
    row.posterior(rhat[i], lp0, lp, mp, pp);
#pragma unroll
    for (int l = 0; l < kMaxComponents; ++l) {
      if (l < row.L) {
        const float d = mu_new[l] - mp[l];
        sc[l] += lp[l] * (d * d + pp[l]);
      }
    }
  }
  block_sum<kMaxComponents>(sc, scratch);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxComponents; ++l) sc_part[l] = sc[l];
  }
}

// Part 3, one thread: the refreshed theta of an n-entry row from the
// cluster's em sums and scatter sums, with the plain version's clamps.
__device__ __forceinline__ void em_store_theta(const float* em_tot, const float* sc_tot, int n,
                                               int L, float* __restrict__ theta_out) {
  float mu_new[kMaxComponents], safe[kMaxComponents];
  em_means(em_tot, L, mu_new, safe);
  const float nf = (float)n;
  const float lam0_new = fminf(fmaxf(em_tot[0] / nf, 1e-6f), 1.0f - 1e-6f);
  float lam_new[kMaxComponents], total_lam = 0.f;
  for (int l = 0; l < L; ++l) {
    lam_new[l] = fmaxf(em_tot[1 + l] / nf, 1e-8f);
    total_lam += lam_new[l];
  }
  const float total = fmaxf(lam0_new + total_lam, kEps);
  theta_out[0] = lam0_new / total;
  for (int l = 0; l < L; ++l) {
    theta_out[1 + l] = lam_new[l] / total;
    theta_out[1 + L + l] = mu_new[l];
    theta_out[1 + 2 * L + l] = fmaxf(sc_tot[l] / safe[l], kEps);
  }
}

}  // namespace fedqcs
