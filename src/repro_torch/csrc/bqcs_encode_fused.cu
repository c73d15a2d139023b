// Single-pass fused BQCS encoder (FedQCS client compressor, paper Sec. III,
// eqs. 7-10, plus the uint32 wire packing), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bqcs_encode_fused.py
// (_fused_kernel, launched by bqcs_encode_fused_pallas), scalar undithered
// branch.  Per block-row:
//   carry  = blocks + residual
//   26-step bisection of [0, max|carry|] for the top-S threshold hi:
//       mid = 0.5f * (lo + hi); count(|carry| >= mid) > S ? lo = mid : hi = mid
//   keep   = |carry| >= hi  |  |carry| == max|carry|      (ties and the max)
//   resid  = carry - (keep ? carry : 0)                    (bit-identical)
//   alpha  = sqrt(M) / ||sparse||, 0 for a dead row
//   y_j    = sum_k (alpha * carry_k) * A^T[k, j] over the kept k
//   code_j = #{tau < y_j} (0 on the pad lanes j >= M)
//   word_w = OR_g code[g * W + w] << (g * Q)   (lane c -> word c % W, bit (c / W) Q)
//
// What bounds it on the card: the data must move once -- blocks, residual
// and resid (3 x rows x N x 4 B) plus A^T (N x Mp x 4 B), ~9.2 MB at the
// paper's 300 x 1591 (~2.7 us at 3.35 TB/s); the sparse product is only
// 2 x S x M FLOPs per row.  Design: A^T (3.4 MB) cannot sit in shared memory
// the way it sat in VMEM, but it stays in the 50 MB L2 across blocks.  One
// block per row keeps the carry row in shared memory through the 26 counting
// passes (each a block reduction), compacts the kept entries in ascending
// index order (warp ballots + a prefix over the warps), and then each thread
// computes whole projected lanes y_j from the compacted list, reading rows
// of A^T that neighbouring threads share (coalesced).  The projected row
// must be complete before the pack, since word w gathers lanes g * W + w
// from across the row.  The bisection is the plain version's exact fp32
// arithmetic, so the kept set and resid are bit-identical; alpha and y are
// sums in another order (alpha to ~1e-7 relative; a code can differ only on
// a lane within float rounding of a threshold).

#include "common.cuh"

using namespace fedqcs;

namespace {

__global__ void __launch_bounds__(kThreads)
bqcs_encode_fused_kernel(const float* __restrict__ blocks, const float* __restrict__ residual,
                         const float* __restrict__ a_t, const float* __restrict__ taus_g,
                         uint32_t* __restrict__ words, float* __restrict__ alpha_out,
                         float* __restrict__ resid, int n, int mp, int m, int s, int bits,
                         int n_taus, int iters) {
  extern __shared__ float smem[];
  float* carry = smem;                          // n
  int* kidx = reinterpret_cast<int*>(carry + n);  // n: kept indices, ascending
  float* kval = reinterpret_cast<float*>(kidx + n);  // n: kept values (then * alpha)
  float* y = kval + n;                          // mp projected lanes
  float* taus = y + mp;                         // n_taus thresholds
  __shared__ float scratch[kWarps];
  __shared__ int wcount[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* g = blocks + row * n;
  const float* r = residual + row * n;
  float* res_out = resid + row * n;

  float mx = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float c = g[i] + r[i];
    carry[i] = c;
    mx = fmaxf(mx, fabsf(c));
  }
  for (int i = tid; i < n_taus; i += kThreads) taus[i] = taus_g[i];
  mx = block_max(mx, scratch);  // its barriers also publish carry and taus

  // Bisection for the top-S threshold (uniform across the block).
  float lo = 0.f, hi = mx;
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float cnt = 0.f;  // counts <= n are exact in fp32
    for (int i = tid; i < n; i += kThreads) cnt += fabsf(carry[i]) >= mid ? 1.f : 0.f;
    cnt = block_sum1(cnt, scratch);
    if (cnt > (float)s) lo = mid; else hi = mid;
  }

  // Keep set, new residual, and the ordered compaction of the kept entries.
  int base = 0;
  float sq = 0.f;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int i = t0 + tid;
    bool keep = false;
    float c = 0.f;
    if (i < n) {
      c = carry[i];
      const float mag = fabsf(c);
      keep = (mag >= hi) | (mag == mx);
      res_out[i] = c - (keep ? c : 0.f);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (keep) {
      const int pos = base + before + __popc(ballot & ((1u << lane) - 1u));
      kidx[pos] = i;
      kval[pos] = c;
      sq += c * c;
    }
    base += total;
    __syncthreads();  // wcount is rewritten by the next tile
  }
  const int kept = base;
  sq = block_sum1(sq, scratch);
  const bool alive = sq > 1e-30f;
  const float alpha = alive ? sqrtf((float)m) * (1.0f / sqrtf(sq)) : 0.f;
  for (int k = tid; k < kept; k += kThreads) kval[k] *= alpha;
  __syncthreads();

  // y = (alpha * sparse) @ A^T over the kept entries only.
  for (int j = tid; j < mp; j += kThreads) {
    float acc = 0.f;
    if (alive) {
#pragma unroll 4
      for (int k = 0; k < kept; ++k) acc = fmaf(kval[k], __ldg(a_t + (size_t)kidx[k] * mp + j), acc);
    }
    y[j] = acc;
  }
  __syncthreads();

  // Threshold bucketize + lane-group packing.
  const int per_word = 32 / bits;
  const int w_count = mp / per_word;
  for (int w = tid; w < w_count; w += kThreads) {
    uint32_t word = 0u;
    for (int grp = 0; grp < per_word; ++grp) {
      const int c = grp * w_count + w;
      uint32_t code = 0u;
      if (c < m) {
        const float v = y[c];
        for (int l = 0; l < n_taus; ++l) code += v > taus[l] ? 1u : 0u;
      }
      word |= code << (grp * bits);
    }
    words[row * w_count + w] = word;
  }
  if (tid == 0) alpha_out[row] = alpha;
}

}  // namespace

extern "C" const char* fedqcs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int bqcs_encode_fused_launch(const float* blocks, const float* residual,
                                        const float* a_t, const float* taus, uint32_t* words,
                                        float* alpha, float* resid, int nb, int n, int mp, int m,
                                        int s, int bits, int n_taus, int iters,
                                        cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (bits < 1 || bits > 8 || mp % (32 / bits) != 0 || m > mp) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (3 * (size_t)n + mp + n_taus);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bqcs_encode_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bqcs_encode_fused_kernel<<<nb, kThreads, smem, stream>>>(blocks, residual, a_t, taus, words,
                                                            alpha, resid, n, mp, m, s, bits,
                                                            n_taus, iters);
  return (int)cudaGetLastError();
}
