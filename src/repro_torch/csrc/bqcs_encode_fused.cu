// Single-pass fused BQCS encoder (FedQCS client compressor, paper Sec. III,
// eqs. 7-10, plus the uint32 wire packing), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bqcs_encode_fused.py
// (_fused_kernel, launched by bqcs_encode_fused_pallas), all three codebook
// branches.  Per block-row:
//   carry  = blocks + residual
//   hi     = topk_threshold(|carry|)  (26-step bisection in passes, common.cuh)
//   keep   = topk_keep(carry, hi, max|carry|)                (ties and the max)
//   resid  = carry - (keep ? carry : 0)                    (bit-identical)
//   alpha  = sqrt(M) / ||sparse||, 0 for a dead row
//   y_j    = sum_k (alpha * carry_k) * A^T[k, j] over the kept k
//   scalar: code_j = #{tau < y_j (+ dither_j)}, 0 on the pad lanes j >= M
//   vq:     code_g = first argmax_l  y_g c_l0 - cn_l + sum_{j>=1} y_{jG+g} c_lj
//           over the G = M / d code lanes (j-major layout), 0 on lanes g >= G
//   word_w = OR_p code[p * W + w] << (p * Q)   (lane c -> word c % W, bit (c / W) Q)
//
// What bounds it on the card: the data that must move once -- blocks,
// residual and resid (3 x rows x N x 4 B) plus the rows of A^T the kept
// entries touch -- is ~9.2 MB at the paper's 300 x 1591 (~2.7 us at
// 3.35 TB/s), and the sparse product is only 2 x S x M FLOPs per row.  But
// one block per row shares no row of A^T with another row: each reads its
// ~159 kept rows of A^T from L2 (159 x 530 x 4 B = 337 KB), ~101 MB an
// encode, and that L2 traffic bounds this design.  Design: A^T (3.4 MB)
// cannot sit in shared memory the way it sat in VMEM, but it stays in the
// 50 MB L2 across blocks.  One block per row keeps the carry row in shared
// memory through the pass-batched bisection (a few passes of kLevels
// levels, two barriers each), compacts the kept entries in ascending index
// order (warp ballots + a prefix over the warps), and splits the compacted
// list over its 8 warps.  A lane holds kProjLoads columns of y in registers
// and issues a kept row's kProjLoads coalesced loads, two rows at a time,
// so each SM keeps hundreds of L2 lines in flight: enough to stream at the
// L2's rate rather than wait on its latency.  The warps' partials are added
// in warp order, the same on every run.  Tensor cores do not help: the
// projection gathers scattered rows of A^T, a different set for every row,
// with ~0.5 FLOP per byte read, and TF32 would flip codes at the thresholds,
// so it stays fp32 FMA.  The projected row must be complete before the
// encode and the pack: a vq code reads d lanes G apart, and word w gathers
// lanes p * W + w from across the row.  The bisection is the plain
// version's exact fp32 arithmetic, so the kept set and resid are
// bit-identical; alpha and y are sums in another order (alpha to ~1e-7
// relative; a code can differ only on a lane within float rounding of a
// threshold or of a tie between two centroids).  The dither add and the vq
// score are written with __fadd_rn/__fmul_rn so nvcc cannot contract them
// into FMAs: on identical y they round as the plain version's separate
// PyTorch ops do.

#include "common.cuh"

using namespace fedqcs;

namespace {

// The sparse projection: a lane sums kProjLoads columns 32 apart, so a warp
// covers kProjCols columns a chunk (544: the paper's M = 530 in one chunk).
constexpr int kProjLoads = 17;
constexpr int kProjCols = 32 * kProjLoads;

// The carry row's region, which the warps' projection partials reuse.
__host__ __device__ inline int carry_floats(int n, int mp) {
  const int part = kWarps * (mp < kProjCols ? mp : kProjCols);
  return n > part ? n : part;
}

__global__ void __launch_bounds__(kThreads, 3)
bqcs_encode_fused_kernel(const float* __restrict__ blocks, const float* __restrict__ residual,
                         const float* __restrict__ a_t, const float* __restrict__ tab_g,
                         const float* __restrict__ cn_g, const float* __restrict__ dither,
                         uint32_t* __restrict__ words, float* __restrict__ alpha_out,
                         float* __restrict__ resid, int n, int mp, int m, int s, int bits,
                         int n_tab, int vq_d, int iters) {
  extern __shared__ float smem[];
  float* carry = smem;                          // carry_floats(n, mp): the row, then part
  int* kidx = reinterpret_cast<int*>(carry + carry_floats(n, mp));  // n: kept indices, ascending
  float* kval = reinterpret_cast<float*>(kidx + n);  // n: kept values (then * alpha)
  float* y = kval + n;                          // mp projected lanes
  float* tab = y + mp;                          // scalar: n_tab thresholds;
                                                // vq: n_tab x vq_d centroids, then n_tab cn
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
  const int tab_len = vq_d > 1 ? n_tab * vq_d : n_tab;
  for (int i = tid; i < tab_len; i += kThreads) tab[i] = tab_g[i];
  if (vq_d > 1) {
    for (int i = tid; i < n_tab; i += kThreads) tab[tab_len + i] = cn_g[i];
  }
  mx = block_max(mx, scratch);  // its barriers also publish carry and the tables

  const float hi = topk_threshold(carry, n, s, iters, mx, scratch);

  // Keep set, new residual, and the ordered compaction of the kept entries.
  int base = 0;
  float sq = 0.f;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int i = t0 + tid;
    bool keep = false;
    float c = 0.f;
    if (i < n) {
      c = carry[i];
      keep = topk_keep(c, hi, mx);
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

  // y = (alpha * sparse) @ A^T over the kept entries only.  Warp w takes a
  // contiguous slice of the kept list and sums it a chunk of kProjCols
  // columns at a time, lane l keeping columns l + 32 c in registers: each
  // kept row of A^T is kProjLoads coalesced loads, issued for two rows
  // together.  The warps' partials meet in part (over carry, dead since the
  // compaction) and each y_j adds them in warp order 0..7.
  const int kn = alive ? kept : 0;
  const int per = (kn + kWarps - 1) / kWarps;
  const int k_lo = min(kn, warp * per), k_hi = min(kn, k_lo + per);
  float* part = carry;
  for (int j0 = 0; j0 < mp; j0 += kProjCols) {
    const int cols = min(kProjCols, mp - j0);
    const float* at = a_t + j0 + lane;
    float acc[kProjLoads];
#pragma unroll
    for (int c = 0; c < kProjLoads; ++c) acc[c] = 0.f;
    int k = k_lo;
    for (; k + 2 <= k_hi; k += 2) {
      const float* r0 = at + (size_t)kidx[k] * mp;
      const float* r1 = at + (size_t)kidx[k + 1] * mp;
      float v0[kProjLoads], v1[kProjLoads];
#pragma unroll
      for (int c = 0; c < kProjLoads; ++c) {
        const bool ok = lane + 32 * c < cols;
        v0[c] = ok ? __ldg(r0 + 32 * c) : 0.f;
        v1[c] = ok ? __ldg(r1 + 32 * c) : 0.f;
      }
      const float w0 = kval[k], w1 = kval[k + 1];
#pragma unroll
      for (int c = 0; c < kProjLoads; ++c) acc[c] = fmaf(w1, v1[c], fmaf(w0, v0[c], acc[c]));
    }
    if (k < k_hi) {
      const float* r0 = at + (size_t)kidx[k] * mp;
      const float w0 = kval[k];
#pragma unroll
      for (int c = 0; c < kProjLoads; ++c)
        acc[c] = fmaf(w0, lane + 32 * c < cols ? __ldg(r0 + 32 * c) : 0.f, acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kProjLoads; ++c)
      if (lane + 32 * c < cols) part[warp * cols + lane + 32 * c] = acc[c];
    __syncthreads();
    for (int j = tid; j < cols; j += kThreads) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += part[w * cols + j];
      y[j0 + j] = t;
    }
    __syncthreads();  // part is rewritten by the next chunk; y is read below
  }

  // Encode + lane-group packing.  Scalar: n_codes = M over Mp = W * per_word
  // lanes; vq: n_codes = G = M / d over W * per_word lanes.
  const int per_word = 32 / bits;
  const int g_codes = vq_d > 1 ? m / vq_d : m;
  const int w_count = vq_d > 1 ? (g_codes + per_word - 1) / per_word : mp / per_word;
  const float* cn = tab + tab_len;
  for (int w = tid; w < w_count; w += kThreads) {
    uint32_t word = 0u;
    for (int p = 0; p < per_word; ++p) {
      const int c = p * w_count + w;
      uint32_t code = 0u;
      if (c < g_codes) {
        if (vq_d > 1) {
          float best = 0.f;
          for (int l = 0; l < n_tab; ++l) {
            const float* cl = tab + l * vq_d;
            float sc = __fsub_rn(__fmul_rn(y[c], cl[0]), cn[l]);
            for (int j = 1; j < vq_d; ++j) sc = __fadd_rn(sc, __fmul_rn(y[j * g_codes + c], cl[j]));
            if (l == 0 || sc > best) {  // strict: the lowest index wins a tie
              best = sc;
              code = (uint32_t)l;
            }
          }
        } else {
          const float v = dither != nullptr ? __fadd_rn(y[c], __ldg(dither + c)) : y[c];
          for (int l = 0; l < n_tab; ++l) code += v > tab[l] ? 1u : 0u;
        }
      }
      word |= code << (p * bits);
    }
    words[row * w_count + w] = word;
  }
  if (tid == 0) alpha_out[row] = alpha;
}

}  // namespace

extern "C" const char* fedqcs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scalar families: tab = the (n_tab,) thresholds, cn = null, dither = the
// (mp,) per-lane dither (zero past m) or null, vq_d = 1, mp a multiple of
// 32 / bits.  vq: tab = the (n_tab, vq_d) centroids row-major, cn = their
// (n_tab,) half squared norms, dither = null, mp = m, m % vq_d == 0.
extern "C" int bqcs_encode_fused_launch(const float* blocks, const float* residual,
                                        const float* a_t, const float* tab, const float* cn,
                                        const float* dither, uint32_t* words, float* alpha,
                                        float* resid, int nb, int n, int mp, int m, int s,
                                        int bits, int n_tab, int vq_d, int iters,
                                        cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (bits < 1 || bits > 8 || m > mp || vq_d < 1) return (int)cudaErrorInvalidValue;
  if (vq_d == 1 && mp % (32 / bits) != 0) return (int)cudaErrorInvalidValue;
  if (vq_d > 1 && (mp != m || m % vq_d != 0 || cn == nullptr || dither != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t tab_floats = vq_d > 1 ? (size_t)n_tab * (vq_d + 1) : (size_t)n_tab;
  const size_t smem =
      sizeof(float) * ((size_t)carry_floats(n, mp) + 2 * (size_t)n + mp + tab_floats);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bqcs_encode_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bqcs_encode_fused_kernel<<<nb, kThreads, smem, stream>>>(blocks, residual, a_t, tab, cn, dither,
                                                            words, alpha, resid, n, mp, m, s,
                                                            bits, n_tab, vq_d, iters);
  return (int)cudaGetLastError();
}
