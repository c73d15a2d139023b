// Per-block magnitude top-S by bisection (the staged encoder's sparsify,
// paper eq. 7), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/block_topk.py (_topk_kernel,
// launched by block_topk_pallas).  Per block-row x:
//   hi     = topk_threshold(|x|)  (26-step fp32 bisection of [0, max|x|], in passes)
//   keep   = topk_keep(x, hi, max|x|)
//   sparse = keep ? x : 0;  resid = x - sparse
// The bisection and the keep rule are the device functions of common.cuh
// that the fused encoder also calls, and they repeat the plain version's
// fp32 steps exactly, so sparse and resid are bit-identical to
// kernels/ref.py::block_topk_ref.
//
// What bounds it on the card: one read of x and two writes (sparse, resid),
// 3 x rows x N x 4 B = 5.7 MB at the paper's 300 x 1591 (~1.7 us at
// 3.35 TB/s).  Design: one block per row (the TPU kernel's row tile), the
// row staged once in shared memory.  The bisection runs in passes of
// kLevels levels (common.cuh::topk_threshold): each pass computes the
// 2^kLevels - 1 midpoints of its levels, counts them all in one sweep over
// the row (a shared histogram), and walks the levels in every warp, for two
// barriers a pass instead of two a level.  The bytes still do not set the
// time: a block's passes are chains of dependent steps (the midpoints, the
// first pass's histogram of every element, the search for the entry at the
// threshold, the warp scan), and 300 rows give 300 blocks, ~2.3 per SM,
// too few warps to hide their latency.

#include "common.cuh"

using namespace fedqcs;

namespace {

__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ sparse,
                  float* __restrict__ resid, int n, int s, int iters) {
  extern __shared__ float row[];  // n
  __shared__ float scratch[kWarps];
  const size_t off = (size_t)blockIdx.x * n;
  float mx = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = x[off + i];
    row[i] = v;
    mx = fmaxf(mx, fabsf(v));
  }
  mx = block_max(mx, scratch);  // its barriers also publish the row
  const float hi = topk_threshold(row, n, s, iters, mx, scratch);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = row[i];
    const float kept = topk_keep(v, hi, mx) ? v : 0.f;
    sparse[off + i] = kept;
    resid[off + i] = v - kept;
  }
}

}  // namespace

extern "C" int block_topk_launch(const float* x, float* sparse, float* resid, int nb, int n,
                                 int s, int iters, cudaStream_t stream) {
  if (nb <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)n;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(block_topk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  block_topk_kernel<<<nb, kThreads, smem, stream>>>(x, sparse, resid, n, s, iters);
  return (int)cudaGetLastError();
}
