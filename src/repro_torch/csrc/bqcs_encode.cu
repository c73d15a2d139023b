// Staged BQCS encode (scale -> project -> quantize, paper eqs. 9-10), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bqcs_encode.py
// (_encode_kernel, launched by bqcs_encode_pallas).  Per block-row x:
//   alpha  = sqrt(M) / ||x||, 0 for a dead row (||x||^2 <= 1e-30)
//   y_j    = alpha * sum_k x_k A^T[k, j]           (dense product over N)
//   code_j = #{tau < y_j}                          (uint8)
// The TPU kernel runs the dense product on the MXU inside its body; here it
// is a hand-written fp32 FMA product (no library call, no TF32: TF32 would
// flip codes at the thresholds), with the row norm, the scale and the
// bucketize fused around it.
//
// What bounds it on the card: operations.  2 x rows x N x M FLOPs, 0.51
// GFLOP at the paper's 300 x 1591 -> 530 (~7.6 us at the 67 TFLOP/s fp32
// peak), against ~5.6 MB of x, A^T and codes (~1.7 us at 3.35 TB/s).  What
// bounds this design is each SM's shared-memory path, not its FMAs: the
// tile product's 16-byte shared loads, and the staging of x and A^T into
// shared memory, which do not overlap each other (PERF.md).
//
// Design.  A tile is 64 rows x 64 columns of y, the product of common.cuh
// tile_product: each thread holds 8 x 8 outputs in registers, so 4 16-byte
// shared loads feed 64 FMAs, and the block's 256 threads form 4 groups that
// cover the tile each and split every K step between them (their partial
// tiles are added in group order at the end).  A ring of 3 stages is filled
// with 4-byte cp.async while the previous stage is multiplied, one barrier
// per stage (rows of x and A^T are not 16-byte aligned, so neither 16-byte
// cp.async nor TMA applies without a padded copy, which the wrapper would
// have to make on every call).  The output is small (300 x 530) and K long
// (1591), so a tile per block gives only 45 blocks: a thread-block cluster
// of C blocks (C in {1, 2, 4, 8}) shares each tile, rank q multiplying over
// its own run of whole K steps.  The ranks publish their partial tiles in
// shared memory; after a cluster.sync(), rank q adds the C partials of its
// 1/C share of the tile through distributed shared memory in rank order
// 0..C-1 (common.cuh cluster_sum_slice; no atomics, so a launch is
// deterministic), then scales, quantizes and stores that share, each
// thread's outputs side by side so their loads and compares overlap.  The
// row norms come from the same staged x tiles: each rank sums x^2 over its K
// range as it stages them, the cluster adds those sums in rank order, and
// alpha scales the finished y in the epilogue (y = alpha * acc).  So no
// block runs a norm pre-pass.  alpha and y are sums in another order than
// the plain version's (alpha to ~1e-7 relative; a code can differ only on a
// lane within float rounding of a threshold).  Launch bounds of two blocks
// per SM (<= 128 registers).  The wrapper's launch_shape picks C (2 at the
// paper's shape: 90 blocks, one per SM).  tools/probe_staged_encode.py reads
// the clock just before each line whose comment carries a PROBE: number.

#include "common.cuh"

using namespace fedqcs;
namespace cg = cooperative_groups;

namespace {

constexpr int R = kTileRows;
constexpr int G = kTileGroups;
constexpr int Q = kThreads / R;            // threads that sum one row's x^2
constexpr int P = R * kTileCols / kThreads;  // outputs of the tile per thread

__global__ void __launch_bounds__(kThreads, 2)
bqcs_encode_kernel(const float* __restrict__ x, const float* __restrict__ a_t,
                   const float* __restrict__ taus_g, uint8_t* __restrict__ codes,
                   float* __restrict__ alpha_out, int nb, int n, int m, int n_taus) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = (int)threadIdx.x;  // PROBE:0 start
  const int tile = (int)blockIdx.x / C;
  const int col_tiles = (m + kTileCols - 1) / kTileCols;
  const int row0 = (tile / col_tiles) * R, col0 = (tile % col_tiles) * kTileCols;
  // rank q's K range: ceil(steps / C) whole K steps from q times that (empty
  // for the last ranks when N has too few steps)
  const int k_per = ((n + kTileK - 1) / kTileK + C - 1) / C * kTileK;
  const int k_lo = min(n, rank * k_per), k_hi = min(n, k_lo + k_per);

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ float taus[256];
  for (int i = tid; i < n_taus; i += kThreads) taus[i] = taus_g[i];  // read after the barriers

  // this rank's sums of x^2: thread t takes row t % R and, in each stage,
  // the k = t / R + Q e (consecutive lanes on consecutive rows: no bank
  // conflicts)
  const int nr = tid % R, nq = tid / R;
  float sq = 0.f;
  const TileThread th;
  float acc[8][8];
  tile_product(x + (size_t)row0 * n, n, min(R, nb - row0), a_t + col0, m,
               min(kTileCols, m - col0), k_lo, k_hi, ring, th, acc, [&](const float* xs) {
                 float s = 0.f;
#pragma unroll
                 for (int e = 0; e < kTileK / Q; ++e) {
                   const float v = xs[(nq + Q * e) * kTileXStride + nr];
                   s = fmaf(v, v, s);
                 }
                 sq += s;
               });

  // PROBE:1 tile product done.  The groups' partial tiles and partial norms
  // (the ring is free now), added in group order into group 0's tile and the
  // rank's norms
  float* part = ring;                       // G x R x kTileCols; group 0's: the rank's
  float* sq_part = part + G * R * kTileCols;  // Q x R
  float* sq_rank = sq_part + Q * R;         // R: published to the cluster
  float* alpha_s = sq_rank + R;             // R: the cluster's sums, then alpha
  float* mine = part + th.g * R * kTileCols;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int v = 0; v < 2; ++v)
      *reinterpret_cast<float4*>(mine + th.row(a) * kTileCols + th.col(4 * v)) =
          make_float4(acc[a][4 * v], acc[a][4 * v + 1], acc[a][4 * v + 2], acc[a][4 * v + 3]);
  sq_part[nq * R + nr] = sq;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int e = tid + kThreads * j;
    float s = part[e];
#pragma unroll
    for (int g = 1; g < G; ++g) s += part[g * R * kTileCols + e];
    part[e] = s;
  }
  if (tid < R) {
    float s = sq_part[tid];
#pragma unroll
    for (int q = 1; q < Q; ++q) s += sq_part[q * R + tid];
    sq_rank[tid] = s;
  }
  cluster.sync();  // every rank's tile and norms are published (PROBE:2)
  // rank q's share of the tile: outputs lo + tid + kThreads j, j < per
  const int per = P / C, lo = rank * per * kThreads;
  float y[P];
  cluster_sum_slice<P>(part, lo, per, y);  // PROBE:3 cluster synced
  cluster_sum(sq_rank, R, alpha_s);
  __syncthreads();
  if (tid < R) {
    const float s = alpha_s[tid];
    const float alpha = s > 1e-30f ? sqrtf((float)m) * (1.0f / sqrtf(s)) : 0.f;
    alpha_s[tid] = alpha;
    if (col0 == 0 && rank == 0 && row0 + tid < nb) alpha_out[row0 + tid] = alpha;
  }
  __syncthreads();
  uint32_t code[P];  // PROBE:4 reduced, alpha known
#pragma unroll
  for (int j = 0; j < P; ++j) {
    y[j] *= j < per ? alpha_s[(lo + tid + kThreads * j) / kTileCols] : 0.f;
    code[j] = 0u;
  }
  for (int l = 0; l < n_taus; ++l) {
    const float tau = taus[l];
#pragma unroll
    for (int j = 0; j < P; ++j) code[j] += y[j] > tau ? 1u : 0u;
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int e = lo + tid + kThreads * j;
    const int row = row0 + e / kTileCols, col = col0 + e % kTileCols;
    if (j < per && row < nb && col < m) codes[(size_t)row * m + col] = (uint8_t)code[j];
  }
  // no block exits while another may still read its shared memory (PROBE:5)
  cluster.sync();
}

// Dynamic shared memory in floats: the ring, or the epilogue's buffers.
constexpr int kEpilogueFloats = G * R * kTileCols + kThreads + 2 * R;
constexpr int kSmemFloats = kTileRing > kEpilogueFloats ? kTileRing : kEpilogueFloats;

}  // namespace

// cluster: 1, 2, 4 or 8 blocks per tile.  A shape the kernel does not take
// returns cudaErrorInvalidValue or cudaErrorInvalidClusterSize (the wrapper
// raises).
extern "C" int bqcs_encode_launch(const float* x, const float* a_t, const float* taus,
                                  uint8_t* codes, float* alpha, int nb, int n, int m, int n_taus,
                                  int cluster, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (n_taus < 1 || n_taus > 255 || m < 1) return (int)cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return (int)cudaErrorInvalidClusterSize;
  const int tiles = ((nb + R - 1) / R) * ((m + kTileCols - 1) / kTileCols);
  return launch_cluster<bqcs_encode_kernel>((unsigned)(tiles * cluster), cluster,
                                            sizeof(float) * kSmemFloats, stream, x, a_t, taus,
                                            codes, alpha, nb, n, m, n_taus);
}
