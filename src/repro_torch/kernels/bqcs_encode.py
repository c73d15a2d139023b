"""Staged BQCS encode (scale -> project -> quantize, eqs. 9-10), on Hopper.

Replaces the Pallas kernel ``repro/kernels/bqcs_encode.py``
(``_encode_kernel`` / ``bqcs_encode_pallas``).  Per block-row:

    alpha = sqrt(M) / ||x||          (0 for dead rows)
    y     = alpha * (x @ A^T)        (dense product, register-tiled fp32)
    code  = #{tau_j < y}             (threshold bucketize, uint8)

The CUDA source is ``csrc/bqcs_encode.cu``: a tile of 64 x 64 outputs per
thread-block cluster of ``cluster`` blocks, each block multiplying over its
own run of whole K steps; ``launch_shape`` picks the cluster.  The plain
version is ``ref.bqcs_encode_ref``.  ``launches`` counts kernel launches
only.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.bqcs_encode_fused import _check
from repro_torch.kernels.gamp_step import _sm_count

launches = 0

TILE_ROWS = 64  # output rows of a tile (csrc/common.cuh kTileRows)
TILE_COLS = 64  # output columns of a tile (csrc/common.cuh kTileCols)
K_STEP = 32  # K per ring stage (csrc/common.cuh kTileK)
CLUSTERS = (1, 2, 4, 8)  # blocks per cluster the kernel launches


def launch_shape(nb: int, n: int, m: int, sms: int) -> tuple[int, int]:
    """(rows per tile, blocks per cluster) for ``nb`` block-rows of length
    ``n`` projected to ``m`` on a card with ``sms`` SMs.  Tiles of
    ``TILE_ROWS`` rows; then the largest cluster that keeps the grid within
    one block per SM and leaves at least two K steps per block.  The kernel
    is bound by each SM's shared-memory traffic, not by its FMAs, so a
    second block on an SM adds no throughput, only another partial tile to
    reduce: at the paper's 300 x 1591 -> 530, 45 tiles x 2 = 90 blocks on
    the H100's 132 SMs, where 45 x 4 = 180 (some SMs with two blocks) is no
    faster.  Set from ``chip_smoke.py``'s [tune] sweep on an H100 (PERF.md),
    which times every cluster size and marks this choice."""
    tiles = -(-nb // TILE_ROWS) * -(-m // TILE_COLS)
    steps = -(-n // K_STEP)
    cluster = 1
    while cluster < CLUSTERS[-1] and tiles * 2 * cluster <= sms and steps >= 4 * cluster:
        cluster *= 2
    return TILE_ROWS, cluster


def bqcs_encode(
    blocks: torch.Tensor,
    a_t: torch.Tensor,
    taus: torch.Tensor,
    *,
    _cluster: Optional[int] = None,  # blocks per cluster, for the [tune] sweep only
):
    """blocks (nb, N) f32, a_t (N, M) f32, taus (L - 1,) f32 ->
    (codes uint8 (nb, M), alpha f32 (nb,))."""
    nb, n = blocks.shape
    m = a_t.shape[1]
    dev = blocks.device
    f32 = torch.float32
    _check("blocks", blocks, (nb, n), f32, dev)
    _check("a_t", a_t, (n, m), f32, dev)
    _check("taus", taus, (taus.shape[0],), f32, dev)
    if not 1 <= taus.shape[0] <= 255:
        raise ValueError(f"{taus.shape[0]} thresholds: uint8 codes take 1 to 255")
    if dev.type == "cpu":
        return ref.bqcs_encode_ref(blocks, a_t, taus)
    if dev.type != "cuda":
        raise ValueError(f"bqcs_encode runs on cpu or cuda tensors, got {dev}")
    lib = build.library()
    cluster = _cluster or launch_shape(nb, n, m, _sm_count(dev.index))[1]
    codes = torch.empty((nb, m), dtype=torch.uint8, device=dev)
    alpha = torch.empty((nb,), dtype=f32, device=dev)
    # a cluster size that does not fit on the card makes the launch raise
    lib.call("bqcs_encode_launch", blocks.data_ptr(), a_t.data_ptr(), taus.data_ptr(),
             codes.data_ptr(), alpha.data_ptr(), nb, n, m, taus.shape[0],
             cluster, build.stream_handle(dev))
    global launches
    launches += 1
    return codes, alpha
