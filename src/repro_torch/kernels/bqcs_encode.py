"""Staged BQCS encode (scale -> project -> quantize, eqs. 9-10), on Hopper.

Replaces the Pallas kernel ``repro/kernels/bqcs_encode.py``
(``_encode_kernel`` / ``bqcs_encode_pallas``).  Per block-row:

    alpha = sqrt(M) / ||x||          (0 for dead rows)
    y     = (alpha * x) @ A^T        (dense product, hand-written fp32 tiles)
    code  = #{tau_j < y}             (threshold bucketize, uint8)

The CUDA source is ``csrc/bqcs_encode.cu``; the plain version is
``ref.bqcs_encode_ref``.  ``launches`` counts kernel launches only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.bqcs_encode_fused import _check

launches = 0


def bqcs_encode(blocks: torch.Tensor, a_t: torch.Tensor, taus: torch.Tensor):
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
    codes = torch.empty((nb, m), dtype=torch.uint8, device=dev)
    alpha = torch.empty((nb,), dtype=f32, device=dev)
    lib.call("bqcs_encode_launch", blocks.data_ptr(), a_t.data_ptr(), taus.data_ptr(),
             codes.data_ptr(), alpha.data_ptr(), nb, n, m, taus.shape[0],
             build.stream_handle(dev))
    global launches
    launches += 1
    return codes, alpha
