"""Per-block magnitude top-S by bisection (the staged sparsify, eq. 7), on Hopper.

Replaces the Pallas kernel ``repro/kernels/block_topk.py`` (``_topk_kernel``
/ ``block_topk_pallas``).  Per block-row: 26 halvings of [0, max|x|] find
the threshold hi, then ``keep = |x| >= hi | |x| == max|x|``, ``sparse =
keep ? x : 0`` and ``resid = x - sparse``.  The CUDA source is
``csrc/block_topk.cu``; it shares the bisection and the keep rule with the
fused encoder (``csrc/common.cuh``).  The plain version is
``ref.block_topk_ref``, and the kernel's outputs are bit-identical to it.
``launches`` counts kernel launches only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.bqcs_encode_fused import BISECT_ITERS, _check

launches = 0


def block_topk(blocks: torch.Tensor, s: int, iters: int = BISECT_ITERS):
    """(nb, N) f32 -> (sparse (nb, N), resid (nb, N)); ``iters`` halvings."""
    nb, n = blocks.shape
    dev = blocks.device
    _check("blocks", blocks, (nb, n), torch.float32, dev)
    if dev.type == "cpu":
        return ref.block_topk_ref(blocks, s, iters=iters)
    if dev.type != "cuda":
        raise ValueError(f"block_topk runs on cpu or cuda tensors, got {dev}")
    lib = build.library()
    sparse, resid = torch.empty_like(blocks), torch.empty_like(blocks)
    lib.call("block_topk_launch", blocks.data_ptr(), sparse.data_ptr(), resid.data_ptr(),
             nb, n, s, iters, build.stream_handle(dev))
    global launches
    launches += 1
    return sparse, resid
