"""Block sparsification with error feedback (paper Sec. III-A, eqs. 7-8),
port of ``repro.core.sparsify``.

The gradient vector is split into blocks of size N; each block keeps only
its top-S magnitude entries, and the dropped mass comes back as a residual
that the caller adds to the next step's gradient (error feedback).  Every
function works on a stacked ``(nblocks, N)`` view.

These are the reference's XLA-route sparsifiers (``use_kernels=False``),
not a kernel's plain version: the exact top-S keeps the set ``lax.top_k``
picks, and the threshold variant repeats the reference's 24 fp32 halvings.
"""

from __future__ import annotations

import torch

__all__ = ["block_topk_mask", "block_sparsify", "block_sparsify_threshold"]


def block_topk_mask(blocks: torch.Tensor, s: int) -> torch.Tensor:
    """Boolean mask of the top-``s`` magnitude entries per block, exactly
    ``s`` True per row.  Ties go to the lower index, as ``lax.top_k`` breaks
    them: a stable descending sort keeps equal magnitudes in index order,
    which ``torch.topk`` does not promise."""
    n = blocks.shape[-1]
    if s >= n:
        return torch.ones(blocks.shape, dtype=torch.bool, device=blocks.device)
    order = torch.sort(torch.abs(blocks), dim=-1, descending=True, stable=True).indices
    mask = torch.zeros(blocks.shape, dtype=torch.bool, device=blocks.device)
    return mask.scatter_(-1, order[..., :s], True)


def block_sparsify(blocks: torch.Tensor, s: int):
    """BlockSparse(.): keeps top-S per block; returns (sparse, residual) with
    ``sparse + residual == blocks`` exactly (eq. 7)."""
    mask = block_topk_mask(blocks, s)
    sparse = torch.where(mask, blocks, torch.zeros_like(blocks))
    return sparse, blocks - sparse


def block_sparsify_threshold(blocks: torch.Tensor, s: int, bisect_iters: int = 24):
    """Threshold variant: a per-block magnitude threshold found by
    ``bisect_iters`` fp32 halvings of [0, max|x|], then ``|x| >= hi`` OR-ed
    with the row max.  Keeps approximately S entries (exactly S where the
    magnitudes are distinct at the bisection's resolution).  Returns
    (sparse, residual) like :func:`block_sparsify`."""
    mag = torch.abs(blocks)
    mx = torch.amax(mag, dim=-1, keepdim=True)
    hi = mx.clone()
    lo = torch.zeros_like(hi)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        too_many = torch.sum(mag >= mid, dim=-1, keepdim=True) > s
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    mask = (mag >= hi) | (mag == mx)
    sparse = torch.where(mask, blocks, torch.zeros_like(blocks))
    return sparse, blocks - sparse
