"""Sensing matrices for the dimension-reduction stage (paper Sec. III-A).

The paper draws A in R^{M x N} iid N(0, 1/M) and shares it across all
devices, blocks and steps: it is protocol state, shared through a seed.
The port draws it as the reference does, ``normal(PRNGKey(seed), (m, n)) /
sqrt(m)`` with the threefry of ``repro_torch.prng``, so a seed gives the
reference's A bit for bit (a PS of either package decodes the other's
wire).  It is drawn on the CPU and then moved, so the CPU and the card
hold the same A.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng

__all__ = ["sensing_matrix", "sensing_matrix_t", "scale_factor", "project_blocks"]


def sensing_matrix(seed: int, m: int, n: int, device="cuda") -> torch.Tensor:
    """A in R^{m x n}, entries iid N(0, 1/m): ``normal(PRNGKey(seed), (m,
    n))`` over the f32 sqrt(m), drawn on the CPU and moved to ``device``."""
    a = prng.normal(prng.PRNGKey(seed), (m, n)) / float(np.sqrt(np.float32(m)))
    return a.to(device)


def sensing_matrix_t(seed: int, m: int, n: int, device="cuda") -> torch.Tensor:
    """A^T in R^{n x m} (the entries of :func:`sensing_matrix`), the layout
    of the batched projection ``Y = G @ A^T``."""
    return sensing_matrix(seed, m, n, device).T


def scale_factor(blocks: torch.Tensor, m: int, eps: float = 1e-20) -> torch.Tensor:
    """alpha per block: sqrt(M) / ||g_block|| (0 for zero blocks), (nblocks,)."""
    norms = torch.linalg.vector_norm(blocks, dim=-1)
    root_m = float(np.sqrt(np.float32(m)))
    return torch.where(norms > eps, root_m / norms, torch.zeros_like(norms))


def project_blocks(blocks: torch.Tensor, a_t: torch.Tensor):
    """x = alpha * (A @ g) for every block, batched as one GEMM (IEEE fp32:
    the entry points turn TF32 off).  blocks (nb, N), a_t (N, M).  Returns
    (x (nb, M) unit-variance projections, alpha (nb,))."""
    alpha = scale_factor(blocks, a_t.shape[1])
    return (blocks @ a_t) * alpha[:, None], alpha
