"""Baseline frameworks the paper compares against (Sec. VI), port of
``repro.core.baselines``.

  * SignSGD with majority vote: 1 bit/entry, sign + vote + global scale.
  * QCS-Dither: dithered *uniform* quantization after a structured
    (Hadamard x Rademacher) projection; linear (adjoint) estimator at the PS.
  * QCS-QIHT: BQCS compression, reconstruction by quantized iterative hard
    thresholding instead of Q-EM-GAMP (needs S known).

All operate on the same (nblocks, N) block view as the FedQCS codec.  None
of them reaches a kernel in either package: these are the reference's XLA
algorithms (products, a stable sort, the FWHT butterflies) in PyTorch.

Random state: ``DitherCodec``'s Rademacher signs and subsampled rows are
protocol constants drawn on the CPU from its seed (or injected, as
``BQCSCodec`` takes ``a=``); the per-client dither is the caller's draw
(the round engine's draw seam).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import sparsify
from repro_torch.core.codebook import as_codebook

__all__ = [
    "signsgd_compress",
    "signsgd_aggregate",
    "DitherCodec",
    "qiht_step",
    "qiht_reconstruct",
]


# ---------------------------------------------------------------------------
# SignSGD with majority vote
# ---------------------------------------------------------------------------


def signsgd_compress(blocks: torch.Tensor) -> torch.Tensor:
    """Per-entry sign in {-1, +1} (int8 on the wire: 1 bit/entry); ``>= 0``
    (-0.0 included) maps to +1."""
    return torch.where(blocks >= 0, 1, -1).to(torch.int8)


def signsgd_aggregate(signs: torch.Tensor, lr_scale=1.0) -> torch.Tensor:
    """Majority vote across workers: sign(sum_k sign(g_k)), a tie to +1.

    signs (K, nb, N) int8 -> (nb, N) f32 in {-1, +1} * lr_scale."""
    vote = torch.sum(signs.to(torch.int32), dim=0)
    return torch.where(vote >= 0, 1.0, -1.0).to(torch.float32) * lr_scale


# ---------------------------------------------------------------------------
# QCS-Dither: Hadamard x Rademacher sensing + dithered uniform quantization
# ---------------------------------------------------------------------------


def _fwht(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along the last axis (power-of-2
    length), un-normalized (H @ x with entries +-1)."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT needs power-of-2 length, got {n}")
    shape = x.shape
    x = x.reshape(-1, n)
    h = 1
    while h < n:
        x = x.reshape(-1, n // (2 * h), 2, h)
        a, b = x[:, :, 0, :], x[:, :, 1, :]
        x = torch.stack([a + b, a - b], dim=2)
        h *= 2
    return x.reshape(shape)


@dataclasses.dataclass
class DitherCodec:
    """QCS-Dither: y = S H D g (D a random Rademacher diagonal, H the
    Hadamard matrix, S a row subsampling), dithered uniform quantization of
    y, linear reconstruction g_hat = D H^T S^T y_dq * N / M.

    ``rademacher`` (n,) and ``rows`` (m,) inject the signs and rows; unset,
    they are drawn on the CPU from ``seed`` as the reference draws them:
    ``split(PRNGKey(seed))`` into ``bernoulli(krad, 0.5)`` signs and
    ``choice(krow, n, (m,), replace=False)`` rows.  The dither u ~ Unif(-delta/2,
    delta/2) is shared with the PS: :meth:`compress` takes its unit draw
    (Unif[-0.5, 0.5), the shape of the projection) from the caller.
    """

    n: int
    m: int
    bits: int
    seed: int = 7
    rademacher: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None
    device: Optional[torch.device] = None

    def __post_init__(self):
        krad, krow = prng.split(prng.PRNGKey(self.seed)).unbind(-2)
        if self.rademacher is None:
            self.rademacher = torch.where(prng.bernoulli(krad, 0.5, (self.n,)), 1.0, -1.0)
        if self.rows is None:
            self.rows = prng.choice(krow, self.n, (self.m,), replace=False)
        dev = self.device if self.device is not None else self.rademacher.device
        self.rademacher = self.rademacher.to(dev, torch.float32)
        self.rows = self.rows.to(dev, torch.int64)
        if tuple(self.rademacher.shape) != (self.n,) or tuple(self.rows.shape) != (self.m,):
            raise ValueError(
                f"rademacher {tuple(self.rademacher.shape)} / rows {tuple(self.rows.shape)} "
                f"do not match n={self.n}, m={self.m}"
            )

    def _root_n(self) -> torch.Tensor:
        return torch.sqrt(torch.tensor(float(self.n), dtype=torch.float32,
                                       device=self.rademacher.device))

    def _project(self, blocks: torch.Tensor) -> torch.Tensor:
        y = _fwht(blocks * self.rademacher[None, :]) / self._root_n()
        return y[:, self.rows]  # (nb, M): rows of the orthonormal H D

    def _backproject(self, y: torch.Tensor, nb: int) -> torch.Tensor:
        full = torch.zeros((nb, self.n), dtype=torch.float32, device=y.device)
        full[:, self.rows] = y
        return _fwht(full) / self._root_n() * self.rademacher[None, :]

    def compress(self, blocks: torch.Tensor, unit_dither: torch.Tensor):
        """(nb, n) blocks and a Unif[-0.5, 0.5) draw (nb, m) -> (codes int32,
        delta (nb, 1), dither (nb, m)).  Uniform quantizer over +-4 std of
        the projection, 2**bits levels, additive dither."""
        y = self._project(blocks)
        std = torch.std(y, dim=-1, keepdim=True, correction=0)
        scale = torch.clamp(std, min=1e-12) * 4.0
        delta = 2.0 * scale / (2**self.bits)
        dither = unit_dither.to(y.device, torch.float32) * delta
        half = 2 ** (self.bits - 1)
        q = torch.clamp(torch.round((y + dither) / delta), -half, half - 1)
        return q.to(torch.int32), delta, dither

    def reconstruct(self, codes: torch.Tensor, delta: torch.Tensor, dither: torch.Tensor):
        """Linear estimator: subtract the dither, backproject with the
        adjoint, rescale by N/M to unbias the subsampled energy."""
        y = codes.to(torch.float32) * delta - dither
        return self._backproject(y, codes.shape[0]) * (self.n / self.m)


# ---------------------------------------------------------------------------
# QCS-QIHT: quantized iterative hard thresholding
# ---------------------------------------------------------------------------


def qiht_step(g, q_dq, a, safe_alpha, codebook, s: int, step: float = 1.0):
    """One QIHT iteration from the (nb, N) estimate ``g``: returns the
    update before the hard threshold, ``g + mu A^T (q_dq - Q(alpha A g)) /
    alpha``, and its top-S (``sparsify.block_sparsify``, the reference's
    ``lax.top_k`` set by a stable sort)."""
    xa = safe_alpha * (g @ a.T)
    resid = q_dq - codebook.quantize(xa)
    pre = g + step * (resid @ a) / safe_alpha
    return pre, sparsify.block_sparsify(pre, s)[0]


def qiht_reconstruct(
    codes: torch.Tensor,  # (nb, n_codes) codebook indices
    alpha: torch.Tensor,  # (nb,)
    a: torch.Tensor,  # (M, N)
    codebook,  # Codebook of any family (or legacy LloydMaxQuantizer)
    s: int,
    iters: int = 50,
    step: float = 1.0,
) -> torch.Tensor:
    """QIHT: ``iters`` steps of :func:`qiht_step` from zero, then the norm
    rescale to ||g_hat|| = sqrt(M)/alpha; dead rows (alpha == 0) come out
    zero."""
    codebook = as_codebook(codebook)
    m, n = a.shape
    q_dq = codebook.decode(codes, m)  # (nb, M)
    alive = alpha > 0
    safe_alpha = torch.where(alive, alpha, torch.ones_like(alpha))[:, None]
    g = torch.zeros((codes.shape[0], n), dtype=torch.float32, device=codes.device)
    for _ in range(iters):
        _, g = qiht_step(g, q_dq, a, safe_alpha, codebook, s, step)
    norms = torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-12)
    target = float(np.sqrt(np.float32(m))) / safe_alpha
    g = g / norms * target
    return torch.where(alive[:, None], g, torch.zeros_like(g))
