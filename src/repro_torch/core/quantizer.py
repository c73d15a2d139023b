"""Lloyd-Max scalar quantizer optimized for N(0,1) (paper Sec. III-A).

Numpy near-copy of ``repro.core.quantizer``: the design runs once at config
time and its tables are protocol constants, so the port repeats the same
float64 fixed point step for step and its tables match the reference bit
for bit.

Bussgang constants of Proposition 1:

    gamma_Q = E[Q(X) X]   (eq. 21)   -- linear gain
    psi_Q   = E[Q(X)^2]   (eq. 22)   -- second moment
    kappa_Q = (psi_Q - gamma_Q^2) / gamma_Q^2   -- normalized distortion power
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["LloydMaxQuantizer", "design_lloyd_max", "encode", "decode", "quantize"]

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_ERF = np.vectorize(math.erf)


def _phi(x: np.ndarray) -> np.ndarray:
    """Standard normal pdf (numpy, design-time only)."""
    return _INV_SQRT_2PI * np.exp(-0.5 * np.square(x))


def _Phi(x: np.ndarray) -> np.ndarray:
    """Standard normal cdf (numpy, design-time only)."""
    return 0.5 * (1.0 + _ERF(np.asarray(x, dtype=np.float64) / _SQRT2))


@dataclasses.dataclass(frozen=True)
class LloydMaxQuantizer:
    """An optimal (MMSE) scalar quantizer for N(0,1).

    levels: (2**Q,) ascending reconstruction points; thresholds: the
    (2**Q - 1,) interior decision thresholds; gamma/psi: eqs. 21-22.
    """

    bits: int
    levels: np.ndarray
    thresholds: np.ndarray
    gamma: float
    psi: float

    @property
    def n_levels(self) -> int:
        return 1 << self.bits

    @property
    def kappa(self) -> float:
        return (self.psi - self.gamma**2) / (self.gamma**2)

    @property
    def distortion(self) -> float:
        """MSE for a unit-variance Gaussian input: E[(Q(X) - X)^2] = 1 - 2 gamma + psi."""
        return 1.0 - 2.0 * self.gamma + self.psi


def design_lloyd_max(bits: int, iters: int = 0, tol: float = 1e-12) -> LloydMaxQuantizer:
    """Designs the Lloyd-Max quantizer for N(0,1) by the fixed point
    tau_i = (q_i + q_{i+1}) / 2, q_i = E[X | tau_{i-1} < X <= tau_i]."""
    if not (1 <= bits <= 8):
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    n = 1 << bits
    if not iters:
        iters = 300 * n
    probs = (np.arange(n, dtype=np.float64) + 0.5) / n
    levels = np.array([_norm_ppf(p) for p in probs], dtype=np.float64)
    prev = levels.copy()
    for _ in range(iters):
        taus = 0.5 * (levels[:-1] + levels[1:])
        lo = np.concatenate([[-np.inf], taus])
        hi = np.concatenate([taus, [np.inf]])
        num = _phi(np.where(np.isfinite(lo), lo, 0.0)) * np.isfinite(lo) - _phi(
            np.where(np.isfinite(hi), hi, 0.0)
        ) * np.isfinite(hi)
        den = _Phi(hi) - _Phi(lo)
        levels = num / np.maximum(den, 1e-300)
        if np.max(np.abs(levels - prev)) < tol:
            break
        prev = levels.copy()
    taus = 0.5 * (levels[:-1] + levels[1:])

    lo = np.concatenate([[-np.inf], taus])
    hi = np.concatenate([taus, [np.inf]])
    phi_lo = np.where(np.isfinite(lo), _phi(np.where(np.isfinite(lo), lo, 0.0)), 0.0)
    phi_hi = np.where(np.isfinite(hi), _phi(np.where(np.isfinite(hi), hi, 0.0)), 0.0)
    gamma = float(np.sum(levels * (phi_lo - phi_hi)))
    psi = float(np.sum(np.square(levels) * (_Phi(hi) - _Phi(lo))))
    return LloydMaxQuantizer(
        bits=bits,
        levels=levels.astype(np.float64),
        thresholds=taus.astype(np.float64),
        gamma=gamma,
        psi=psi,
    )


def _norm_ppf(p: float, lo: float = -12.0, hi: float = 12.0) -> float:
    """Inverse standard normal CDF by bisection (design-time only)."""
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _Phi(np.array(mid)) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def encode(x: torch.Tensor, quantizer: LloydMaxQuantizer) -> torch.Tensor:
    """Code indices in [0, 2**Q): index i with taus[i-1] < x <= taus[i].
    Shape-preserving."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    taus = torch.as_tensor(quantizer.thresholds, dtype=dtype, device=x.device)
    return torch.searchsorted(taus, x.to(dtype).contiguous(), right=False).to(torch.uint8)


def decode(codes: torch.Tensor, quantizer: LloydMaxQuantizer, dtype=torch.float32) -> torch.Tensor:
    """Code indices back to reconstruction levels q_i."""
    levels = torch.as_tensor(quantizer.levels, dtype=dtype, device=codes.device)
    return levels[codes.long()]


def quantize(x: torch.Tensor, quantizer: LloydMaxQuantizer) -> torch.Tensor:
    """Q(x): quantize-dequantize in one go."""
    return decode(encode(x, quantizer), quantizer, dtype=x.dtype)
