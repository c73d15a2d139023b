"""Bussgang linearization and aggregate-and-estimate combining (Sec. IV-B),
port of ``repro.core.bussgang``.

Proposition 1: for a codebook designed for the standard normal (any
family: gamma and psi are per dimension for vq),
Q(x) = gamma_Q x + d with d uncorrelated with x, so the weighted sum of
dequantized codes

    q_tilde = sum_k rho_k / (gamma_Q alpha_k) * q_k = A (sum_k rho_k g_k) + d_tilde

is a linear AWGN observation of the aggregate (eq. 23) with variance
nu = kappa_Q * sum_k (rho_k / alpha_k)^2 (eq. 24).
"""

from __future__ import annotations

import torch

from repro_torch.core.codebook import as_codebook

__all__ = [
    "bussgang_weight",
    "aggregate_codes",
    "aggregate_packed",
    "effective_noise_var",
    "signal_energy",
]


def _safe(alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(alpha > 0, alpha, torch.ones_like(alpha))


def bussgang_weight(rho: torch.Tensor, alpha: torch.Tensor, quantizer) -> torch.Tensor:
    """Per-(worker, block) combining weight rho_k / (gamma_Q alpha_{k,b});
    alpha == 0 (empty block) contributes weight 0."""
    w = rho / (as_codebook(quantizer).gamma * _safe(alpha))
    return torch.where(alpha > 0, w, torch.zeros_like(w))


def aggregate_codes(codes, alphas, rhos, quantizer, m=None) -> torch.Tensor:
    """q_tilde (nb, M) from (K, nb, n_codes) codes: the Bussgang aggregate of
    eq. 23.  The codebook decodes the n_codes = M / dim lanes to the M
    measurements (vq: centroid dimension j of group g to lane j*G + g)."""
    cb = as_codebook(quantizer)
    deq = cb.decode(codes, m)
    w = bussgang_weight(rhos[:, None], alphas, cb)
    return torch.sum(w[..., None] * deq, dim=0)


def aggregate_packed(words, alphas, rhos, quantizer, m: int) -> torch.Tensor:
    """q_tilde (nb, M) straight from the (K, nb, W) packed words."""
    cb = as_codebook(quantizer)
    deq = cb.decode_packed(words, m)
    w = bussgang_weight(rhos[:, None], alphas, cb)
    return torch.sum(w[..., None] * deq, dim=0)


def effective_noise_var(alphas, rhos, quantizer) -> torch.Tensor:
    """nu_{g,b} (nb,): AWGN variance of the effective distortion (eq. 24)."""
    ratio = rhos[:, None] / _safe(alphas)
    terms = torch.where(alphas > 0, ratio * ratio, torch.zeros_like(alphas))
    return as_codebook(quantizer).kappa * torch.sum(terms, dim=0)


def signal_energy(alphas, rhos, m: int, n: int) -> torch.Tensor:
    """Per-entry energy of the aggregated block for the GAMP init:
    sum_k rho_k^2 M / alpha_k^2 / N."""
    safe = _safe(alphas)
    terms = torch.where(
        alphas > 0, (rhos[:, None] * rhos[:, None]) * m / (safe * safe), torch.zeros_like(alphas)
    )
    return torch.sum(terms, dim=0) / n
