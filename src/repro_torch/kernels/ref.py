"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each function repeats its kernel's semantics (same math, same iteration
counts, same tie rule) in plain tensor ops, on any device.  The wrappers
take them for CPU tensors, the CPU tests hold them against the reference's
oracles, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card.  They are no yardstick of speed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import gm_prior

_EPS = 1e-12


def _scale_project_ref(blocks: torch.Tensor, a_t: torch.Tensor):
    """alpha = sqrt(M)/||block|| (0 for dead blocks) and y = (alpha * b) @ A^T."""
    m = a_t.shape[1]
    sq = torch.sum(blocks * blocks, dim=1, keepdim=True)
    alive = sq > 1e-30
    inv_norm = torch.rsqrt(torch.where(alive, sq, torch.ones_like(sq)))
    root_m = float(np.sqrt(np.float32(m)))  # the f32 sqrt(M), as a Python float
    alpha = torch.where(alive, root_m * inv_norm, torch.zeros_like(sq))
    return (blocks * alpha) @ a_t, alpha[:, 0]


def block_topk_ref(blocks: torch.Tensor, s: int, iters: int = 26):
    """Bisection-threshold top-S: `iters` halvings of [0, max|x|] in fp32,
    then keep |x| >= hi, plus the row max (so ties and the max survive)."""
    mag = torch.abs(blocks)
    mx = torch.amax(mag, dim=1, keepdim=True)
    hi = mx.clone()
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = torch.sum(mag >= mid, dim=1, keepdim=True) > s
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    keep = (mag >= hi) | (mag == mx)
    sparse = torch.where(keep, blocks, torch.zeros_like(blocks))
    return sparse, blocks - sparse


def bqcs_encode_ref(blocks: torch.Tensor, a_t: torch.Tensor, taus: torch.Tensor):
    """Staged encoder oracle: scale -> dense project -> threshold bucketize.
    (nb, N), (N, M), (L - 1,) -> (codes uint8 (nb, M), alpha (nb,))."""
    y, alpha = _scale_project_ref(blocks, a_t)
    codes = torch.sum(y[:, :, None] > taus[None, None, :], dim=-1)
    return codes.to(torch.uint8), alpha


def bqcs_encode_fused_ref(
    blocks: torch.Tensor,
    residual: torch.Tensor,
    a_t: torch.Tensor,  # (N, M)
    taus: torch.Tensor,  # (L - 1,) thresholds; unused when centroids are given
    s: int,
    bits: int,
    iters: int = 26,
    dither: torch.Tensor = None,  # (M,) per-lane subtractive dither
    centroids: torch.Tensor = None,  # (L, d): nearest-centroid encode
    half_norms: torch.Tensor = None,  # (L,) 0.5 * ||c_l||^2 for the vq score
):
    """Fused encoder oracle: error-feedback add -> bisection top-S ->
    scale/project -> encode -> lane-group uint32 packing.  The encode is the
    threshold bucketize of ``y + dither`` for the scalar families, or the
    nearest centroid (``core.codebook.vq_nearest``) when ``centroids`` is
    given.  Returns (words uint32 (nb, W), alpha (nb,), new_residual (nb, N))."""
    from repro_torch.core.codebook import vq_nearest  # layering
    from repro_torch.core.compression import pack_codes

    carry = blocks + residual
    sparse, resid = block_topk_ref(carry, s, iters=iters)
    y, alpha = _scale_project_ref(sparse, a_t)
    if centroids is not None:
        codes = vq_nearest(y, centroids, half_norms)
    else:
        if dither is not None:
            y = y + dither[None, :]
        codes = torch.sum(y[:, :, None] > taus[None, None, :], dim=-1)
    return pack_codes(codes, bits), alpha, resid


def _gm_input_and_em(rhat, v, theta, n, L, em):
    """Shared input-channel + EM tail of the two GAMP-step oracles."""
    gh, ng, post = gm_prior.gm_input_channel(rhat, v, gm_prior.unpack_theta(theta, L))
    return gh, ng, (gm_prior.em_refresh(post, n) if em else theta)


def qgamp_step_ref(
    ghat, nu_g, shat, theta, codes, alpha, lo_tau, hi_tau, a, n_components=3, em=True
):
    """One scalar-variance quantized-channel Q-EM-GAMP iteration.

    codes (nb, M) int; alpha (nb, 1) strictly positive; lo_tau/hi_tau (2^Q,)
    bin-edge tables; theta packed (nb, 1+3L).
    """
    from repro_torch.core.gamp import _quantized_channel  # layering

    m = codes.shape[1]
    n = ghat.shape[1]
    al2 = alpha * alpha
    nu_p = torch.clamp(al2 / m * torch.sum(nu_g, dim=1, keepdim=True), min=_EPS)
    phat = alpha * (ghat @ a.T) - nu_p * shat
    xpost, nu_x = _quantized_channel(phat, nu_p, codes, lo_tau, hi_tau)
    shat_new = (xpost - phat) / nu_p
    nu_s = torch.clamp((1.0 - nu_x / nu_p) / nu_p, min=_EPS)
    nu_r = 1.0 / torch.clamp(al2 / m * torch.sum(nu_s, dim=1, keepdim=True), min=_EPS)
    rhat = ghat + nu_r * (alpha * (shat_new @ a))
    gh, ng, th = _gm_input_and_em(rhat, nu_r, theta, n, n_components, em)
    return gh, ng, shat_new, th


def gamp_step_ref(ghat, nu_g, shat, theta, y, nu_d, a, n_components=3, em=True):
    """One scalar-variance AWGN EM-GAMP iteration; theta packed (nb, 1+3L)."""
    m = y.shape[1]
    n = ghat.shape[1]
    nu_d = torch.clamp(nu_d, min=_EPS)
    nu_p = torch.clamp(torch.sum(nu_g, dim=1, keepdim=True) / m, min=_EPS)
    phat = ghat @ a.T - nu_p * shat
    xpost = (phat * nu_d + y * nu_p) / (nu_p + nu_d)
    nu_x = nu_p * nu_d / (nu_p + nu_d)
    shat_new = (xpost - phat) / nu_p
    nu_s = torch.clamp((1.0 - nu_x / nu_p) / nu_p, min=_EPS)
    nu_r = 1.0 / nu_s
    rhat = ghat + nu_r * (shat_new @ a)
    gh, ng, th = _gm_input_and_em(rhat, nu_r, theta, n, n_components, em)
    return gh, ng, shat_new, th
