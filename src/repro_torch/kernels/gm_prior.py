"""Shared input side of the two GAMP step kernels (port of
``repro.kernels.gm_prior``): the Bernoulli Gaussian-mixture posterior
(eq. 11) and the EM hyperparameter refresh (eq. 17) on the packed theta

    theta = [lam0 | lam_1..L | mu_1..L | phi_1..L]   (rows, 1 + 3L) f32.

These are the plain PyTorch versions; the CUDA kernels carry the same steps
as ``__device__`` functions in ``csrc/gm_prior.cuh``.
"""

from __future__ import annotations

import torch

_EPS = 1e-12
_INV_SQRT_2PI = 0.3989422804014327


def unpack_theta(th: torch.Tensor, L: int):
    """(rows, 1+3L) -> (lam0 (rows,1), lam (rows,L), mu (rows,L), phi (rows,L))."""
    return th[:, 0:1], th[:, 1 : 1 + L], th[:, 1 + L : 1 + 2 * L], th[:, 1 + 2 * L : 1 + 3 * L]


def gm_input_channel(rhat: torch.Tensor, v: torch.Tensor, theta_parts):
    """Posterior mean/var of g given rhat = g + N(0, v), g ~ BG(theta).

    rhat (rows, N); v (rows, 1).  Returns (ghat_new, nu_g_new, posterior),
    posterior = (lam_post0, lam_post, mu_post, phi_post) for `em_refresh`.
    """
    lam0, lam, mu, phi = theta_parts
    r3 = rhat[:, :, None]
    muc, phic, lamc = mu[:, None, :], phi[:, None, :], lam[:, None, :]
    beta0 = lam0 * (_INV_SQRT_2PI * torch.rsqrt(v)) * torch.exp(-0.5 * rhat * rhat / v)
    var_l = torch.clamp(v[:, :, None] + phic, min=_EPS)
    diff = r3 - muc
    beta = lamc * (_INV_SQRT_2PI * torch.rsqrt(var_l)) * torch.exp(-0.5 * diff * diff / var_l)
    denom = torch.clamp(beta0 + torch.sum(beta, dim=-1), min=_EPS)
    lam_post0 = beta0 / denom
    lam_post = beta / denom[:, :, None]
    mu_post = (r3 * phic + muc * v[:, :, None]) / var_l
    phi_post = v[:, :, None] * phic / var_l
    ghat_new = torch.sum(lam_post * mu_post, dim=-1)
    second = torch.sum(lam_post * (phi_post + mu_post * mu_post), dim=-1)
    nu_g_new = torch.clamp(second - ghat_new * ghat_new, min=_EPS)
    return ghat_new, nu_g_new, (lam_post0, lam_post, mu_post, phi_post)


def em_refresh(posterior, n: int) -> torch.Tensor:
    """EM refresh (eq. 17) -> new packed theta.  The component variance is
    the posterior scatter around the SAME-STEP refreshed mean mu_new."""
    lam_post0, lam_post, mu_post, phi_post = posterior
    lam0_new = torch.mean(lam_post0, dim=1, keepdim=True)
    lam_sum = torch.sum(lam_post, dim=1)
    lam_new = lam_sum / n
    safe = torch.clamp(lam_sum, min=_EPS)
    mu_new = torch.sum(lam_post * mu_post, dim=1) / safe
    dev = mu_new[:, None, :] - mu_post
    phi_new = torch.sum(lam_post * (dev * dev + phi_post), dim=1) / safe
    lam0_new = torch.clamp(lam0_new, 1e-6, 1.0 - 1e-6)
    lam_new = torch.clamp(lam_new, min=1e-8)
    total = torch.clamp(lam0_new + torch.sum(lam_new, dim=1, keepdim=True), min=_EPS)
    return torch.cat(
        [lam0_new / total, lam_new / total, mu_new, torch.clamp(phi_new, min=_EPS)], dim=1
    )


def pack_init_theta(nb: int, L: int, init_var: torch.Tensor, lam0: float) -> torch.Tensor:
    """Packed-theta form of the paper's init (mixture means spread over
    +-3 sigma, uniform weights on the non-zero part)."""
    dev = init_var.device
    sigma = torch.sqrt(torch.clamp(init_var, min=_EPS))
    gmax = 3.0 * sigma[:, None]
    ls = torch.arange(1, L + 1, dtype=torch.float32, device=dev)[None, :]
    mu0 = -gmax + (2.0 * ls - 1.0) / (2.0 * L) * (2.0 * gmax)
    phi0 = ((2.0 * gmax / L) ** 2 / 12.0).expand_as(mu0)
    return torch.cat(
        [
            torch.full((nb, 1), lam0, dtype=torch.float32, device=dev),
            torch.full((nb, L), (1.0 - lam0) / L, dtype=torch.float32, device=dev),
            mu0,
            phi0,
        ],
        dim=1,
    )
