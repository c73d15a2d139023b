"""EM-GAMP / Q-EM-GAMP (paper Procedure 2), port of ``repro.core.gamp``.

Two output channels: the quantized channel of the EA strategy (the
observation is the code index; truncated-Gaussian moment match between the
Lloyd-Max cell edges, eqs. 12-16) and the AWGN channel of the AE strategy
(the Bussgang-linearized aggregate, eqs. 23-24).  The input channel is the
Bernoulli Gaussian-mixture prior (eq. 11) with EM-learned hyperparameters
(eq. 17).

This slice ports the kernel route only: scalar-variance, undamped GAMP at
a fixed trip count, driven by ``kernels/ops.py`` over the fused step
kernels.  The shared channel numerics (``trunc_channel_moments``), the
protocol constants (``tau_tables``, ``block_prior_energy``, ``norm_guard``)
and the dispatch rule live here, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import not_in_slice

__all__ = [
    "GampConfig",
    "qem_gamp_packed",
    "em_gamp",
    "trunc_channel_moments",
    "tau_tables",
    "block_prior_energy",
    "norm_guard",
]

_EPS = 1e-12
_TRUNC_CLIP = 9.0  # standardize-clip for truncated-normal stability in f32


@dataclasses.dataclass(frozen=True)
class GampConfig:
    """Hyperparameters of the (Q-)EM-GAMP solver (same fields and defaults
    as the reference)."""

    n_components: int = 3  # L
    iters: int = 25  # fixed trip count
    tol: float = 1e-5  # early-freeze tolerance (XLA route only)
    damping: float = 1.0
    variance_mode: str = "exact"  # "exact" | "scalar"
    em: bool = True
    lam0_init: float = 0.9
    early_stop: bool = False


# float32 constants as Python floats holding the exact f32 values (a tensor
# op with a Python scalar computes in the tensor's f32), so no host-to-device
# copy -- which would synchronise the stream -- sits on the decode path.
_INV_SQRT2 = float(np.float32(1.0) / np.sqrt(np.float32(2.0)))
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * math.pi)))


def _trunc_z(ac: torch.Tensor, bc: torch.Tensor) -> torch.Tensor:
    """Bin mass Phi(bc) - Phi(ac) (ac <= bc), accurate in BOTH tails in f32:
    complementary erfc forms keep the mass a difference of small numbers
    (upper tail: Phic(ac) - Phic(bc); otherwise Phi = 0.5 erfc(-x/sqrt2))."""
    z_up = 0.5 * (torch.erfc(ac * _INV_SQRT2) - torch.erfc(bc * _INV_SQRT2))
    z_dn = 0.5 * (torch.erfc(-bc * _INV_SQRT2) - torch.erfc(-ac * _INV_SQRT2))
    return torch.where(ac > 0, z_up, z_dn)


def _npdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * (x * x)) / _SQRT_2PI


def trunc_channel_moments(phat, nu_p, lo, hi):
    """Truncated-normal posterior moments of x ~ N(phat, nu_p) given
    x in (lo, hi] (eqs. 12-16), with the reference's far-tail fallback: when
    the bin lies ENTIRELY more than _TRUNC_CLIP sds to one side of phat
    (a > clip or b < -clip), the posterior concentrates at the nearest edge
    and the exact ratios lose all signal in f32, so the mean is projected
    just inside the bin with tail variance nu_p / a^2.  ``nu_p`` must
    already be clamped positive.  The CUDA kernel repeats these steps."""
    sd = torch.sqrt(nu_p)
    a = (lo - phat) / sd
    b = (hi - phat) / sd
    far = (a > _TRUNC_CLIP) | (b < -_TRUNC_CLIP)
    ac = torch.clamp(a, -_TRUNC_CLIP, _TRUNC_CLIP)
    bc = torch.clamp(b, -_TRUNC_CLIP, _TRUNC_CLIP)
    z = torch.clamp(_trunc_z(ac, bc), min=1e-30)
    pa, pb = _npdf(ac), _npdf(bc)
    ratio1 = (pa - pb) / z
    ratio2 = (ac * pa - bc * pb) / z
    xpost_exact = phat + sd * ratio1
    nu_exact = nu_p * torch.clamp(1.0 + ratio2 - ratio1 * ratio1, min=1e-8)
    amin = torch.minimum(torch.abs(a), torch.abs(b))
    edge = torch.minimum(torch.maximum(phat, lo), hi)
    inward = torch.where(phat < lo, 1.0, -1.0)
    xpost_far = edge + inward * sd / torch.clamp(amin, min=1.0)
    nu_far = nu_p / torch.clamp(amin * amin, min=1.0)
    xpost = torch.where(far, xpost_far, xpost_exact)
    nu_x = torch.where(far, nu_far, nu_exact)
    return xpost, torch.minimum(nu_x, nu_p)


def _quantized_channel(phat, nu_p, codes, lo_tau, hi_tau):
    """Truncated-Gaussian posterior given x in (lo_tau[code], hi_tau[code]]."""
    nu_p = torch.clamp(nu_p, min=_EPS)
    idx = codes.long()
    return trunc_channel_moments(phat, nu_p, lo_tau[idx], hi_tau[idx])


def tau_tables(taus: torch.Tensor):
    """Interior thresholds (L - 1,) -> (lo_tau, hi_tau) bin-edge tables (L,)
    with +-4*_TRUNC_CLIP sentinels standing in for +-inf."""
    taus = taus.to(torch.float32)
    big = torch.full((1,), 4.0 * _TRUNC_CLIP, dtype=torch.float32, device=taus.device)
    return torch.cat([-big, taus]), torch.cat([taus, big])


def block_prior_energy(alpha: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Per-entry prior energy from the transmitted scale:
    E[g_n^2] = M / (N alpha^2); 1.0 for dead blocks."""
    alive = alpha > 0
    safe = torch.where(alive, alpha, torch.ones_like(alpha))
    return torch.where(alive, m / (n * (safe * safe)), torch.ones_like(alpha))


def norm_guard(ghat: torch.Tensor, exp_norm: torch.Tensor) -> torch.Tensor:
    """Clips each reconstructed block to 2x its expected norm (a diverged AMP
    fixed point only shows as an inflated estimate)."""
    est_norm = torch.linalg.vector_norm(ghat, dim=-1)
    scale = torch.clamp(2.0 * exp_norm / torch.clamp(est_norm, min=1e-30), max=1.0)
    return ghat * scale[:, None]


def _kernel_dispatch_ok(cfg: GampConfig) -> bool:
    """The fused kernels implement scalar-variance undamped GAMP at a fixed
    trip count."""
    return cfg.variance_mode == "scalar" and cfg.damping == 1.0 and not cfg.early_stop


def _require_kernel_route(cfg: GampConfig, use_kernels: bool) -> None:
    if not use_kernels:
        raise not_in_slice("GAMP with use_kernels=False (the XLA-algorithm route)", "item 1")
    if not _kernel_dispatch_ok(cfg):
        raise not_in_slice(
            f"GAMP with variance_mode={cfg.variance_mode!r}, damping={cfg.damping}, "
            f"early_stop={cfg.early_stop} (the XLA-algorithm route)",
            "item 1" if not cfg.early_stop else "item 2",
        )


def qem_gamp_packed(
    words: torch.Tensor,  # (nb, W) uint32 packed wire words
    alpha: torch.Tensor,  # (nb,) transmitted scale factors
    a: torch.Tensor,  # (M, N) sensing matrix
    quantizer,  # ScalarCodebook
    cfg: GampConfig,
    m: int,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Packed-domain Q-EM-GAMP: the words stream into the fused qgamp_step
    kernel, which unpacks them per lane group, so the (nb, M) index tensor
    never exists in device memory.  Returns (nb, N) block estimates."""
    _require_kernel_route(cfg, use_kernels)
    from repro_torch.kernels import ops as kops  # layering: kernels import core

    return kops.qgamp_ea_run_packed(
        words, alpha, a, quantizer.thresholds_t(words.device),
        bits=quantizer.bits, m=m, n_components=cfg.n_components,
        iters=cfg.iters, em=cfg.em, lam0=cfg.lam0_init,
    )


def em_gamp(
    y: torch.Tensor,  # (nb, M) linear observations y = A g + noise
    noise_var: torch.Tensor,  # (nb,) AWGN variance per block (eq. 24)
    a: torch.Tensor,  # (M, N)
    cfg: GampConfig,
    init_var: Optional[torch.Tensor] = None,  # (nb,) per-entry signal energy
    use_kernels: bool = True,
) -> torch.Tensor:
    """EM-GAMP on a noisy unquantized observation (aggregate-and-estimate),
    driven over the fused gamp_step kernel.  Returns (nb, N) blocks."""
    nb, m = y.shape
    n = a.shape[1]
    if init_var is None:
        init_var = torch.clamp(torch.sum(y * y, dim=-1) - m * noise_var, min=_EPS) / n
    _require_kernel_route(cfg, use_kernels)
    from repro_torch.kernels import ops as kops

    return kops.gamp_ae_run(
        y, noise_var, a, init_var.to(torch.float32),
        n_components=cfg.n_components, iters=cfg.iters, em=cfg.em, lam0=cfg.lam0_init,
    )
