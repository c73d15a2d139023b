"""EM-GAMP / Q-EM-GAMP (paper Procedure 2), port of ``repro.core.gamp``.

Two output channels: the quantized channel of the EA strategy (the
observation is the code index; truncated-Gaussian moment match between the
codebook's cell edges, eqs. 12-16, with a dither as a per-lane edge shift)
and the AWGN channel of the AE strategy (the Bussgang-linearized aggregate,
eqs. 23-24; also the vq EA fallback with K = 1).  The input channel is the
Bernoulli Gaussian-mixture prior (eq. 11) with EM-learned hyperparameters
(eq. 17).

Two routes, dispatched as the reference dispatches them:

  * the kernel route (``use_kernels=True``, the default here, with
    scalar-variance, undamped, fixed-trip-count GAMP): ``kernels/ops.py``
    drives the fused step kernels -- ``qgamp_step`` for undithered scalar codebooks, ``gamp_step`` for AE
    and for the vq EA fallback;
  * the reference's XLA loop ``_gamp_run``, ported as plain PyTorch: scalar
    or exact variance, damping, and the sticky early freeze at ``tol`` with
    per-block ``converged``/``iters`` outputs, and ``early_stop`` (the
    data-dependent trip count).  It serves every other config, and the
    dithered EA decode on either route (the step kernel has no per-lane
    edge shift).

The loop ports the reference's own ``_input_channel``/``_em_update`` rather
than the kernels' ``gm_prior``, whose numerics belong to the kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.codebook import as_codebook

__all__ = [
    "GampConfig",
    "GampInfo",
    "GampState",
    "gamp_health",
    "qem_gamp",
    "qem_gamp_packed",
    "em_gamp",
    "make_init_theta",
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
    tol: float = 1e-5  # early-freeze tolerance (plain loop only)
    damping: float = 1.0
    variance_mode: str = "exact"  # "exact" | "scalar"
    em: bool = True
    lam0_init: float = 0.9
    # end the plain loop once every block froze (outputs identical to the
    # fixed trip count; one host sync an iteration)
    early_stop: bool = False


class GampState(tuple):
    """(ghat, nu_g, shat, theta, converged, iters): the solver's opaque
    loop carry."""


class GampInfo(NamedTuple):
    """Per-block decode-health counters of one GAMP solve.

    converged: (nb,) bool -- the block hit the early-freeze tolerance before
      the trip cap (dead alpha == 0 rows count converged).
    iters: (nb,) int32 -- iterations the block was live for.
    Kernel-route solves have no freeze signal (fixed trip count): their info
    is the static ``cfg.iters`` with every block converged.
    """

    converged: torch.Tensor
    iters: torch.Tensor

    @staticmethod
    def static(nb: int, iters: int, device) -> "GampInfo":
        return GampInfo(
            converged=torch.ones((nb,), dtype=torch.bool, device=device),
            iters=torch.full((nb,), iters, dtype=torch.int32, device=device),
        )


# ---------------------------------------------------------------------------
# Prior (input channel): Bernoulli Gaussian-mixture, theta as a tuple
# (lam0 (nb,), lam (nb, L), mu (nb, L), phi (nb, L)).
# ---------------------------------------------------------------------------


def make_init_theta(nblocks: int, L: int, sigma: torch.Tensor, lam0: float = 0.9):
    """The paper's init (Sec. VI): mixture means spread over +-3 sigma,
    uniform weights on the non-zero part.  sigma (nb,) per-block scale."""
    sigma = sigma.to(torch.float32)
    dev = sigma.device
    gmax = 3.0 * sigma[:, None]
    gmin = -gmax
    ls = torch.arange(1, L + 1, dtype=torch.float32, device=dev)[None, :]
    mu = gmin + (2.0 * ls - 1.0) / (2.0 * L) * (gmax - gmin)
    phi = (((gmax - gmin) / L) ** 2 / 12.0).expand_as(mu)
    lam = torch.full((nblocks, L), (1.0 - lam0) / L, dtype=torch.float32, device=dev)
    lam0v = torch.full((nblocks,), lam0, dtype=torch.float32, device=dev)
    return (lam0v, lam, mu, phi)


def _gaussian_pdf(x, mean, var):
    var = torch.clamp(var, min=_EPS)
    return torch.exp(-0.5 * (x - mean) ** 2 / var) / torch.sqrt(2.0 * math.pi * var)


def _input_channel(rhat, nu_r, theta):
    """Posterior mean/var of g given rhat = g + N(0, nu_r), g ~ BG(theta).
    Returns (ghat, nu_g, lam_post0, lam_post, mu_post, phi_post); the
    posterior pieces feed the EM update (eq. 17).  rhat/nu_r (nb, N)."""
    lam0, lam, mu, phi = theta
    nu_r = torch.clamp(nu_r, min=_EPS)
    r = rhat[..., None]
    v = nu_r[..., None]
    muc, phic, lamc = mu[:, None, :], phi[:, None, :], lam[:, None, :]
    beta0 = lam0[:, None] * _gaussian_pdf(rhat, 0.0, nu_r)
    beta = lamc * _gaussian_pdf(r, muc, v + phic)
    denom = torch.clamp(beta0 + torch.sum(beta, dim=-1), min=_EPS)
    lam_post0 = beta0 / denom
    lam_post = beta / denom[..., None]
    mu_post = (r * phic + muc * v) / torch.clamp(v + phic, min=_EPS)
    phi_post = v * phic / torch.clamp(v + phic, min=_EPS)
    ghat = torch.sum(lam_post * mu_post, dim=-1)
    second = torch.sum(lam_post * (phi_post + mu_post**2), dim=-1)
    nu_g = torch.clamp(second - ghat**2, min=_EPS)
    return ghat, nu_g, lam_post0, lam_post, mu_post, phi_post


def _em_update(theta, lam_post0, lam_post, mu_post, phi_post):
    """EM hyperparameter refresh (eq. 17); the component variance is the
    posterior scatter around the same-step refreshed mean."""
    n = lam_post.shape[1]
    lam0_new = torch.mean(lam_post0, dim=1)
    lam_sum = torch.sum(lam_post, dim=1)
    lam_new = lam_sum / n
    safe = torch.clamp(lam_sum, min=_EPS)
    mu_new = torch.sum(lam_post * mu_post, dim=1) / safe
    phi_new = torch.sum(lam_post * ((mu_new[:, None, :] - mu_post) ** 2 + phi_post), dim=1) / safe
    lam0_new = torch.clamp(lam0_new, 1e-6, 1.0 - 1e-6)
    lam_new = torch.clamp(lam_new, min=1e-8)
    total = torch.clamp(lam0_new + torch.sum(lam_new, dim=-1), min=_EPS)
    return (lam0_new / total, lam_new / total[:, None], mu_new, torch.clamp(phi_new, min=_EPS))


# ---------------------------------------------------------------------------
# Output channels.
# ---------------------------------------------------------------------------


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


def _quantized_channel(phat, nu_p, codes, lo_tau, hi_tau, shift=None):
    """Truncated-Gaussian posterior of x ~ N(phat, nu_p) given
    x in (lo_tau[code] - shift, hi_tau[code] - shift]: ``shift`` is the
    codebook's per-lane subtractive dither (or None), since the encoder
    observed x + u in the bin."""
    nu_p = torch.clamp(nu_p, min=_EPS)
    idx = codes.long()
    lo, hi = lo_tau[idx], hi_tau[idx]
    if shift is not None:
        lo = lo - shift
        hi = hi - shift
    return trunc_channel_moments(phat, nu_p, lo, hi)


def _awgn_channel(phat, nu_p, y, nu_d):
    """Gaussian product posterior for y = x + N(0, nu_d) (paper Sec. IV-B)."""
    nu_p = torch.clamp(nu_p, min=_EPS)
    nu_d = torch.clamp(nu_d, min=_EPS)
    xpost = (phat * nu_d + y * nu_p) / (nu_p + nu_d)
    nu_x = nu_p * nu_d / (nu_p + nu_d)
    return xpost, nu_x


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




# ---------------------------------------------------------------------------
# The GAMP loop (the reference's XLA route, as plain PyTorch).
# ---------------------------------------------------------------------------


def _freeze(converged: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return torch.where(converged.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)


def _gamp_run(
    out_channel: Callable,  # (phat, nu_p) -> (xpost, nu_x)
    a: torch.Tensor,  # (M, N)
    alpha: torch.Tensor,  # (nb,) effective per-block scaling of A
    init_var: torch.Tensor,  # (nb,) per-entry prior energy of g
    cfg: GampConfig,
    nblocks: int,
    n: int,
    m: int,
):
    """``cfg.iters`` GAMP iterations on every block at once.  A block whose
    update falls below ``tol`` of its energy freezes (sticky), so its output
    is the state at its freeze; with ``cfg.early_stop`` the loop ends once
    every block froze.  Returns (ghat, nu_g, theta, converged, iters); dead
    rows (alpha == 0) are frozen from the start and come out zero."""
    dev = a.device
    alpha = alpha.to(torch.float32)
    alive = alpha > 0.0
    safe_alpha = torch.where(alive, alpha, torch.ones_like(alpha))
    al2 = (safe_alpha**2)[:, None]
    sa = safe_alpha[:, None]
    scalar_var = cfg.variance_mode == "scalar"
    a2 = None if scalar_var else a**2

    sigma = torch.sqrt(torch.clamp(init_var, min=_EPS))
    theta = make_init_theta(nblocks, cfg.n_components, sigma, cfg.lam0_init)
    ghat = torch.zeros((nblocks, n), dtype=torch.float32, device=dev)
    nu_g = torch.clamp(init_var, min=_EPS)[:, None].expand(nblocks, n).to(torch.float32)
    shat = torch.zeros((nblocks, m), dtype=torch.float32, device=dev)
    converged = ~alive
    iters = torch.zeros((nblocks,), dtype=torch.int32, device=dev)
    early_stop = cfg.early_stop and cfg.tol > 0.0
    for _ in range(cfg.iters):
        # the reference's while_loop tests "not all converged" before each
        # body, so a batch of dead rows runs 0 iterations; a frozen block is
        # a no-op, so the outputs equal the fixed trip count's.  The test is
        # one host sync an iteration: the price of the data-dependent count.
        if early_stop and bool(converged.all()):
            break
        iters = iters + (~converged).to(torch.int32)
        if scalar_var:
            nu_p = (al2 / m * torch.sum(nu_g, dim=-1, keepdim=True)).expand(nblocks, m)
        else:
            nu_p = al2 * (nu_g @ a2.T)
        nu_p = torch.clamp(nu_p, min=_EPS)
        phat = sa * (ghat @ a.T) - nu_p * shat
        xpost, nu_x = out_channel(phat, nu_p)
        shat_new = (xpost - phat) / nu_p
        nu_s = torch.clamp((1.0 - nu_x / nu_p) / nu_p, min=_EPS)
        if scalar_var:
            nu_r = 1.0 / torch.clamp(al2 / m * torch.sum(nu_s, dim=-1, keepdim=True), min=_EPS)
            nu_r = nu_r.expand(nblocks, n)
        else:
            nu_r = 1.0 / torch.clamp(al2 * (nu_s @ a2), min=_EPS)
        rhat = ghat + nu_r * (sa * (shat_new @ a))
        ghat_new, nu_g_new, lp0, lp, mp, pp = _input_channel(rhat, nu_r, theta)
        theta_new = _em_update(theta, lp0, lp, mp, pp) if cfg.em else theta
        if cfg.damping < 1.0:
            d = cfg.damping
            ghat_new = d * ghat_new + (1.0 - d) * ghat
            shat_new = d * shat_new + (1.0 - d) * shat
            nu_g_new = d * nu_g_new + (1.0 - d) * nu_g
        delta = torch.sum((ghat_new - ghat) ** 2, dim=-1)
        ref = torch.clamp(torch.sum(ghat**2, dim=-1), min=_EPS)
        converged = converged | (delta < cfg.tol * ref)
        ghat = _freeze(converged, ghat, ghat_new)
        nu_g = _freeze(converged, nu_g, nu_g_new)
        shat = _freeze(converged, shat, shat_new)
        theta = tuple(_freeze(converged, old, new) for old, new in zip(theta, theta_new))
    ghat = torch.where(alive[:, None], ghat, torch.zeros_like(ghat))
    return ghat, nu_g, theta, converged, iters


def gamp_health(info: GampInfo, live: Optional[torch.Tensor] = None):
    """Scalar summary of a GampInfo batch for the telemetry layer: mean and
    max live iterations and the converged-before-cap fraction over the
    ``live`` problem mask (default: all).  Returns a dict of f32 0-d
    tensors."""
    conv = info.converged.reshape(-1).to(torch.float32)
    iters = info.iters.reshape(-1).to(torch.float32)
    lf = torch.ones_like(iters) if live is None else live.reshape(-1).to(torch.float32)
    nlive = torch.clamp(torch.sum(lf), min=1.0)
    return {
        "gamp_iters_mean": torch.sum(iters * lf) / nlive,
        "gamp_iters_max": torch.max(iters * lf),
        "gamp_converged_frac": torch.sum(conv * lf) / nlive,
    }


def _kernel_dispatch_ok(cfg: GampConfig) -> bool:
    """The fused kernels implement scalar-variance undamped GAMP at a fixed
    trip count; any other config keeps the plain loop."""
    return cfg.variance_mode == "scalar" and cfg.damping == 1.0 and not cfg.early_stop


def _ea_kernel_ok(cb, cfg: GampConfig) -> bool:
    """qgamp_step reads scalar cell-edge tables with no per-lane shift, so it
    serves the undithered scalar codebooks only."""
    return _kernel_dispatch_ok(cfg) and cb.dim == 1 and getattr(cb, "dither", None) is None


def _qem_gamp_xla(codes, alpha, a, quantizer, cfg: GampConfig):
    """Plain-loop Q-EM-GAMP: the truncated-posterior channel on the scalar
    codebook's cell edges (dither as a per-lane edge shift), or the Bussgang
    AWGN fallback for vq.  Returns (guarded ghat, converged, iters)."""
    cb = as_codebook(quantizer)
    if cb.dim > 1:
        return _vq_ea_xla(codes, alpha, a, cb, cfg)
    nb, m = codes.shape
    n = a.shape[1]
    dev = codes.device
    lo_tau, hi_tau = tau_tables(cb.thresholds_t(dev))
    shift = cb.dither_t(dev)
    alpha = alpha.to(torch.float32)
    alive = alpha > 0
    init_var = block_prior_energy(alpha, m, n)

    def out(phat, nu_p):
        return _quantized_channel(phat, nu_p, codes, lo_tau, hi_tau, shift)

    ghat, _, _, converged, iters = _gamp_run(out, a, alpha, init_var, cfg, nb, n, m)
    # the PS knows the true block norm sqrt(M)/alpha (alpha is transmitted)
    root_m = float(np.sqrt(np.float32(m)))
    safe = torch.where(alive, alpha, torch.ones_like(alpha))
    true_norm = torch.where(alive, root_m / safe, torch.zeros_like(alpha))
    return norm_guard(ghat, true_norm), converged | ~alive, iters


def _vq_observation(codes, alpha, cb, m):
    """The vq EA fallback's AWGN observation: Q(alpha A g) = gamma alpha A g
    + d with cov(d) = (psi - gamma^2) I, normalized by gamma * alpha.
    Returns (alive, safe alpha, y (nb, M), nu (nb,))."""
    alpha = alpha.to(torch.float32)
    alive = alpha > 0
    safe = torch.where(alive, alpha, torch.ones_like(alpha))
    deq = cb.decode(codes, m)
    y = torch.where(alive[:, None], deq / (cb.gamma * safe[:, None]), torch.zeros_like(deq))
    nu = torch.where(alive, cb.kappa / safe**2, torch.ones_like(safe))
    return alive, safe, y, nu


def _vq_ea_xla(codes, alpha, a, cb, cfg: GampConfig):
    """Per-worker EA solve for a vector codebook on the plain loop: the
    Bussgang-linearized AWGN channel (eqs. 23-24 with K = 1)."""
    m, n = a.shape
    nb = codes.shape[0]
    alive, safe, y, nu = _vq_observation(codes, alpha, cb, m)
    init_var = block_prior_energy(alpha.to(torch.float32), m, n)
    nu2 = nu[:, None]

    def out(phat, nu_p):
        return _awgn_channel(phat, nu_p, y, nu2)

    # alpha is absorbed into y, so the GAMP scaling is 1 for live rows; the
    # 0/1 mask keeps dead rows frozen from iteration 0
    ghat, _, _, converged, iters = _gamp_run(
        out, a, alive.to(torch.float32), init_var, cfg, nb, n, m
    )
    root_m = float(np.sqrt(np.float32(m)))
    true_norm = torch.where(alive, root_m / safe, torch.zeros_like(safe))
    return norm_guard(ghat, true_norm), converged | ~alive, iters


def _vq_ea_kernel(codes, alpha, a, cb, cfg: GampConfig):
    """Kernel route of the vq EA fallback: the Bussgang-linearized channel
    is the AE kernel's AWGN channel, so the solve runs ``gamp_step`` over
    every (worker, block) row."""
    from repro_torch.kernels import ops as kops  # layering: kernels import core

    m, n = a.shape
    alive, _, y, nu = _vq_observation(codes, alpha, cb, m)
    init_var = block_prior_energy(alpha.to(torch.float32), m, n)
    ghat = kops.gamp_ae_run(
        y, nu, a, init_var, n_components=cfg.n_components, iters=cfg.iters, em=cfg.em,
        lam0=cfg.lam0_init,
    )
    # gamp_ae_run's norm guard uses sqrt(init_var * N) == sqrt(M)/alpha, the
    # true transmitted norm; dead rows still need the explicit zero
    return torch.where(alive[:, None], ghat, torch.zeros_like(ghat))


def qem_gamp(
    codes: torch.Tensor,  # (nb, n_codes) code indices
    alpha: torch.Tensor,  # (nb,) transmitted scale factors
    a: torch.Tensor,  # (M, N)
    quantizer,  # Codebook (or legacy LloydMaxQuantizer)
    cfg: GampConfig,
    use_kernels: bool = True,
    with_info: bool = False,
):
    """Q-EM-GAMP (Procedure 2) from code indices -> (nb, N) blocks, or
    ``(blocks, GampInfo)`` with ``with_info``.  ``use_kernels`` takes the
    step kernels where the reference takes its Pallas kernels: qgamp_step
    for an undithered scalar codebook, gamp_step for the vq fallback, both
    for scalar-variance undamped configs only; everything else runs the
    plain loop."""
    cb = as_codebook(quantizer)
    static = GampInfo.static(codes.shape[0], cfg.iters, codes.device)
    if use_kernels and _kernel_dispatch_ok(cfg) and cb.dim > 1:
        ghat = _vq_ea_kernel(codes, alpha, a, cb, cfg)
        return (ghat, static) if with_info else ghat
    if use_kernels and _ea_kernel_ok(cb, cfg):
        from repro_torch.kernels import ops as kops

        ghat = kops.qgamp_ea_run_packed(
            codes.to(torch.int32).contiguous(), alpha, a, cb.thresholds_t(codes.device),
            bits=0, m=codes.shape[1], n_components=cfg.n_components, iters=cfg.iters,
            em=cfg.em, lam0=cfg.lam0_init,
        )
        return (ghat, static) if with_info else ghat
    ghat, converged, iters = _qem_gamp_xla(codes, alpha, a, cb, cfg)
    return (ghat, GampInfo(converged, iters)) if with_info else ghat


def qem_gamp_packed(
    words: torch.Tensor,  # (nb, W) uint32 packed wire words
    alpha: torch.Tensor,  # (nb,) transmitted scale factors
    a: torch.Tensor,  # (M, N) sensing matrix
    quantizer,  # Codebook (or legacy LloydMaxQuantizer)
    cfg: GampConfig,
    m: int,  # true measurement count M (the words carry M / dim lanes)
    use_kernels: bool = True,
    with_info: bool = False,
):
    """Packed-domain Q-EM-GAMP.  On the undithered scalar kernel route the
    words stream into ``qgamp_step``, which unpacks them per lane group, so
    the (nb, M) index tensor never exists in device memory; the other routes
    unpack first and then dispatch as :func:`qem_gamp`."""
    from repro_torch.core.compression import unpack_codes  # layering

    cb = as_codebook(quantizer)
    if use_kernels and _ea_kernel_ok(cb, cfg):
        from repro_torch.kernels import ops as kops  # layering: kernels import core

        ghat = kops.qgamp_ea_run_packed(
            words, alpha, a, cb.thresholds_t(words.device),
            bits=cb.bits, m=m, n_components=cfg.n_components,
            iters=cfg.iters, em=cfg.em, lam0=cfg.lam0_init,
        )
        static = GampInfo.static(words.shape[0], cfg.iters, words.device)
        return (ghat, static) if with_info else ghat
    codes = unpack_codes(words, cb.bits, cb.n_codes(m))
    return qem_gamp(codes, alpha, a, cb, cfg, use_kernels=use_kernels, with_info=with_info)


def em_gamp(
    y: torch.Tensor,  # (nb, M) linear observations y = A g + noise
    noise_var: torch.Tensor,  # (nb,) AWGN variance per block (eq. 24)
    a: torch.Tensor,  # (M, N)
    cfg: GampConfig,
    init_var: Optional[torch.Tensor] = None,  # (nb,) per-entry signal energy
    use_kernels: bool = True,
    with_info: bool = False,
):
    """EM-GAMP on a noisy unquantized observation (aggregate-and-estimate):
    the ``gamp_step`` kernel for scalar-variance undamped configs with
    ``use_kernels``, else the plain loop.  Returns (nb, N) blocks, or
    ``(blocks, GampInfo)`` with ``with_info``."""
    nb, m = y.shape
    n = a.shape[1]
    if init_var is None:
        init_var = torch.clamp(torch.sum(y * y, dim=-1) - m * noise_var, min=_EPS) / n
    init_var = init_var.to(torch.float32)
    if use_kernels and _kernel_dispatch_ok(cfg):
        from repro_torch.kernels import ops as kops

        ghat = kops.gamp_ae_run(
            y, noise_var, a, init_var,
            n_components=cfg.n_components, iters=cfg.iters, em=cfg.em, lam0=cfg.lam0_init,
        )
        return (ghat, GampInfo.static(nb, cfg.iters, y.device)) if with_info else ghat
    nvar = noise_var.to(torch.float32)[:, None]

    def out(phat, nu_p):
        return _awgn_channel(phat, nu_p, y, nvar)

    ones = torch.ones((nb,), dtype=torch.float32, device=y.device)
    ghat, _, _, converged, iters = _gamp_run(out, a, ones, init_var, cfg, nb, n, m)
    # expected ||g_sum||^2 = init_var * N (see norm_guard)
    ghat = norm_guard(ghat, torch.sqrt(torch.clamp(init_var * n, min=0.0)))
    return (ghat, GampInfo(converged, iters)) if with_info else ghat
