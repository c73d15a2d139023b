"""Wireless uplink models behind the ``ChannelFamily`` registry, port of
``repro.fed.channel``.

The reconstruction already consumes a per-block AWGN variance
(``em_gamp(..., noise_var)``); this module supplies the wireless term.  Each
uplink model registers a :class:`ChannelFamily` whose hooks the engine
calls, so a new channel lands as one registration.

Family hooks (``cfg`` is the frozen :class:`ChannelConfig`; ``draw(purpose,
shape)`` returns the round's random tensor for ``purpose`` -- the round
engine's draw seam, see ``fed/engine.py``):

  * ``realize(cfg, draw, clients, nblocks) -> ChannelRealization`` -- one
    round's channel state for a ``clients``-slot cohort, drawn before the
    cohort passes run (so outage folds into the effective rhos and the
    residual carry).  Purposes: ``"gain"`` (Exp(1), rayleigh), ``"h"`` and
    ``"h_err"`` (N(0, 1), mimo_mac).
  * ``transmit(cfg, realization, x, draw) -> y`` -- pushes the cohort's
    transmitted rows ``x`` through the channel (purpose ``"noise"``,
    N(0, 1)).  Per-client families return per-client receptions of ``x``'s
    shape; multiple-access families return the superimposed ``Y = H X + N``.
  * ``effective_noise(realization) -> (C, nblocks)`` -- the per-client
    post-equalization variance threaded into ``em_gamp``'s ``noise_var``.
  * ``combine(cfg, realization, y, w, active, ..., with_aux=False)`` --
    multiple-access only: the joint-estimation decode (:func:`mimo_combine`).

Traits drive the engine's method gating:

  * ``exact_codes`` -- error-free digital uplink: the only regime where
    code-domain methods (EA, QIHT, dither, signsgd) are defined.
  * ``multiple_access`` -- the PS receives ONE superimposed signal.

Registered families: ``ideal`` (zero added variance), ``awgn`` (noise
variance ``10**(-snr_db/10)`` per measurement), ``rayleigh`` (one power gain
``|h_k|^2 ~ Exp(1)`` per client per round, equalized variance ``sigma^2 /
g_k``, outage below ``outage_gain``) and ``mimo_mac`` (over-the-air MIMO
multiple access: ``Y = H X + sigma N`` with an ``n_rx x C`` real fading
matrix, combined with the PS's estimate ``H_hat = H + sqrt(csi_error)
Delta`` by LMMSE or zero-forcing).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ChannelConfig",
    "ChannelRealization",
    "ChannelFamily",
    "CHANNEL_FAMILIES",
    "register_channel_family",
    "get_channel_family",
    "realize_uplink",
    "snr_noise_var",
    "mimo_tx_gain",
    "mimo_combine",
]

Draw = Callable[[str, Tuple[int, ...]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    kind: str = "ideal"  # any registered family: ideal | awgn | rayleigh | mimo_mac
    snr_db: float = 20.0  # receive SNR per measurement (unit transmit power)
    outage_gain: float = 0.05  # truncated-inversion floor on |h|^2 (rayleigh)
    n_rx: int = 8  # mimo_mac: PS receive antennas (rows of H)
    csi_error: float = 0.0  # mimo_mac: per-entry variance of the CSI estimate error
    combiner: str = "lmmse"  # mimo_mac spatial combiner: lmmse | zf


class ChannelRealization(NamedTuple):
    """One round's uplink draw for a C-client cohort.

    noise_var: (C, nblocks) effective post-equalization AWGN variance on each
      client's unit-power measurement rows (0 for ideal / outage / MAC).
    mask: (C,) 1.0 for clients whose uplink closed, 0.0 for outage.
    h / h_hat / sigma2: multiple-access families only -- the true (n_rx, C)
      fading matrix, the PS's CSI estimate of it, and the scalar receiver
      noise variance; ``None`` for per-client families.
    """

    noise_var: torch.Tensor
    mask: torch.Tensor
    h: Optional[torch.Tensor] = None
    h_hat: Optional[torch.Tensor] = None
    sigma2: Optional[torch.Tensor] = None

    def to(self, device) -> "ChannelRealization":
        return ChannelRealization(*(None if x is None else x.to(device) for x in self))


@dataclasses.dataclass(frozen=True)
class ChannelFamily:
    """The protocol every uplink model implements (module docstring)."""

    name: str
    exact_codes: bool
    multiple_access: bool
    realize: Callable[..., ChannelRealization]
    transmit: Callable[..., torch.Tensor]
    effective_noise: Callable[[ChannelRealization], torch.Tensor]
    combine: Optional[Callable[..., Tuple[torch.Tensor, ...]]] = None


CHANNEL_FAMILIES: Dict[str, ChannelFamily] = {}


def register_channel_family(name: str, family: ChannelFamily) -> None:
    """Registers ``family`` under ``ChannelConfig.kind == name``."""
    CHANNEL_FAMILIES[name] = family


def get_channel_family(kind: str) -> ChannelFamily:
    """Resolves a registered family; the only kind dispatch of the port."""
    try:
        return CHANNEL_FAMILIES[kind]
    except KeyError:
        raise ValueError(
            f"unknown channel kind {kind!r} (registered: {sorted(CHANNEL_FAMILIES)})"
        ) from None


def snr_noise_var(snr_db: float) -> float:
    """sigma^2 = 10**(-SNR_dB/10): noise power at unit receive signal power."""
    return float(10.0 ** (-snr_db / 10.0))


def realize_uplink(cfg: ChannelConfig, draw: Draw, clients: int,
                   nblocks: int) -> ChannelRealization:
    """One round's channel state for a ``clients``-slot cohort, through the
    registry.  The realization lives where ``draw``'s tensors do (the CPU
    for families that draw nothing)."""
    return get_channel_family(cfg.kind).realize(cfg, draw, clients, nblocks)


# ---------------------------------------------------------------------------
# per-client families: ideal / awgn / rayleigh
# ---------------------------------------------------------------------------


def _ideal_realize(cfg, draw, clients, nblocks):
    return ChannelRealization(torch.zeros((clients, nblocks)), torch.ones((clients,)))


def _awgn_realize(cfg, draw, clients, nblocks):
    sigma2 = snr_noise_var(cfg.snr_db)
    return ChannelRealization(torch.full((clients, nblocks), sigma2), torch.ones((clients,)))


def _rayleigh_realize(cfg, draw, clients, nblocks):
    sigma2 = snr_noise_var(cfg.snr_db)
    gain = draw("gain", (clients,)).to(torch.float32)  # |h|^2 ~ Exp(1)
    alive = gain >= cfg.outage_gain
    safe = torch.where(alive, gain, torch.ones_like(gain))
    nu = torch.where(alive, sigma2 / safe, torch.zeros_like(gain))
    return ChannelRealization(
        nu[:, None].expand(clients, nblocks).contiguous(), alive.to(torch.float32)
    )


def _ideal_transmit(cfg, real, x, draw):
    return x


def _pointwise_transmit(cfg, real, x, draw):
    """Per-client reception: each client's (nb, M) rows arrive with their
    equalized noise at the realization's per-(client, block) variance.
    x: (C, nb, M)."""
    noise = draw("noise", tuple(x.shape)).to(x.device, x.dtype)
    return x + noise * torch.sqrt(real.noise_var)[..., None]


def _pointwise_noise(real):
    return real.noise_var


register_channel_family("ideal", ChannelFamily(
    name="ideal", exact_codes=True, multiple_access=False,
    realize=_ideal_realize, transmit=_ideal_transmit, effective_noise=_pointwise_noise,
))
register_channel_family("awgn", ChannelFamily(
    name="awgn", exact_codes=False, multiple_access=False,
    realize=_awgn_realize, transmit=_pointwise_transmit, effective_noise=_pointwise_noise,
))
register_channel_family("rayleigh", ChannelFamily(
    name="rayleigh", exact_codes=False, multiple_access=False,
    realize=_rayleigh_realize, transmit=_pointwise_transmit, effective_noise=_pointwise_noise,
))


# ---------------------------------------------------------------------------
# mimo_mac: over-the-air MIMO multiple-access uplink
# ---------------------------------------------------------------------------


def _mimo_realize(cfg, draw, clients, nblocks):
    if cfg.n_rx < 1:
        raise ValueError(f"mimo_mac needs n_rx >= 1 receive antennas, got {cfg.n_rx}")
    if cfg.combiner not in ("lmmse", "zf"):
        raise ValueError(
            f"unknown mimo_mac combiner {cfg.combiner!r} (choose 'lmmse' or 'zf')"
        )
    h = draw("h", (cfg.n_rx, clients)).to(torch.float32)
    if cfg.csi_error > 0:
        h_hat = h + float(np.sqrt(cfg.csi_error)) * draw("h_err", tuple(h.shape)).to(h)
    else:
        h_hat = h
    return ChannelRealization(
        torch.zeros((clients, nblocks), device=h.device),
        torch.ones((clients,), device=h.device),
        h=h,
        h_hat=h_hat,
        sigma2=torch.tensor(snr_noise_var(cfg.snr_db), dtype=torch.float32, device=h.device),
    )


def _mimo_transmit(cfg, real, x, draw):
    """The multiple-access superposition ``Y = H X + sigma N``: x (C, nb, M)
    pre-scaled transmit rows (non-participants carry zero rows) ->
    (n_rx, nb, M), whose size does not grow with the cohort."""
    y = torch.einsum("rk,kbm->rbm", real.h, x)
    noise = draw("noise", tuple(y.shape)).to(y.device, y.dtype)
    return y + torch.sqrt(real.sigma2) * noise


def _mimo_noise(real):
    # no per-client equalized variance: the decode-side estimate comes out of
    # `combine`
    return real.noise_var


def mimo_tx_gain(w: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Open-loop power control: one broadcast scalar ``eta = 1 / rms(active
    w)`` that brings the cohort's average transmit power back to the unit
    power the SNR is defined against (clients pre-scale by their Bussgang
    weight ``w_k ~ rho_k / (gamma alpha_k)``).  0 when the whole cohort is
    silent."""
    w2 = torch.square(w) * active[:, None]  # (C, nb)
    n = torch.clamp(torch.sum(active) * w.shape[1], min=1.0)
    mean_w2 = torch.sum(w2) / n
    return torch.where(
        mean_w2 > 0, torch.rsqrt(torch.clamp(mean_w2, min=1e-30)), torch.zeros_like(mean_w2)
    ).to(torch.float32)


def mimo_combine(
    cfg: ChannelConfig,
    real: ChannelRealization,
    y: torch.Tensor,  # (n_rx, nb, M) superimposed reception
    w: torch.Tensor,  # (C, nb) Bussgang weights the clients pre-scaled with
    active: torch.Tensor,  # (C,) 1.0 = transmitted this round, 0.0 = silent
    psi: float = 1.0,  # codebook per-entry second moment (transmit power)
    tx_gain: Optional[torch.Tensor] = None,  # mimo_tx_gain eta (None = 1)
    with_aux: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Joint-estimation decode: one combining vector ``f`` turns ``Y = H X +
    sigma N`` into an estimate of the rho-weighted aggregate measurements
    plus its post-combining noise variance.

      * ``lmmse``: ``f = (H P H^T + (sigma^2 + csi_error tr P) I)^-1 H p``
        with per-client power ``p_k = psi * mean_b w_kb^2`` (0 for silent
        clients);
      * ``zf``: ``f^T h_k = 1`` exactly on active columns (needs n_rx >=
        #active); silent columns are pinned out of the (C, C) solve.

    The combiner sees only ``h_hat``; the noise estimate charges the target
    mismatch, the CSI error and the combined receiver noise:

        nu_b = psi sum_k w_kb^2 (f^T h_hat_k - t_k)^2
             + psi csi_error ||f||^2 sum_k w_kb^2 + sigma^2 ||f||^2.

    ``tx_gain`` is divided back out.  Returns ``(y_eff (nb, M), nu_eff
    (nb,))``, and with ``with_aux`` a third item: ``csi_target_mismatch``
    (mean ``(f^T h_hat_k - 1)^2`` over active columns) and
    ``combiner_norm2`` (``||f||^2``)."""
    h_hat = real.h_hat
    if tx_gain is not None:
        w = w * tx_gain  # the combiner sees the powers actually on the air
    w2 = torch.square(w) * active[:, None]  # (C, nb)
    if cfg.combiner == "zf":
        ha = h_hat * active[None, :]
        gram = ha.T @ ha + torch.diag(1.0 - active)
        c = torch.linalg.solve(gram, active)
        f = ha @ c  # (n_rx,)
    else:  # lmmse
        p = psi * torch.mean(w2, dim=1)  # (C,) per-client transmit power
        cov = (h_hat * p[None, :]) @ h_hat.T
        reg = real.sigma2 + float(cfg.csi_error) * torch.sum(p)
        eye = torch.eye(cfg.n_rx, dtype=torch.float32, device=h_hat.device)
        f = torch.linalg.solve(cov + reg * eye, h_hat @ p)
    y_eff = torch.einsum("r,rbm->bm", f, y)
    e = torch.einsum("r,rk->k", f, h_hat) - active  # target mismatch per column
    f2 = torch.sum(torch.square(f))
    nu = psi * torch.einsum("k,kb->b", torch.square(e) * active, w2)
    nu = nu + psi * float(cfg.csi_error) * f2 * torch.sum(w2, dim=0)
    nu = nu + real.sigma2 * f2
    if tx_gain is not None:
        # back to the un-amplified aggregate's domain (eta = 0: the whole
        # cohort was silent, f = 0 already)
        inv = torch.where(tx_gain > 0, 1.0 / torch.clamp(tx_gain, min=1e-30),
                          torch.zeros_like(tx_gain))
        y_eff = y_eff * inv
        nu = nu * torch.square(inv)
    if with_aux:
        n_active = torch.clamp(torch.sum(active), min=1.0)
        aux = {
            "csi_target_mismatch": torch.sum(torch.square(e) * active) / n_active,
            "combiner_norm2": f2,
        }
        return y_eff, nu, aux
    return y_eff, nu


register_channel_family("mimo_mac", ChannelFamily(
    name="mimo_mac", exact_codes=False, multiple_access=True,
    realize=_mimo_realize, transmit=_mimo_transmit,
    effective_noise=_mimo_noise, combine=mimo_combine,
))
