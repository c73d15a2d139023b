"""PS-side gradient reconstruction strategies (paper Sec. IV, Procedure 1),
port of ``repro.core.reconstruction``.

  * estimate_and_aggregate (FedQCS-EA, steps 12-14): Q-EM-GAMP per
    (worker, block), then the rho-weighted sum, from the code indices or --
    ``estimate_and_aggregate_packed`` -- straight from the packed wire
    words.  Both delegate to the chunked engine
    (``recon_engine.ea_decode``), which dispatches per codebook family as
    the reference does (lloyd_max -> ``qgamp_step``, vq -> ``gamp_step`` on
    the Bussgang AWGN fallback, dithered_uniform -> the plain GAMP loop,
    whose channel shifts the cell edges per lane; every family takes the
    plain loop off the kernel route).
  * aggregate_and_estimate (FedQCS-AE, steps 16-20): Bussgang-combine within
    each of G groups of K / G workers, one EM-GAMP solve over the G * nb
    stacked rows (on the kernel route, ``gamp_step`` at G * nb rows), then
    the sum of the G estimates.

Payloads: codes (K, nb, n_codes) uint8 or words (K, nb, W) uint32, alphas
(K, nb), rhos (K,) summing to 1.  A worker with rho_k = 0 contributes
exactly nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bussgang
from repro_torch.core.gamp import GampConfig, em_gamp

__all__ = [
    "estimate_and_aggregate",
    "estimate_and_aggregate_packed",
    "aggregate_and_estimate",
    "gamp_config_from",
]


def gamp_config_from(codec, iters: Optional[int] = None) -> GampConfig:
    cfg = codec.cfg
    return GampConfig(
        n_components=cfg.gamp_components,
        iters=iters if iters is not None else cfg.gamp_iters,
        variance_mode=cfg.gamp_variance_mode,
    )


def _ea(codec, obs, alphas, rhos, gamp, use_kernels, chunk, with_info, packed):
    from repro_torch.core import recon_engine  # layering: the engine imports this module

    return recon_engine.ea_decode(
        codec, obs, alphas, rhos, gamp or gamp_config_from(codec), packed=packed,
        use_kernels=codec.cfg.use_kernels if use_kernels is None else use_kernels,
        chunk=codec.cfg.recon_chunk if chunk is None else chunk, with_info=with_info,
    )


def estimate_and_aggregate(
    codec,
    codes: torch.Tensor,  # (K, nb, n_codes)
    alphas: torch.Tensor,  # (K, nb)
    rhos: torch.Tensor,  # (K,)
    gamp: Optional[GampConfig] = None,
    use_kernels: Optional[bool] = None,
    chunk: Optional[int] = None,
    with_info: bool = False,
):
    """FedQCS-EA from the code indices -> (nb, N) aggregated blocks, or
    ``(blocks, GampInfo)`` with (K, nb)-shaped info.  ``use_kernels``
    defaults to ``cfg.use_kernels``, ``chunk`` (rows per engine chunk, 0 =
    one batch) to ``cfg.recon_chunk``."""
    return _ea(codec, codes, alphas, rhos, gamp, use_kernels, chunk, with_info, packed=False)


def estimate_and_aggregate_packed(
    codec,
    words: torch.Tensor,  # (K, nb, W) uint32 packed wire words
    alphas: torch.Tensor,  # (K, nb)
    rhos: torch.Tensor,  # (K,)
    gamp: Optional[GampConfig] = None,
    use_kernels: Optional[bool] = None,
    chunk: Optional[int] = None,
    with_info: bool = False,
):
    """FedQCS-EA straight from the wire words; bit-identical to
    :func:`estimate_and_aggregate` on the unpacked codes."""
    return _ea(codec, words, alphas, rhos, gamp, use_kernels, chunk, with_info, packed=True)


def aggregate_and_estimate(
    codec,
    codes: torch.Tensor,  # (K, nb, n_codes)
    alphas: torch.Tensor,  # (K, nb)
    rhos: torch.Tensor,  # (K,)
    groups: int = 1,
    gamp: Optional[GampConfig] = None,
    use_kernels: Optional[bool] = None,
    with_info: bool = False,
):
    """FedQCS-AE: Bussgang-aggregate within each of ``groups`` groups of
    K / G consecutive workers, one EM-GAMP solve over the (G * nb, M)
    stacked group observations, and the sum of the G group estimates.
    ``with_info`` returns ``(blocks, GampInfo)`` with (G * nb,)-shaped info.
    K must divide by G."""
    gamp = gamp or gamp_config_from(codec)
    if use_kernels is None:
        use_kernels = codec.cfg.use_kernels
    k, nb = codes.shape[:2]
    m, n = codec.cfg.m, codec.cfg.block_size
    if k % groups != 0:
        raise ValueError(f"K={k} not divisible by G={groups}")
    per = k // groups
    q = codec.codebook
    ys, nus, energies = [], [], []
    for g in range(groups):
        sl = slice(g * per, (g + 1) * per)
        ys.append(bussgang.aggregate_codes(codes[sl], alphas[sl], rhos[sl], q, m))
        nus.append(bussgang.effective_noise_var(alphas[sl], rhos[sl], q))
        energies.append(bussgang.signal_energy(alphas[sl], rhos[sl], m, n))
    ghat = em_gamp(
        torch.cat(ys), torch.cat(nus), codec.a, gamp, init_var=torch.cat(energies),
        use_kernels=use_kernels, with_info=with_info,
    )
    if with_info:
        ghat, info = ghat
        return torch.sum(ghat.reshape(groups, nb, n), dim=0), info
    return torch.sum(ghat.reshape(groups, nb, n), dim=0)
