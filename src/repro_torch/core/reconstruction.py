"""PS-side gradient reconstruction strategies (paper Sec. IV, Procedure 1),
port of ``repro.core.reconstruction``.

  * estimate_and_aggregate_packed (FedQCS-EA, steps 12-14): Q-EM-GAMP per
    (worker, block) straight from the packed wire words, then the
    rho-weighted sum.  This is the reference's monolithic (``chunk=0``)
    ``recon_engine.ea_decode`` inlined: K*nb rows, one solve, dispatched per
    codebook family as the reference does (lloyd_max -> ``qgamp_step``,
    vq -> ``gamp_step`` on the Bussgang AWGN fallback, dithered_uniform ->
    the plain GAMP loop, whose channel shifts the cell edges per lane).
  * aggregate_and_estimate (FedQCS-AE, steps 16-20): Bussgang-combine all K
    workers, one EM-GAMP solve.  The reference's G > 1 groups are not ported.

A worker with rho_k = 0 contributes exactly nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import not_in_slice
from repro_torch.core import bussgang
from repro_torch.core.gamp import GampConfig, em_gamp, qem_gamp_packed

__all__ = ["estimate_and_aggregate_packed", "aggregate_and_estimate", "gamp_config_from"]


def gamp_config_from(codec, iters: Optional[int] = None) -> GampConfig:
    cfg = codec.cfg
    return GampConfig(
        n_components=cfg.gamp_components,
        iters=iters if iters is not None else cfg.gamp_iters,
        variance_mode=cfg.gamp_variance_mode,
    )


def estimate_and_aggregate_packed(
    codec,
    words: torch.Tensor,  # (K, nb, W) uint32 packed wire words
    alphas: torch.Tensor,  # (K, nb)
    rhos: torch.Tensor,  # (K,)
    gamp: Optional[GampConfig] = None,
    use_kernels: Optional[bool] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """FedQCS-EA from the wire words -> (nb, N) aggregated blocks."""
    gamp = gamp or gamp_config_from(codec)
    if use_kernels is None:
        use_kernels = codec.cfg.use_kernels
    if chunk is None:
        chunk = codec.cfg.recon_chunk
    if chunk:
        raise not_in_slice(f"chunked EA decode (recon_chunk={chunk})", "item 2")
    k, nb = words.shape[:2]
    flat = qem_gamp_packed(
        words.reshape(k * nb, -1), alphas.reshape(k * nb), codec.a, codec.codebook,
        gamp, codec.cfg.m, use_kernels=use_kernels,
    )
    return torch.einsum("k,kbn->bn", rhos, flat.reshape(k, nb, -1))


def aggregate_and_estimate(
    codec,
    codes: torch.Tensor,  # (K, nb, n_codes)
    alphas: torch.Tensor,  # (K, nb)
    rhos: torch.Tensor,  # (K,)
    groups: int = 1,
    gamp: Optional[GampConfig] = None,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """FedQCS-AE: Bussgang-aggregate all K workers, one EM-GAMP solve (G = 1)."""
    if groups != 1:
        raise not_in_slice(f"AE decode in G={groups} groups", "item 6")
    gamp = gamp or gamp_config_from(codec)
    if use_kernels is None:
        use_kernels = codec.cfg.use_kernels
    q = codec.codebook
    return em_gamp(
        bussgang.aggregate_codes(codes, alphas, rhos, q, codec.cfg.m),
        bussgang.effective_noise_var(alphas, rhos, q),
        codec.a, gamp,
        init_var=bussgang.signal_energy(alphas, rhos, codec.cfg.m, codec.cfg.block_size),
        use_kernels=use_kernels,
    )
