"""Drivers around the kernels (port of ``repro.kernels.ops``).

``bqcs_encode_fused`` builds the encoder's operands once per codec (A^T
padded for the scalar families, the codebook's tables) and calls the fused
encoder; ``block_sparsify`` and ``bqcs_encode`` are the staged encoder's
two kernels; ``qgamp_ea_run_packed`` and ``gamp_ae_run`` are the
fixed-trip-count GAMP solves: the reference's ``lax.scan`` becomes a Python
loop of kernel launches.  The kernels mask their own ragged row tiles, so no
row padding is needed.  On CPU tensors every kernel call takes its plain
version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.codebook import as_codebook
from repro_torch.core.compression import packed_width
from repro_torch.core.gamp import block_prior_energy, norm_guard, tau_tables
from repro_torch.kernels import gm_prior as _gm
from repro_torch.kernels.block_topk import block_topk as _topk
from repro_torch.kernels.bqcs_encode import bqcs_encode as _staged_encode
from repro_torch.kernels.bqcs_encode_fused import bqcs_encode_fused as _encode
from repro_torch.kernels.gamp_step import gamp_step
from repro_torch.kernels.qgamp_step import qgamp_step

__all__ = [
    "EncoderTables",
    "encoder_a_t",
    "encoder_tables",
    "bqcs_encode_fused",
    "block_sparsify",
    "bqcs_encode",
    "qgamp_step",
    "gamp_step",
    "qgamp_ea_run",
    "qgamp_ea_run_packed",
    "gamp_ae_run",
]


def encoder_a_t(a: torch.Tensor, codebook) -> torch.Tensor:
    """A (M, N) -> the fused encoder's A^T operand (codecs cache it).  The
    scalar families take zero columns out to the word multiple
    Mp = W * (32 // Q) (the pad lanes are masked to code 0); vq takes A^T
    unpadded (Mp = M: every measurement lane is real, and the padding is
    at the code-lane level, G -> W * (32 // Q))."""
    m, n = a.shape
    if codebook.dim > 1:
        return a.T.contiguous()
    bits = codebook.bits
    mp = packed_width(m, bits) * (32 // bits)
    a_t = torch.zeros((n, mp), dtype=torch.float32, device=a.device)
    a_t[:, :m] = a.T
    return a_t


class EncoderTables(NamedTuple):
    """The fused encoder's codebook operands on one device."""

    tab: torch.Tensor  # scalar: (L - 1,) thresholds; vq: (L, d) centroids
    half_norms: Optional[torch.Tensor]  # vq: (L,) 0.5 * ||c_l||^2
    dither: Optional[torch.Tensor]  # dithered: (Mp,) dither, zero past M


def encoder_tables(codebook, m: int, device) -> EncoderTables:
    if codebook.dim > 1:
        return EncoderTables(codebook.centroids_t(device), codebook.half_norms_t(device), None)
    dither = codebook.dither_t(device)
    if dither is not None:
        mp = packed_width(m, codebook.bits) * (32 // codebook.bits)
        dither = torch.nn.functional.pad(dither, (0, mp - m))
    return EncoderTables(codebook.thresholds_t(device), None, dither)


def bqcs_encode_fused(blocks, residual, a, codebook, s, a_t=None, tables=None):
    """Fused encoder: error feedback -> top-S -> scale/project/encode ->
    uint32 wire packing, for any codebook family.  blocks/residual (nb, N),
    a (M, N).  Returns (words uint32 (nb, W), alpha (nb,), new_residual
    (nb, N)) with W = ceil(n_codes / (32 // Q)).  ``codebook``: a Codebook
    of any family or a legacy LloydMaxQuantizer."""
    codebook = as_codebook(codebook)
    m = a.shape[0]
    if a_t is None:
        a_t = encoder_a_t(a, codebook)
    if tables is None:
        tables = encoder_tables(codebook, m, blocks.device)
    return _encode(
        blocks.to(torch.float32).contiguous(), residual.to(torch.float32).contiguous(),
        a_t, tables.tab, s=s, m=m, bits=codebook.bits,
        dither=tables.dither, half_norms=tables.half_norms,
    )


def block_sparsify(blocks: torch.Tensor, s: int):
    """Bisection top-S sparsify (the staged encoder's first kernel).
    Returns (sparse, residual)."""
    return _topk(blocks.to(torch.float32).contiguous(), s)


def bqcs_encode(blocks: torch.Tensor, a: torch.Tensor, codebook):
    """Staged scale + project + quantize for an undithered scalar codebook
    (the reference's ``ops.bqcs_encode``); bf16/f16 blocks are upcast to
    f32.  blocks (nb, N), a (M, N).  Returns (codes uint8 (nb, M), alpha)."""
    codebook = as_codebook(codebook)
    if codebook.dim != 1 or getattr(codebook, "dither", None) is not None:
        raise ValueError("the staged encoder takes an undithered scalar codebook")
    return _staged_encode(
        blocks.to(torch.float32).contiguous(), a.T.contiguous(),
        codebook.thresholds_t(blocks.device)
    )


def _init_state(init_var: torch.Tensor, n: int, m: int, L: int, lam0: float):
    nb = init_var.shape[0]
    theta = _gm.pack_init_theta(nb, L, init_var, lam0)
    ghat = torch.zeros((nb, n), dtype=torch.float32, device=init_var.device)
    nu_g = torch.clamp(init_var, min=1e-12)[:, None].expand(nb, n).contiguous()
    shat = torch.zeros((nb, m), dtype=torch.float32, device=init_var.device)
    return ghat, nu_g, shat, theta


def _qgamp_ea(obs, alpha, a, taus, bits: int, m: int, n_components: int, iters: int,
              em: bool, lam0: float) -> torch.Tensor:
    """The EA solve of both entry points: ``obs`` is (nb, M) int32 codes
    when ``bits == 0`` or (nb, W) uint32 wire words when ``bits == Q``."""
    n = a.shape[1]
    lo_tau, hi_tau = tau_tables(taus)
    alpha = alpha.to(torch.float32)
    alive = alpha > 0.0
    safe_alpha = torch.where(alive, alpha, torch.ones_like(alpha))
    init_var = block_prior_energy(alpha, m, n)
    ghat, nu_g, shat, theta = _init_state(init_var, n, m, n_components, lam0)
    alpha2d = safe_alpha[:, None].contiguous()
    obs = obs.contiguous()
    for _ in range(iters):
        ghat, nu_g, shat, theta = qgamp_step(
            ghat, nu_g, shat, theta, obs, alpha2d, lo_tau, hi_tau, a,
            n_components=n_components, em=em, bits=bits,
        )
    ghat = torch.where(alive[:, None], ghat, torch.zeros_like(ghat))
    root_m = float(np.sqrt(np.float32(m)))
    true_norm = torch.where(alive, root_m / safe_alpha, torch.zeros_like(alpha))
    return norm_guard(ghat, true_norm)


def qgamp_ea_run(
    codes: torch.Tensor,  # (nb, M) code indices (any integer dtype)
    alpha: torch.Tensor,  # (nb,) transmitted scales (0 = dead block)
    a: torch.Tensor,  # (M, N)
    taus: torch.Tensor,  # (2^Q - 1,) interior Lloyd-Max thresholds
    n_components: int = 3,
    iters: int = 25,
    em: bool = True,
    lam0: float = 0.9,
) -> torch.Tensor:
    """EA reconstruction on code indices: ``iters`` launches of qgamp_step
    on the (nb, M) codes, the reference's scalar-variance ``qem_gamp`` with
    a fixed trip count.  Dead rows (alpha == 0) come out exactly zero; the
    final norm guard clips against sqrt(M)/alpha.  Returns (nb, N)."""
    return _qgamp_ea(codes.to(torch.int32), alpha, a, taus, 0, codes.shape[1], n_components,
                     iters, em, lam0)


def qgamp_ea_run_packed(
    words: torch.Tensor,  # (nb, W) uint32 packed wire words
    alpha: torch.Tensor,  # (nb,) transmitted scales (0 = dead block)
    a: torch.Tensor,  # (M, N)
    taus: torch.Tensor,  # (2^Q - 1,) interior Lloyd-Max thresholds
    bits: int,
    m: int,
    n_components: int = 3,
    iters: int = 25,
    em: bool = True,
    lam0: float = 0.9,
) -> torch.Tensor:
    """Packed-domain EA reconstruction: ``iters`` launches of qgamp_step on
    the wire words.  Dead rows (alpha == 0) run with alpha = 1 and come out
    exactly zero; the final norm guard clips against the transmitted norm
    sqrt(M)/alpha.  Returns (nb, N)."""
    return _qgamp_ea(words, alpha, a, taus, bits, m, n_components, iters, em, lam0)


def gamp_ae_run(
    y: torch.Tensor,  # (nb, M) Bussgang-aggregated observations
    nu_d: torch.Tensor,  # (nb,) effective AWGN variance (eq. 24)
    a: torch.Tensor,  # (M, N)
    init_var: torch.Tensor,  # (nb,) per-entry signal energy
    n_components: int = 3,
    iters: int = 25,
    em: bool = True,
    lam0: float = 0.9,
) -> torch.Tensor:
    """AE reconstruction: ``iters`` launches of gamp_step, then the norm
    guard against the expected aggregate norm sqrt(init_var * N)."""
    m = y.shape[1]
    n = a.shape[1]
    init_var = init_var.to(torch.float32)
    ghat, nu_g, shat, theta = _init_state(init_var, n, m, n_components, lam0)
    y = y.to(torch.float32).contiguous()
    nud2 = nu_d.to(torch.float32)[:, None].contiguous()
    for _ in range(iters):
        ghat, nu_g, shat, theta = gamp_step(
            ghat, nu_g, shat, theta, y, nud2, a, n_components=n_components, em=em
        )
    return norm_guard(ghat, torch.sqrt(torch.clamp(init_var * n, min=0.0)))
