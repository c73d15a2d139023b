"""Single-pass fused BQCS encoder (paper Sec. III, eqs. 7-10) on Hopper.

Replaces the Pallas kernel ``repro/kernels/bqcs_encode_fused.py``
(``_fused_kernel`` / ``bqcs_encode_fused_pallas``), all three codebook
branches.  One launch does the whole client compressor, including the wire
packing:

    carry  = blocks + residual                 (error feedback, eq. 8)
    sparse = TopS(carry)                       (26-step bisection, eq. 7)
    resid  = carry - sparse                    (new error-feedback state)
    alpha  = sqrt(M) / ||sparse||              (0 for dead rows, eq. 9)
    y      = (alpha * sparse) @ A^T            (sparse product, kept entries)
    code   = #{tau_j < y + dither}             (scalar families, eq. 10)
           | argmax_l <y_g, c_l> - ||c_l||^2/2 (vq, j-major lane groups)
    word   = OR_j code[group j] << (j * Q)     (uint32 lane-group packing)

The CUDA source is ``csrc/bqcs_encode_fused.cu``.  The wrapper takes the
plain version (``ref.bqcs_encode_fused_ref``) for CPU tensors and launches
the kernel for CUDA tensors; ``launches`` counts kernel launches only.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

BISECT_ITERS = 26  # threshold ~1e-7 of the row's dynamic range
launches = 0


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, want {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bqcs_encode_fused(
    blocks: torch.Tensor,  # (nb, N) f32
    residual: torch.Tensor,  # (nb, N) f32 error-feedback state
    a_t: torch.Tensor,  # (N, Mp) f32: scalar Mp = W * (32 // Q), zero past M; vq Mp = M
    tab: torch.Tensor,  # scalar: (L - 1,) thresholds; vq: (L, d) centroids
    s: int,
    m: int,  # true measurement count M <= Mp
    bits: int,  # Q: index width on the wire
    iters: int = BISECT_ITERS,
    *,
    dither: Optional[torch.Tensor] = None,  # scalar: (Mp,) per-lane dither, zero past M
    half_norms: Optional[torch.Tensor] = None,  # vq: (L,) 0.5 * ||c_l||^2
):
    """Returns (words uint32 (nb, W), alpha f32 (nb,), new_residual (nb, N)).
    A 2-d ``tab`` selects the vq branch (d = tab.shape[1])."""
    nb, n = blocks.shape
    mp = a_t.shape[1]
    per_word = 32 // bits
    dev = blocks.device
    f32 = torch.float32
    vq_d = tab.shape[1] if tab.dim() == 2 else 1
    if vq_d > 1:
        if mp != m or m % vq_d or half_norms is None or dither is not None:
            raise ValueError(
                f"vq encode needs an unpadded a_t (Mp == M = {m}, got {mp}), d = {vq_d} "
                "dividing M, half_norms, and no dither"
            )
        if tab.shape[0] > 1 << bits:
            raise ValueError(f"{tab.shape[0]} centroids do not fit {bits}-bit codes")
        w = -(-(m // vq_d) // per_word)
        _check("tab", tab, tab.shape, f32, dev)
        _check("half_norms", half_norms, (tab.shape[0],), f32, dev)
    else:
        if mp % per_word or not 0 < m <= mp:
            raise ValueError(f"a_t width {mp} must be a multiple of {per_word} and >= m={m}")
        w = mp // per_word
        _check("tab", tab, ((1 << bits) - 1,), f32, dev)
        if dither is not None:
            _check("dither", dither, (mp,), f32, dev)
    _check("blocks", blocks, (nb, n), f32, dev)
    _check("residual", residual, (nb, n), f32, dev)
    _check("a_t", a_t, (n, mp), f32, dev)
    if dev.type == "cpu":
        if vq_d > 1:
            return ref.bqcs_encode_fused_ref(blocks, residual, a_t, None, s, bits, iters,
                                             centroids=tab, half_norms=half_norms)
        return ref.bqcs_encode_fused_ref(
            blocks, residual, a_t[:, :m], tab, s, bits, iters,
            dither=None if dither is None else dither[:m],
        )
    if dev.type != "cuda":
        raise ValueError(f"bqcs_encode_fused runs on cpu or cuda tensors, got {dev}")
    lib = build.library()
    words = torch.empty((nb, w), dtype=torch.uint32, device=dev)
    alpha = torch.empty((nb,), dtype=f32, device=dev)
    resid = torch.empty_like(blocks)
    lib.call(
        "bqcs_encode_fused_launch",
        blocks.data_ptr(), residual.data_ptr(), a_t.data_ptr(), tab.data_ptr(),
        None if half_norms is None else half_norms.data_ptr(),
        None if dither is None else dither.data_ptr(),
        words.data_ptr(), alpha.data_ptr(), resid.data_ptr(),
        nb, n, mp, m, s, bits, tab.shape[0], vq_d, iters, build.stream_handle(dev),
    )
    global launches
    launches += 1
    return words, alpha, resid
