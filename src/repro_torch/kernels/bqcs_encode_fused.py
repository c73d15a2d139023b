"""Single-pass fused BQCS encoder (paper Sec. III, eqs. 7-10) on Hopper.

Replaces the Pallas kernel ``repro/kernels/bqcs_encode_fused.py``
(``_fused_kernel`` / ``bqcs_encode_fused_pallas``), scalar undithered
branch.  One launch does the whole client compressor, including the wire
packing:

    carry  = blocks + residual                 (error feedback, eq. 8)
    sparse = TopS(carry)                       (26-step bisection, eq. 7)
    resid  = carry - sparse                    (new error-feedback state)
    alpha  = sqrt(M) / ||sparse||              (0 for dead rows, eq. 9)
    y      = (alpha * sparse) @ A^T            (sparse product, kept entries)
    code   = #{tau_j < y}                      (threshold bucketize, eq. 10)
    word   = OR_j code[group j] << (j * Q)     (uint32 lane-group packing)

The CUDA source is ``csrc/bqcs_encode_fused.cu``.  The wrapper takes the
plain version (``ref.bqcs_encode_fused_ref``) for CPU tensors and launches
the kernel for CUDA tensors; ``launches`` counts kernel launches only.
"""

from __future__ import annotations

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
    a_t: torch.Tensor,  # (N, Mp) f32, Mp = W * (32 // Q), zero columns past M
    taus: torch.Tensor,  # (L - 1,) f32 interior thresholds
    s: int,
    m: int,  # true measurement count M <= Mp
    bits: int,  # Q
    iters: int = BISECT_ITERS,
):
    """Returns (words uint32 (nb, W), alpha f32 (nb,), new_residual (nb, N))."""
    nb, n = blocks.shape
    mp = a_t.shape[1]
    per_word = 32 // bits
    if mp % per_word or not 0 < m <= mp:
        raise ValueError(f"a_t width {mp} must be a multiple of {per_word} and >= m={m}")
    dev = blocks.device
    f32 = torch.float32
    _check("blocks", blocks, (nb, n), f32, dev)
    _check("residual", residual, (nb, n), f32, dev)
    _check("a_t", a_t, (n, mp), f32, dev)
    _check("taus", taus, ((1 << bits) - 1,), f32, dev)
    if dev.type == "cpu":
        return ref.bqcs_encode_fused_ref(blocks, residual, a_t[:, :m], taus, s, bits, iters)
    if dev.type != "cuda":
        raise ValueError(f"bqcs_encode_fused runs on cpu or cuda tensors, got {dev}")
    lib = build.library()
    w = mp // per_word
    words = torch.empty((nb, w), dtype=torch.uint32, device=dev)
    alpha = torch.empty((nb,), dtype=f32, device=dev)
    resid = torch.empty_like(blocks)
    lib.call(
        "bqcs_encode_fused_launch",
        blocks.data_ptr(), residual.data_ptr(), a_t.data_ptr(), taus.data_ptr(),
        words.data_ptr(), alpha.data_ptr(), resid.data_ptr(),
        nb, n, mp, m, s, bits, taus.shape[0], iters, build.stream_handle(dev),
    )
    global launches
    launches += 1
    return words, alpha, resid
