"""BQCS end-to-end gradient codec (port of ``repro.core.compression``).

Pipeline per step, per client (paper Sec. III):

    grads (dict of tensors) --flatten+pad--> (nblocks, N) blocks
      + residual (error feedback, eq. 8)
      -> block top-S sparsify (residual out, eq. 7)
      -> project with shared A, scale alpha = sqrt(M)/||.||  (eq. 9)
      -> codebook encode (eq. 10): lloyd_max, dithered_uniform or vq
      -> bit-pack codes into uint32 words (the wire payload)

On the kernel route (``use_kernels=True``) the whole pipeline is ONE launch
of the fused encoder (``kernels/bqcs_encode_fused.py``); the default route
composes the reference's XLA-algorithm stages (``core/sparsify.py``, one
GEMM in ``core/sensing.py``, the codebook's encode, ``pack_codes``).  The
words carry ``n_codes = M / dim`` index lanes of ``bits`` each (scalar
families: n_codes == M).  Wire words are ``torch.uint32`` tensors in the
reference's lane-group layout, so words packed by either package unpack
identically in the other.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional

import torch

from repro_torch import entry_device
from repro_torch.core import sensing, sparsify
from repro_torch.core.codebook import Codebook, index_bits, make_codebook
from repro_torch.core.layout import GradientLayout, assemble, flatten_tree

__all__ = [
    "FedQCSConfig",
    "BQCSCodec",
    "CompressedGradient",
    "GradientLayout",
    "flatten_to_blocks",
    "flatten_to_blocks_batched",
    "blocks_to_tree",
    "pack_codes",
    "unpack_codes",
    "decode_packed",
    "packed_width",
]


@dataclasses.dataclass(frozen=True)
class FedQCSConfig:
    """Protocol parameters shared by every worker and the PS (same fields
    and defaults as the reference)."""

    block_size: int = 1024  # N
    reduction_ratio: int = 4  # R = N / M
    bits: int = 2  # Q: index bits per code
    codebook: str = "lloyd_max"
    vq_dim: int = 2
    vq_levels: int = 0
    s_ratio: float = 0.1  # S = floor(s_ratio * N) kept per block
    gamp_iters: int = 25
    gamp_components: int = 3  # L
    gamp_variance_mode: str = "exact"
    sparsifier: str = "topk"
    seed: int = 1234  # sensing-matrix seed (protocol constant)
    use_kernels: bool = False
    wire_mode: str = "gather_codes"
    recon_mode: str = "ae"
    recon_chunk: int = 0

    def validate(self) -> "FedQCSConfig":
        """Raises ValueError on incoherent knob combinations (the reference's
        checks, message for message in substance); returns self."""
        if self.block_size < 1 or self.reduction_ratio < 1:
            raise ValueError(
                f"block_size={self.block_size} and reduction_ratio="
                f"{self.reduction_ratio} must both be >= 1"
            )
        if self.m < 1:
            raise ValueError(
                f"reduction_ratio={self.reduction_ratio} leaves no measurements "
                f"(M = {self.block_size} // {self.reduction_ratio} = 0); use "
                f"reduction_ratio <= block_size"
            )
        if not (1 <= self.bits <= 8):
            raise ValueError(f"bits must be in [1, 8], got {self.bits}")
        if not (0.0 < self.s_ratio <= 1.0):
            raise ValueError(f"s_ratio must be in (0, 1], got {self.s_ratio}")
        if self.wire_mode not in ("gather_codes", "psum_dequant"):
            raise ValueError(
                f"unknown wire_mode {self.wire_mode!r} "
                "(choose 'gather_codes' or 'psum_dequant')"
            )
        if self.recon_mode not in ("ae", "ea"):
            raise ValueError(
                f"unknown recon_mode {self.recon_mode!r} (choose 'ae' or 'ea')"
            )
        if self.recon_mode == "ea" and self.wire_mode != "gather_codes":
            raise ValueError(
                "recon_mode='ea' needs the per-worker codes on the PS side, "
                "i.e. wire_mode='gather_codes' (see DESIGN.md); "
                f"got wire_mode={self.wire_mode!r}"
            )
        if self.recon_chunk < 0:
            raise ValueError(f"recon_chunk must be >= 0, got {self.recon_chunk}")
        if self.gamp_variance_mode not in ("exact", "scalar"):
            raise ValueError(
                f"unknown gamp_variance_mode {self.gamp_variance_mode!r} "
                "(choose 'exact' or 'scalar')"
            )
        if self.codebook == "vq" and self.m % self.vq_dim:
            raise ValueError(
                f"vq_dim={self.vq_dim} must divide M={self.m} "
                f"(= block_size // reduction_ratio)"
            )
        return self

    @property
    def m(self) -> int:
        return self.block_size // self.reduction_ratio

    @property
    def s(self) -> int:
        return max(1, int(self.s_ratio * self.block_size))

    @property
    def bits_per_entry(self) -> float:
        """Wire index bits per gradient entry (excl. the alphas): Q/R for the
        scalar families, ceil(log2 L)/(d*R) for vq."""
        if self.codebook == "vq":
            width = index_bits(self.vq_levels or (1 << self.bits))
            return width / (self.vq_dim * self.reduction_ratio)
        return self.bits / self.reduction_ratio


@dataclasses.dataclass
class CompressedGradient:
    """The wire payload of one worker for one step: ``codes`` are the packed
    uint32 words (nb, W) in the :func:`pack_codes` layout, covering
    ``n_codes = M / dim`` index lanes of ``bits`` each."""

    codes: torch.Tensor  # (nblocks, W) uint32 words
    alpha: torch.Tensor  # (nblocks,) f32 scales
    nbar: int  # original flat length
    m: int  # measurements per block
    bits: int  # Q: index width on the wire

    def wire_bits(self) -> int:
        """Bits on the wire from the true word count: nb * (W * 32 + 32 for
        alpha).  Q = 3 packs 10 codes a word, so M * Q would undercount."""
        nb, w = self.codes.shape[:2]
        return nb * (w * 32 + 32)


# ---------------------------------------------------------------------------
# parameter dict <-> blocks (core/layout.py owns the geometry)
# ---------------------------------------------------------------------------


def flatten_to_blocks(tree: Dict[str, torch.Tensor], n: int, row_multiple: int = 1):
    """(blocks (rows, N), layout, nbar): every leaf in ``jax.tree_util``
    order (keys sorted at every level, depth first), concatenated,
    zero-padded once to a multiple of N (and ``rows`` to a multiple of
    ``row_multiple``) -- the monolithic :class:`GradientLayout`."""
    layout = GradientLayout.monolithic(tree, n, row_multiple=row_multiple)
    return layout.to_blocks(tree), layout, layout.nbar


def flatten_to_blocks_batched(tree: Dict[str, torch.Tensor], n: int, row_multiple: int = 1):
    """Batched variant: every leaf carries a leading batch axis; returns
    (batch, rows, N) blocks, the UNBATCHED layout and nbar."""
    treedef, leaves = flatten_tree(tree)
    shapes = tuple((tuple(leaf.shape[1:]), leaf.dtype) for leaf in leaves)
    layout = GradientLayout.from_shapes(treedef, shapes, n, row_multiple=row_multiple)
    return layout.to_blocks_batched(tree), layout, layout.nbar


def blocks_to_tree(blocks: torch.Tensor, spec, nbar: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_to_blocks`.  ``spec`` is a
    :class:`GradientLayout` (``nbar`` is then ignored: the layout knows its
    own unpadding) or the legacy ``(treedef, shapes)`` tuple, whose
    ``treedef`` lists each leaf's key (or key path) in order."""
    if isinstance(spec, GradientLayout):
        return spec.tree_from_blocks(blocks)
    treedef, shapes = spec
    flat = blocks.reshape(-1)[:nbar]
    out, off = [], 0
    for shape, dtype in shapes:
        size = math.prod(int(d) for d in shape) if shape else 1
        out.append(flat[off : off + size].reshape(shape).to(dtype))
        off += size
    return assemble(treedef, out)


# ---------------------------------------------------------------------------
# bit packing (wire format)
# ---------------------------------------------------------------------------


def packed_width(m: int, bits: int) -> int:
    """uint32 words per block row on the wire: W = ceil(lanes / (32 // Q)).
    ``m`` counts code lanes: M for the scalar families, M / d for vq."""
    return -(-m // (32 // bits))


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Packs Q-bit indices into uint32 words, the canonical lane-group layout:
    measurement ``c`` lives in word ``c % W`` at bit ``(c // W) * Q``.
    (nb, M) integer codes -> (nb, W) uint32.  torch has no uint32 shifts,
    so the words are assembled in int64 and narrowed once."""
    per_word = 32 // bits
    nb, m = codes.shape
    w = packed_width(m, bits)
    grouped = torch.zeros((nb, w * per_word), dtype=torch.int64, device=codes.device)
    grouped[:, :m] = codes.to(torch.int64)
    grouped = grouped.reshape(nb, per_word, w)
    shifts = (torch.arange(per_word, device=codes.device) * bits)[None, :, None]
    return torch.sum(grouped << shifts, dim=1).to(torch.uint32)


def _unpack_groups(words: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., W) uint32 -> (..., per_word, W) int64 lane groups."""
    per_word = 32 // bits
    shifts = (torch.arange(per_word, device=words.device) * bits).reshape(
        (1,) * (words.dim() - 1) + (per_word, 1)
    )
    return (words.to(torch.int64)[..., None, :] >> shifts) & ((1 << bits) - 1)


def unpack_codes(words: torch.Tensor, bits: int, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (..., W) uint32 -> (..., m) uint8."""
    out = _unpack_groups(words, bits).to(torch.uint8)
    return out.reshape(words.shape[:-1] + (-1,))[..., :m]


def decode_packed(
    words: torch.Tensor, bits: int, m: int, levels: torch.Tensor
) -> torch.Tensor:
    """Dequantize straight from packed words: (..., W) uint32 -> (..., m) f32."""
    deq = levels[_unpack_groups(words, bits)]
    return deq.reshape(words.shape[:-1] + (-1,))[..., :m]


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


_KERNEL_BYPASS_WARNED = False


def _warn_kernel_bypass_once(cfg: FedQCSConfig) -> None:
    """use_kernels=True with gamp_variance_mode='exact' (the default) keeps
    every GAMP solve on the plain loop -- the step kernels implement
    scalar-variance GAMP only.  Name the conflict once per process, as the
    reference does; the fused encoder is unaffected."""
    global _KERNEL_BYPASS_WARNED
    if _KERNEL_BYPASS_WARNED:
        return
    if cfg.use_kernels and cfg.gamp_variance_mode == "exact":
        _KERNEL_BYPASS_WARNED = True
        warnings.warn(
            "FedQCSConfig(use_kernels=True, gamp_variance_mode='exact'): the "
            "GAMP step kernels implement scalar-variance GAMP, so every GAMP "
            "reconstruction will run the plain PyTorch loop despite "
            "use_kernels=True (the fused encoder still runs).  Set "
            "gamp_variance_mode='scalar' to route reconstruction through the "
            "kernels.",
            UserWarning,
            stacklevel=3,
        )


class BQCSCodec:
    """BQCS encoder/decoder bound to a FedQCSConfig, on one device.

    Two encode routes, as in the reference: ``use_kernels=True`` runs the
    fused encoder kernel; ``use_kernels=False`` (the default) composes the
    reference's XLA-algorithm stages -- exact top-S by a stable sort (or the
    bisecting threshold with ``sparsifier="bisect"``), one fp32 GEMM, the
    codebook's encode, then the wire packing.  ``a`` injects the sensing
    matrix (M, N) instead of drawing it from the config seed -- the way the
    tests hand the reference's matrix across (see
    ``convert.from_reference``).
    """

    def __init__(self, cfg: FedQCSConfig, a: Optional[torch.Tensor] = None, device="cuda"):
        self.cfg = cfg.validate()
        _warn_kernel_bypass_once(cfg)
        self.device = entry_device(device)
        self.codebook: Codebook = make_codebook(cfg)
        if a is None:
            a = sensing.sensing_matrix(cfg.seed, cfg.m, cfg.block_size, self.device)
        if tuple(a.shape) != (cfg.m, cfg.block_size):
            raise ValueError(f"a has shape {tuple(a.shape)}, want {(cfg.m, cfg.block_size)}")
        self._a = a.to(self.device, torch.float32).contiguous()
        if cfg.use_kernels:
            from repro_torch.kernels import ops as kops

            # the encoder's operands, made once: A^T (word-padded for the
            # scalar families) and the family's tables (thresholds and
            # dither, or centroids and their half squared norms)
            self._a_t = kops.encoder_a_t(self._a, self.codebook)
            self._tables = kops.encoder_tables(self.codebook, cfg.m, self.device)

    @property
    def a(self) -> torch.Tensor:
        return self._a

    @property
    def quantizer(self) -> Codebook:
        """Back-compat alias of :attr:`codebook`, as in the reference."""
        return self.codebook

    @property
    def n_codes(self) -> int:
        return self.codebook.n_codes(self.cfg.m)

    # -- encode ------------------------------------------------------------
    def compress_blocks_packed(
        self, blocks: torch.Tensor, residual: torch.Tensor, s: Optional[int] = None
    ):
        """(blocks + residual) -> (words, alpha, new_residual), eqs. 7-10 plus
        the wire packing: one launch of the fused encoder on the kernel
        route; the XLA-algorithm stages, packed last, otherwise."""
        if self.cfg.use_kernels:
            from repro_torch.kernels import ops as kops

            return kops.bqcs_encode_fused(
                blocks, residual, self._a, self.codebook, self.cfg.s if s is None else s,
                a_t=self._a_t, tables=self._tables,
            )
        codes, alpha, new_residual = self._compress_blocks_xla(blocks, residual, s)
        return self.pack(codes), alpha, new_residual

    def compress_blocks(
        self, blocks: torch.Tensor, residual: torch.Tensor, s: Optional[int] = None
    ):
        """(blocks + residual) -> (codes, alpha, new_residual): the unpacked
        uint8-index view.  The kernel route still runs the fused encoder and
        unpacks the words it emits."""
        if self.cfg.use_kernels:
            words, alpha, new_residual = self.compress_blocks_packed(blocks, residual, s)
            return self.unpack(words), alpha, new_residual
        return self._compress_blocks_xla(blocks, residual, s)

    def _compress_blocks_xla(
        self, blocks: torch.Tensor, residual: torch.Tensor, s: Optional[int] = None
    ):
        """The reference's XLA-algorithm encode: sparsify (``cfg.sparsifier``),
        project with one GEMM, codebook encode."""
        cfg = self.cfg
        s = cfg.s if s is None else s
        carry = blocks + residual
        if cfg.sparsifier == "bisect":
            sparse, new_residual = sparsify.block_sparsify_threshold(carry, s)
        else:
            sparse, new_residual = sparsify.block_sparsify(carry, s)
        x, alpha = sensing.project_blocks(sparse, self._a.T)
        return self.codebook.encode(x), alpha, new_residual

    def layout_for(self, grads_like: Dict[str, torch.Tensor], per_tensor: bool = False,
                   **kwargs) -> GradientLayout:
        """This codec's block layout for a gradient dict: monolithic (the
        default wire geometry) or per-tensor (independently padded leaf
        segments, the streaming geometry; ``kwargs`` go to
        :meth:`GradientLayout.per_tensor`)."""
        n = self.cfg.block_size
        if per_tensor:
            return GradientLayout.per_tensor(grads_like, n, **kwargs)
        return GradientLayout.monolithic(grads_like, n, **kwargs)

    def compress_tree(
        self, grads: Dict[str, torch.Tensor], residual_blocks: torch.Tensor,
        layout: Optional[GradientLayout] = None,
    ):
        """Whole-tree encode: blocks per ``layout`` (default monolithic), one
        encoder pass over the full grid.  Per-segment ``s`` budgets take the
        segment loop instead (:meth:`compress_tree_streamed`: the same wire
        bits where the budgets agree).  Returns ``(CompressedGradient,
        layout, new_residual)``."""
        cfg = self.cfg
        if layout is None:
            layout = GradientLayout.monolithic(grads, cfg.block_size)
        if any(s != cfg.s for s in layout.segment_s(cfg.s)):
            return self.compress_tree_streamed(grads, residual_blocks, layout)
        words, alpha, new_res = self.compress_blocks_packed(layout.to_blocks(grads),
                                                            residual_blocks)
        payload = CompressedGradient(words, alpha, layout.nbar, cfg.m, self.codebook.bits)
        return payload, layout, new_res

    def compress_tree_streamed(
        self, grads: Dict[str, torch.Tensor], residual_blocks: torch.Tensor,
        layout: GradientLayout,
    ):
        """Segment-streamed encode: the encoder runs one layout segment at a
        time (segment i's blocks built from its own leaves, encoded with its
        own top-S budget, its residual rows carried, then dropped), so the
        live encoder memory is the LARGEST segment's
        (``layout.encoder_live_bytes``).  On the kernel route each segment
        is one launch of the fused encoder.  Every encoder stage is per
        block row, so the concatenated wire is BIT-IDENTICAL to the one-pass
        :meth:`compress_tree` over the same layout.  ``residual_blocks`` is
        the full ``(rows, N)`` grid, and the new residual comes back so."""
        cfg = self.cfg
        words, alphas, residuals = [], [], []
        for seg, seg_blocks in layout.iter_segment_blocks(grads):
            w, al, res = self.compress_blocks_packed(
                seg_blocks, residual_blocks[seg.row_slice],
                s=seg.s if seg.s is not None else cfg.s,
            )
            words.append(w)
            alphas.append(al)
            residuals.append(res)
        payload = CompressedGradient(torch.cat(words), torch.cat(alphas), layout.nbar, cfg.m,
                                     self.codebook.bits)
        return payload, layout, torch.cat(residuals)

    def zero_residual(
        self, grads_like: Dict[str, torch.Tensor], layout: Optional[GradientLayout] = None
    ) -> torch.Tensor:
        if layout is None:
            layout = GradientLayout.monolithic(grads_like, self.cfg.block_size)
        return torch.zeros((layout.rows, layout.n), dtype=torch.float32, device=self.device)

    # -- wire --------------------------------------------------------------
    def pack(self, codes: torch.Tensor) -> torch.Tensor:
        return pack_codes(codes, self.codebook.bits)

    def unpack(self, words: torch.Tensor) -> torch.Tensor:
        """(..., W) words -> (..., n_codes) index view (n_codes = M / dim)."""
        return unpack_codes(words, self.codebook.bits, self.n_codes)

    # -- decode helpers ------------------------------------------------------
    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        return self.codebook.decode(codes, self.cfg.m)

    def dequantize_packed(self, words: torch.Tensor) -> torch.Tensor:
        """Reconstruction values straight from packed wire words (..., W)."""
        return self.codebook.decode_packed(words, self.cfg.m)

    # -- decode health -------------------------------------------------------
    def clip_saturation(self, codes_or_words: torch.Tensor, packed: bool = True) -> torch.Tensor:
        """Fraction of code lanes pinned at an extreme codebook level -- the
        quantizer clip-saturation rate (``repro_torch.obs`` decode health).

        Scalar families order their levels, so index 0 / L-1 means the input
        overshot the quantizer's support.  Vector codebooks have no level
        order, so vq reports a constant 0.  A 0-d tensor on the payload's
        device (no host sync); padding lanes of packed words are excluded by
        the unpack slice."""
        q = self.codebook
        if q.dim != 1:
            return torch.zeros((), device=codes_or_words.device)
        idx = self.unpack(codes_or_words) if packed else codes_or_words
        extreme = (idx == 0) | (idx == q.n_levels - 1)
        # the count times the f32 reciprocal of the lane count, rounded as
        # the reference's mean rounds it
        return torch.sum(extreme, dtype=torch.float32) * (1.0 / extreme.numel())
