"""Quantizer codebooks (port of ``repro.core.codebook``).

The BQCS scaling ``alpha = sqrt(M)/||g||`` makes every projected entry
~ N(0, 1), so any codebook designed once for the standard normal serves
every (worker, block, round).  Three families, as in the reference:

  * ``lloyd_max``        -- the paper's scalar quantizer (``core/quantizer.py``).
  * ``dithered_uniform`` -- a uniform mid-rise quantizer over [-4, 4] with a
                            shared-seed subtractive dither per measurement
                            lane (encode ``y + u``, decode ``level - u``).
  * ``vq``               -- a d-dimensional k-means codebook on N(0, I_d);
                            one code indexes d measurements in the j-major
                            lane layout (lane ``j*G + g`` is dimension j of
                            group g, G = M / d).

The designs run in numpy at config time, copied from the reference step
for step, so their tables (levels, thresholds, dither, centroids, gamma,
psi) are bit-identical to the reference's.  The tables move to a device
only when a tensor op needs them, once per (device, dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.quantizer import LloydMaxQuantizer, _phi, design_lloyd_max

__all__ = [
    "Codebook",
    "ScalarCodebook",
    "as_codebook",
    "VectorCodebook",
    "make_codebook",
    "register_codebook_family",
    "vq_nearest",
    "design_dithered_uniform",
    "design_vq",
    "index_bits",
]

def index_bits(n_levels: int) -> int:
    """Wire width of one code index: ceil(log2 n_levels), >= 1."""
    return max(1, (n_levels - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class Codebook:
    """Common surface: ``bits`` is the index width on the wire, ``dim`` the
    measurements per code, ``n_levels`` the codebook size, ``gamma``/``psi``
    the Bussgang gain and output second moment per dimension (eqs. 21-22)."""

    family: str
    bits: int
    dim: int
    n_levels: int
    gamma: float
    psi: float

    # Each family ends with a ``_tables`` field: device copies of its tables,
    # made once per (device, dtype), since a fresh host-to-device copy per
    # call would synchronise the stream.  (Declared last in each subclass so
    # the table fields keep their positional order.)
    def _table(self, name: str, device, dtype) -> torch.Tensor:
        key = (name, torch.device(device), dtype)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(getattr(self, name), dtype=dtype, device=device)
        return self._tables[key]

    @property
    def kappa(self) -> float:
        """(psi - gamma^2)/gamma^2: normalized distortion power (Thm 1)."""
        return (self.psi - self.gamma**2) / (self.gamma**2)

    def n_codes(self, m: int) -> int:
        """Code lanes for m measurements (m must divide by dim)."""
        if m % self.dim:
            raise ValueError(f"codebook dim {self.dim} must divide the measurement count {m}")
        return m // self.dim

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Q(x): quantize-dequantize (QIHT's requantization)."""
        return self.decode(self.encode(x), x.shape[-1])


@dataclasses.dataclass(frozen=True)
class ScalarCodebook(Codebook):
    """Scalar codebook: L levels, L-1 interior decision thresholds and an
    optional per-lane subtractive dither (a protocol constant).

    Encode: ``searchsorted(thresholds, y + dither, side="left")``;
    decode: ``levels[code] - dither``.
    """

    levels: np.ndarray = None  # (L,) ascending reconstruction points
    thresholds: np.ndarray = None  # (L - 1,) interior decision thresholds
    dither: Optional[np.ndarray] = None  # (M,) per-lane dither or None
    _tables: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def levels_t(self, device, dtype=torch.float32) -> torch.Tensor:
        return self._table("levels", device, dtype)

    def thresholds_t(self, device, dtype=torch.float32) -> torch.Tensor:
        return self._table("thresholds", device, dtype)

    def dither_t(self, device, dtype=torch.float32) -> Optional[torch.Tensor]:
        return None if self.dither is None else self._table("dither", device, dtype)

    def encode(self, y: torch.Tensor) -> torch.Tensor:
        taus = self.thresholds_t(y.device)
        if self.dither is not None:
            y = y + self.dither_t(y.device)
        return torch.searchsorted(taus, y.contiguous(), right=False).to(torch.uint8)

    def decode(self, codes: torch.Tensor, m: Optional[int] = None) -> torch.Tensor:
        deq = self.levels_t(codes.device)[codes.long()]
        if self.dither is not None:
            deq = deq - self.dither_t(codes.device)
        return deq if m is None else deq[..., :m]

    def decode_packed(self, words: torch.Tensor, m: int) -> torch.Tensor:
        """Dequantize straight from packed wire words (see
        ``compression.decode_packed``)."""
        from repro_torch.core.compression import decode_packed  # layering

        deq = decode_packed(words, self.bits, m, self.levels_t(words.device))
        if self.dither is not None:
            deq = deq - self.dither_t(words.device)[:m]
        return deq


def vq_nearest(
    y: torch.Tensor, centroids: torch.Tensor, half_norms: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Nearest-centroid indices for (..., M) measurements in the j-major lane
    layout (lane ``j*G + g`` is dimension j of group g).

    Score ``<y_g, c_l> - ||c_l||^2 / 2``, accumulated as the reference does
    (j = 0 carries the half-norm term, then j = 1..d-1); ties go to the
    lowest index.  ``half_norms`` is ``0.5 * sum(c * c)`` per centroid,
    computed here when not given.  Returns (..., G) int64."""
    n_lev, d = centroids.shape
    g = y.shape[-1] // d
    y3 = y.reshape(y.shape[:-1] + (d, g))
    if half_norms is None:
        half_norms = 0.5 * torch.sum(centroids * centroids, dim=1)
    sc = y3[..., 0, :, None] * centroids[:, 0] - half_norms  # (..., G, L)
    for j in range(1, d):
        sc = sc + y3[..., j, :, None] * centroids[:, j]
    mx = torch.amax(sc, dim=-1, keepdim=True)
    lvl = torch.arange(n_lev, device=y.device)
    return torch.amin(torch.where(sc == mx, lvl, n_lev), dim=-1)


@dataclasses.dataclass(frozen=True)
class VectorCodebook(Codebook):
    """FedVQCS-style d-dimensional codebook over N(0, I_d): one code per d
    measurements (j-major lane layout, see :func:`vq_nearest`)."""

    centroids: np.ndarray = None  # (L, d)
    _tables: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def centroids_t(self, device, dtype=torch.float32) -> torch.Tensor:
        return self._table("centroids", device, dtype)

    def half_norms_t(self, device) -> torch.Tensor:
        """0.5 * ||c_l||^2 (L,) in f32, computed once per device as
        :func:`vq_nearest` computes it; the fused encoder takes it as an
        operand so kernel and plain version score with the same values."""
        key = ("half_norms", torch.device(device), torch.float32)
        if key not in self._tables:
            c = self.centroids_t(device)
            self._tables[key] = 0.5 * torch.sum(c * c, dim=1)
        return self._tables[key]

    def encode(self, y: torch.Tensor) -> torch.Tensor:
        # design_vq caps the codebook at 256 centroids
        return vq_nearest(y, self.centroids_t(y.device), self.half_norms_t(y.device)).to(
            torch.uint8
        )

    def decode(self, codes: torch.Tensor, m: Optional[int] = None) -> torch.Tensor:
        deq = self.centroids_t(codes.device)[codes.long()]  # (..., G, d)
        deq = deq.transpose(-1, -2)  # (..., d, G): j-major lane layout
        deq = deq.reshape(codes.shape[:-1] + (codes.shape[-1] * self.dim,))
        return deq if m is None else deq[..., :m]

    def decode_packed(self, words: torch.Tensor, m: int) -> torch.Tensor:
        from repro_torch.core.compression import unpack_codes  # layering

        return self.decode(unpack_codes(words, self.bits, self.n_codes(m)), m)


# ---------------------------------------------------------------------------
# Designs (numpy, config time): copies of the reference's, so the tables
# are bit-identical.
# ---------------------------------------------------------------------------


def design_dithered_uniform(bits: int, m: int, seed: int, clip: float = 4.0) -> ScalarCodebook:
    """Uniform mid-rise quantizer over [-clip, clip] with a shared-seed
    subtractive dither u ~ Unif(-delta/2, delta/2) per measurement lane.
    gamma = E[(q(x+u) - u) x] and psi = E[(q(x+u) - u)^2] by quadrature
    over x ~ N(0, 1) and a midpoint grid in u."""
    if not (1 <= bits <= 8):
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    n = 1 << bits
    delta = 2.0 * clip / n
    levels = -clip + delta * (np.arange(n, dtype=np.float64) + 0.5)
    thresholds = -clip + delta * np.arange(1, n, dtype=np.float64)
    xs = np.linspace(-9.0, 9.0, 6001)
    wx = _phi(xs)
    wx /= np.sum(wx)
    us = (np.arange(33, dtype=np.float64) + 0.5) / 33.0 * delta - 0.5 * delta
    v = xs[:, None] + us[None, :]
    idx = np.clip(np.floor((v + clip) / delta), 0, n - 1).astype(np.int64)
    qxu = levels[idx] - us[None, :]
    q_mean = np.mean(qxu, axis=1)
    gamma = float(np.sum(wx * xs * q_mean))
    psi = float(np.sum(wx * np.mean(np.square(qxu), axis=1)))
    rng = np.random.default_rng((int(seed), 0xD17E))
    dither = rng.uniform(-0.5 * delta, 0.5 * delta, size=m)
    return ScalarCodebook(
        family="dithered_uniform", bits=bits, dim=1, n_levels=n, gamma=gamma, psi=psi,
        levels=levels, thresholds=thresholds, dither=dither.astype(np.float64),
    )


def design_vq(
    n_levels: int, dim: int, seed: int, n_samples: int = 1 << 16, iters: int = 60
) -> VectorCodebook:
    """k-means (Lloyd's algorithm) codebook for N(0, I_dim), deterministic in
    the seed; empty cells reseed to the sample farthest from its centroid.
    Bussgang constants come from a fresh held-out sample."""
    if dim < 2:
        raise ValueError(f"vq dim must be >= 2 (use a scalar family for d=1), got {dim}")
    if not (2 <= n_levels <= 256):
        raise ValueError(f"vq levels must be in [2, 256], got {n_levels}")
    rng = np.random.default_rng((int(seed), 0x7ECB))
    x = rng.standard_normal((n_samples, dim))
    c = x[rng.choice(n_samples, n_levels, replace=False)].copy()
    for _ in range(iters):
        d2 = np.sum(np.square(x[:, None, :] - c[None, :, :]), axis=-1)  # (S, L)
        assign = np.argmin(d2, axis=1)
        counts = np.bincount(assign, minlength=n_levels)
        for j in range(dim):
            sums = np.bincount(assign, weights=x[:, j], minlength=n_levels)
            c[:, j] = np.where(counts > 0, sums / np.maximum(counts, 1), c[:, j])
        if (counts == 0).any():
            worst = np.argsort(-d2[np.arange(n_samples), assign])
            for i, l in enumerate(np.flatnonzero(counts == 0)):
                c[l] = x[worst[i]]
    xh = rng.standard_normal((n_samples, dim))
    d2 = np.sum(np.square(xh[:, None, :] - c[None, :, :]), axis=-1)
    q = c[np.argmin(d2, axis=1)]
    gamma = float(np.mean(np.sum(q * xh, axis=1)) / dim)
    psi = float(np.mean(np.sum(np.square(q), axis=1)) / dim)
    return VectorCodebook(
        family="vq", bits=index_bits(n_levels), dim=dim, n_levels=n_levels,
        gamma=gamma, psi=psi, centroids=c,
    )


# ---------------------------------------------------------------------------
# Registry + config entry point.
# ---------------------------------------------------------------------------


def _as_lloyd_max_codebook(q: LloydMaxQuantizer) -> ScalarCodebook:
    return ScalarCodebook(
        family="lloyd_max", bits=q.bits, dim=1, n_levels=q.n_levels, gamma=q.gamma,
        psi=q.psi, levels=q.levels, thresholds=q.thresholds,
    )


def _build_lloyd_max(cfg) -> ScalarCodebook:
    return _as_lloyd_max_codebook(design_lloyd_max(cfg.bits))


def _build_dithered_uniform(cfg) -> ScalarCodebook:
    return design_dithered_uniform(cfg.bits, cfg.m, cfg.seed)


def _build_vq(cfg) -> VectorCodebook:
    if cfg.m % cfg.vq_dim:
        raise ValueError(
            f"vq_dim={cfg.vq_dim} must divide M={cfg.m} (block_size // reduction_ratio)"
        )
    return design_vq(cfg.vq_levels or (1 << cfg.bits), cfg.vq_dim, cfg.seed)


# cfg.codebook -> builder(cfg) -> Codebook
CODEBOOK_FAMILIES: Dict[str, Callable] = {}


def register_codebook_family(name: str, make: Callable) -> None:
    """Registers ``make(cfg) -> Codebook`` under ``cfg.codebook == name``:
    the plug-in point for a new codebook, which every layer downstream then
    picks up."""
    CODEBOOK_FAMILIES[name] = make


register_codebook_family("lloyd_max", _build_lloyd_max)
register_codebook_family("dithered_uniform", _build_dithered_uniform)
register_codebook_family("vq", _build_vq)


def make_codebook(cfg) -> Codebook:
    """Builds the protocol codebook named by ``cfg.codebook``; deterministic
    in the config, so every client and the PS derive the same tables."""
    try:
        make = CODEBOOK_FAMILIES[cfg.codebook]
    except KeyError:
        raise ValueError(
            f"unknown codebook {cfg.codebook!r} (known: {sorted(CODEBOOK_FAMILIES)})"
        ) from None
    return make(cfg)


def as_codebook(obj) -> Codebook:
    """Adapts a legacy :class:`LloydMaxQuantizer` to the Codebook surface;
    Codebooks pass through."""
    if isinstance(obj, Codebook):
        return obj
    if isinstance(obj, LloydMaxQuantizer):
        return _as_lloyd_max_codebook(obj)
    raise TypeError(f"not a codebook or quantizer: {type(obj)!r}")
