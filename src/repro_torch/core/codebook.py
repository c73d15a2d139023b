"""Quantizer codebooks (port of ``repro.core.codebook``, ``lloyd_max`` only).

The paper's Lloyd-Max scalar quantizer behind the codebook surface the rest
of the port consumes: ``bits``/``n_levels``/``gamma``/``psi``/``kappa``, the
numpy tables, and ``encode``/``decode``/``decode_packed`` on tensors.  The
tables are designed in numpy (``core/quantizer.py``) and move to a device
only when a tensor op needs them.  The ``dithered_uniform`` and ``vq``
families are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import not_in_slice
from repro_torch.core.quantizer import design_lloyd_max

__all__ = ["ScalarCodebook", "make_codebook"]


@dataclasses.dataclass(frozen=True)
class ScalarCodebook:
    """Scalar codebook: L levels and L-1 interior decision thresholds.

    Encode: ``searchsorted(thresholds, y, side="left")``; decode:
    ``levels[code]``.
    """

    family: str
    bits: int
    dim: int
    n_levels: int
    gamma: float
    psi: float
    levels: np.ndarray
    thresholds: np.ndarray
    dither: Optional[np.ndarray] = None
    # device copies of the tables, made once per (device, dtype): a fresh
    # host-to-device copy per call would synchronise the stream
    _tables: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

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
        return m // self.dim

    def levels_t(self, device, dtype=torch.float32) -> torch.Tensor:
        return self._table("levels", device, dtype)

    def thresholds_t(self, device, dtype=torch.float32) -> torch.Tensor:
        return self._table("thresholds", device, dtype)

    def encode(self, y: torch.Tensor) -> torch.Tensor:
        taus = self.thresholds_t(y.device)
        return torch.searchsorted(taus, y.contiguous(), right=False).to(torch.uint8)

    def decode(self, codes: torch.Tensor, m: Optional[int] = None) -> torch.Tensor:
        deq = self.levels_t(codes.device)[codes.long()]
        return deq if m is None else deq[..., :m]

    def decode_packed(self, words: torch.Tensor, m: int) -> torch.Tensor:
        """Dequantize straight from packed wire words (see
        ``compression.decode_packed``)."""
        from repro_torch.core.compression import decode_packed  # layering

        return decode_packed(words, self.bits, m, self.levels_t(words.device))


def make_codebook(cfg) -> ScalarCodebook:
    """Builds the protocol codebook named by ``cfg.codebook``."""
    if cfg.codebook != "lloyd_max":
        raise not_in_slice(f"codebook {cfg.codebook!r}", "item 4")
    q = design_lloyd_max(cfg.bits)
    return ScalarCodebook(
        family="lloyd_max",
        bits=q.bits,
        dim=1,
        n_levels=q.n_levels,
        gamma=q.gamma,
        psi=q.psi,
        levels=q.levels,
        thresholds=q.thresholds,
    )
