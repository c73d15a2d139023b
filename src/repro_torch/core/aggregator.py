"""Hierarchical partial aggregation of Bussgang/EA sufficient statistics,
port of ``repro.core.aggregator``.

The barrier PS consumes all K payloads at once.  This module is the algebra
that lets the PS fold payloads *incrementally*: both reconstruction
strategies reduce, on the aggregation side, to sums that are associative in
the cohort --

  * **AE**: the Bussgang observation ``y = sum_k w_k deq_k`` (eq. 23), the
    effective-noise accumulator ``nu`` (eq. 24 + the channel term) and the
    GAMP-init energy are plain sums over clients.
  * **EA**: per-client GAMP estimates are summed weighted (Procedure 2 step
    14), so decode runs per arrival batch and only the running sum stays
    live.

Weights fold in RAW (pre-normalization): the streamed round does not know
the final participant set until the deadline, so statistics accumulate with
the unnormalized weights and :func:`normalized_stats` rescales at
finalization (``y`` is linear in rho -> 1/W; ``nu``/``energy`` are quadratic
-> 1/W^2).  Algebraically this is the barrier path's ``rho_k = w_k / W``;
only the f32 summation order differs.

:class:`AggregatorTree` is the carry-save reduction tree the streaming PS
folds into: each tier holds ONE running partial sum and carries to its
parent every ``fanout`` folds, so the live PS decode state is O(tree depth)
partial stats.  The statistics are tensors on the payloads' device; every
fold is a few elementwise device ops and no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.core import bussgang

__all__ = [
    "PartialStats",
    "zero_stats",
    "stats_add",
    "ae_batch_stats",
    "mimo_batch_stats",
    "ea_batch_stats",
    "normalized_stats",
    "AggregatorTree",
]


@dataclasses.dataclass(frozen=True)
class PartialStats:
    """Additive sufficient statistics of a (sub-)cohort, raw-weighted.

    mode "ae": ``y`` is the (nb, M) Bussgang-weighted dequantized sum,
    ``nu`` the (nb,) effective-noise accumulator (quantization + channel),
    ``energy`` the (nb,) GAMP-init signal energy.
    mode "ea": ``y`` is the (nb, N) weighted sum of per-client GAMP
    estimates; ``nu``/``energy`` stay zero (decode already happened).

    ``wsum`` is the raw-weight total folded so far (the normalizer W) and
    ``count`` the number of contributing (weight > 0) clients, both 0-d.
    """

    mode: str
    y: torch.Tensor
    nu: torch.Tensor
    energy: torch.Tensor
    wsum: torch.Tensor
    count: torch.Tensor

    @property
    def nbytes(self) -> int:
        """Live bytes of one partial stat (the unit of PS decode state)."""
        return sum(
            x.numel() * x.element_size()
            for x in (self.y, self.nu, self.energy, self.wsum, self.count)
        )


def zero_stats(mode: str, nb: int, width: int, device="cpu") -> PartialStats:
    """The additive identity: ``width`` is M for "ae", N for "ea"."""
    if mode not in ("ae", "ea"):
        raise ValueError(f"unknown stats mode {mode!r} (choose 'ae' or 'ea')")

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return PartialStats(mode, z(nb, width), z(nb), z(nb), z(), z())


def stats_add(a: PartialStats, b: PartialStats) -> PartialStats:
    """Fold two partial stats (associative up to f32 reassociation)."""
    if a.mode != b.mode:
        raise ValueError(f"cannot fold {a.mode!r} stats into {b.mode!r} stats")
    return PartialStats(
        a.mode, a.y + b.y, a.nu + b.nu, a.energy + b.energy,
        a.wsum + b.wsum, a.count + b.count,
    )


def _totals(weights: torch.Tensor):
    return torch.sum(weights), torch.sum((weights > 0).to(torch.float32))


def ae_batch_stats(
    codec,
    words: torch.Tensor,  # (B, nb, W) packed wire words of one sub-cohort batch
    alphas: torch.Tensor,  # (B, nb)
    weights: torch.Tensor,  # (B,) RAW (unnormalized) aggregation weights
    nu_chan: Optional[torch.Tensor] = None,  # (B, nb) channel variance
    noise: Optional[torch.Tensor] = None,  # (B, nb, M) sampled channel noise
) -> PartialStats:
    """AE sufficient statistics of one sub-cohort payload batch: dequantize
    straight from the wire words, Bussgang-weight with the RAW weights, and
    return the batch's additive (y, nu, energy).  A zero weight (padding
    slot / dropped client) contributes exactly nothing."""
    cb = codec.codebook
    m = codec.cfg.m
    deq = cb.decode_packed(words, m)  # (B, nb, M)
    if noise is not None:
        deq = deq + noise
    w = bussgang.bussgang_weight(weights[:, None], alphas, cb)  # (B, nb)
    y = torch.sum(w[..., None] * deq, dim=0)
    nu = bussgang.effective_noise_var(alphas, weights, cb)
    if nu_chan is not None:
        nu = nu + torch.sum(torch.square(w) * nu_chan, dim=0)
    energy = bussgang.signal_energy(alphas, weights, m, codec.cfg.block_size)
    return PartialStats("ae", y, nu, energy, *_totals(weights))


def mimo_batch_stats(
    codec,
    y_eff: torch.Tensor,  # (nb, M) spatially-combined sub-cohort observation
    nu_mimo: torch.Tensor,  # (nb,) post-combining channel noise variance
    alphas: torch.Tensor,  # (B, nb)
    weights: torch.Tensor,  # (B,) RAW (unnormalized) aggregation weights
) -> PartialStats:
    """AE sufficient statistics of one superimposed sub-cohort reception
    (multiple-access uplink): the channel already summed the batch's
    Bussgang-weighted rows, so ``y_eff`` IS the batch's ``y`` and only the
    quantization-noise and energy accumulators are computed here."""
    cb = codec.codebook
    nu = bussgang.effective_noise_var(alphas, weights, cb) + nu_mimo
    energy = bussgang.signal_energy(alphas, weights, codec.cfg.m, codec.cfg.block_size)
    return PartialStats("ae", y_eff, nu, energy, *_totals(weights))


def ea_batch_stats(ghat: torch.Tensor, weights: torch.Tensor) -> PartialStats:
    """EA sufficient statistics: ``ghat`` is the (B, nb, N) per-client GAMP
    estimates of one arrival batch, folded as the raw-weighted sum."""
    y = torch.einsum("k,kbn->bn", weights, ghat)
    z = torch.zeros((ghat.shape[1],), dtype=torch.float32, device=ghat.device)
    return PartialStats("ea", y, z, z, *_totals(weights))


def normalized_stats(stats: PartialStats):
    """Rescales raw-weighted sums to the barrier path's rho_k = w_k / W
    weighting: (y / W, nu / W^2, energy / W^2).  An empty round (W == 0)
    normalizes to exact zeros."""
    safe = torch.clamp(stats.wsum, min=1e-30)
    inv = torch.where(stats.wsum > 0, 1.0 / safe, torch.zeros_like(safe))
    return stats.y * inv, stats.nu * inv**2, stats.energy * inv**2


class AggregatorTree:
    """Carry-save ``fanout``-ary reduction tree over partial stats.

    Tier 0 absorbs arrival batches; every ``fanout`` folds a tier carries its
    running sum to the parent tier and resets.  Live decode state is one
    partial stat per tier -- O(log_fanout batches) -- and the fold order is a
    deterministic function of the PUSH order alone, so a fixed arrival
    sequence reproduces bit-identical sums.  ``root()`` folds the pending
    tiers bottom-up (tier 0 first).  Tracks ``peak_live_bytes``.
    """

    def __init__(self, zero: PartialStats, fanout: int = 8):
        if fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {fanout}")
        self.zero = zero
        self.fanout = fanout
        self.tiers: List[List] = []  # per tier: [running stats, folds since carry]
        self.pushed = 0
        self.peak_live_bytes = 0

    @property
    def live_bytes(self) -> int:
        return len(self.tiers) * self.zero.nbytes

    def push(self, stats: PartialStats) -> None:
        self._fold(0, stats)
        self.pushed += 1
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _fold(self, tier: int, stats: PartialStats) -> None:
        if tier == len(self.tiers):
            self.tiers.append([self.zero, 0])
        acc = self.tiers[tier]
        acc[0] = stats_add(acc[0], stats)
        acc[1] += 1
        if acc[1] == self.fanout:
            carried = acc[0]
            self.tiers[tier] = [self.zero, 0]
            self._fold(tier + 1, carried)

    def root(self) -> PartialStats:
        """Folds every pending tier into the round total (non-destructive)."""
        total = self.zero
        for acc, _ in self.tiers:
            total = stats_add(total, acc)
        return total
