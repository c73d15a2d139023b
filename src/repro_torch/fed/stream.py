"""Streaming rolling-cohort PS aggregation, port of ``repro.fed.stream``.

Every barrier round shape is one cohort, one gather, one decode over all K
payloads.  This module is the producer/consumer split of that round:
clients "arrive" over simulated time (a deterministic latency/straggler
model on top of the scheduler's cohort), their payloads land in a
:class:`BoundedIngestBuffer` in sub-cohort batches, and the
:class:`StreamingPS` consumer drains the buffer into a carry-save
:class:`~repro_torch.core.aggregator.AggregatorTree` of partial
Bussgang/EA sufficient statistics.  Consequences:

  * PS decode state is O(tree depth) partial stats + one in-flight batch,
    never O(K) payloads.
  * EA batches run their per-client GAMP inversions through the recon
    engine (``ea_solve_flat``: on the kernel route, ``qgamp_step`` at
    ``batch_clients x nb`` rows) as they arrive; AE folds are
    dequantize-and-accumulate with the single EM-GAMP at finalize.
  * The deadline degrades gracefully: whatever arrived by the cutoff is
    decoded; non-arrivals keep their cohort slot with weight 0, so their
    error-feedback residual carries the FULL gradient and the scheduler
    un-stamps them, as for channel outage.
  * Late-but-before-deadline arrivals are down-weighted with the scheduler's
    ``staleness_discount`` of the soft-deadline overrun.

Weight normalization happens at finalize (``aggregator.normalized_stats``),
so the streamed result matches the barrier decode up to the f32 summation
order of the client sums.

Determinism: arrivals are a pure numpy function of ``(StreamConfig.seed,
round)``, bit-identical to the reference's; batch admission dedups on the
positions' bytes (a redelivered batch is rejected, not double-counted); and
the tree's fold order depends only on the admission order.

Host syncs: folds launch device work only.  ``StreamingPS.finalize`` reads
the root's count and weight sum once (an empty round short-circuits to the
exact zero update), and ``health`` reads the accumulated GAMP health once
when the engine records.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregator, bussgang
from repro_torch.core.gamp import GampConfig, gamp_health
from repro_torch.core.recon_engine import _take_rows, decode_from_stats, ea_solve_flat
from repro_torch.fed.channel import (
    ChannelConfig,
    ChannelRealization,
    get_channel_family,
    mimo_tx_gain,
)
from repro_torch.fed.scheduler import staleness_discount

__all__ = [
    "StreamConfig",
    "simulate_arrivals",
    "late_discount",
    "batch_arrivals",
    "BoundedIngestBuffer",
    "StreamingPS",
    "stream_decode",
]


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the streaming round.  Times are in units of the median
    client latency (the log-normal's scale), so ``deadline=8`` means "wait
    8x the typical client" regardless of absolute wall-clock."""

    batch_clients: int = 64  # sub-cohort payload batch size (ingest unit)
    buffer_batches: int = 8  # BoundedIngestBuffer capacity (backpressure past this)
    fanout: int = 8  # aggregator-tree carry fanout
    deadline: float = 8.0  # round cutoff: later arrivals are non-participants
    soft_deadline: float = 4.0  # overrun past this is "staleness" for late_decay
    late_decay: float = 0.0  # staleness_discount exponent for late arrivals
    latency_sigma: float = 0.35  # log-normal latency spread
    straggler_prob: float = 0.0  # P(client latency is multiplied by straggler_mult)
    straggler_mult: float = 8.0
    seed: int = 0


def simulate_arrivals(
    cfg: StreamConfig, round_idx: int, n: int, alive: np.ndarray
) -> np.ndarray:
    """Deterministic per-client arrival times (n,) for one round: log-normal
    latency (median 1) with a straggler tail; clients not ``alive`` never
    arrive (inf).  The 0xA881 tag keeps this stream disjoint from the
    scheduler's and the data sampler's."""
    rng = np.random.default_rng((cfg.seed, 0xA881, round_idx))
    lat = rng.lognormal(mean=0.0, sigma=cfg.latency_sigma, size=n)
    if cfg.straggler_prob > 0:
        lat = np.where(rng.random(n) < cfg.straggler_prob, lat * cfg.straggler_mult, lat)
    return np.where(np.asarray(alive, bool), lat, np.inf)


def late_discount(cfg: StreamConfig, times: np.ndarray) -> np.ndarray:
    """Aggregation-weight discount for late-but-in-deadline arrivals:
    ``staleness_discount`` over the soft-deadline overrun.  Identity when
    ``late_decay == 0`` or the client beat the soft deadline."""
    if cfg.late_decay <= 0:
        return np.ones_like(np.asarray(times, np.float64))
    overrun = np.where(np.isfinite(times), np.maximum(times - cfg.soft_deadline, 0.0), 0.0)
    return staleness_discount(overrun, cfg.late_decay)


def batch_arrivals(
    times: np.ndarray, deadline: float, batch_clients: int
) -> List[np.ndarray]:
    """Groups the in-deadline arrivals into arrival-ordered batches of
    ``batch_clients`` cohort positions (the last may be short).  Ties break
    by cohort position (stable sort)."""
    arrived = np.flatnonzero(times <= deadline)
    order = arrived[np.argsort(times[arrived], kind="stable")]
    return [order[i : i + batch_clients] for i in range(0, len(order), batch_clients)]


class BoundedIngestBuffer:
    """Bounded FIFO between arrival and the folding consumer.

    ``push`` admits a batch under a content key and REJECTS redelivery: a key
    seen before (this round) is counted in ``rejected_dup`` and never occupies
    a slot.  ``push`` raises when full -- the caller must drain first
    (backpressure).  Tracks ``peak_occupancy``.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"buffer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._q: deque = deque()
        self._seen: set = set()
        self.admitted = 0
        self.rejected_dup = 0
        self.peak_occupancy = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.capacity

    def push(self, key: bytes, item) -> bool:
        """Admit ``item`` under ``key``; False (rejected) for a duplicate."""
        if key in self._seen:
            self.rejected_dup += 1
            return False
        if self.full:
            raise RuntimeError(
                f"ingest buffer full ({self.capacity} batches): drain before pushing"
            )
        self._seen.add(key)
        self._q.append(item)
        self.admitted += 1
        self.peak_occupancy = max(self.peak_occupancy, len(self._q))
        return True

    def pop(self):
        return self._q.popleft()


class StreamingPS:
    """The consumer: folds gathered payload batches into the aggregator tree
    and finalizes the round decode from the folded root.

    One instance serves every round (the engine owns one); ``begin_round``
    resets the tree.  Batches are padded to ``batch_clients`` slots by the
    caller (zero-weight pad slots contribute exactly nothing), so every EA
    fold decodes the same number of rows.

    ``collect_health`` is decided at construction, like the engine's
    recorder activity: the EA folds then also accumulate GAMP health sums
    (iters / converged over live problems) on the device -- no host sync per
    batch -- and the AE finalize decodes ``with_info``; :meth:`health`
    summarizes after finalize.
    """

    def __init__(
        self,
        codec,
        mode: str = "ae",
        gamp: Optional[GampConfig] = None,
        stream: StreamConfig = StreamConfig(),
        use_kernels: bool = False,
        recon_chunk: int = 0,
        chan: Optional[ChannelConfig] = None,
        collect_health: bool = False,
    ):
        if mode not in ("ae", "ea"):
            raise ValueError(f"unknown streaming mode {mode!r} (choose 'ae' or 'ea')")
        from repro_torch.core.reconstruction import gamp_config_from  # layering

        fam = get_channel_family(chan.kind) if chan is not None else None
        if fam is not None and not fam.multiple_access:
            raise ValueError(
                "StreamingPS takes chan= only for multiple-access families "
                "(per-client noisy uplinks thread nu_chan/noise instead); "
                f"got {chan.kind!r}"
            )
        if fam is not None and mode != "ae":
            raise ValueError(
                "a multiple-access uplink superimposes the cohort before the "
                "PS can decode, so only joint-estimation 'ae' streaming is "
                f"defined; got mode {mode!r}"
            )
        self.codec = codec
        self.mode = mode
        self.gamp = gamp or gamp_config_from(codec)
        self.stream = stream
        self.use_kernels = use_kernels
        self.recon_chunk = recon_chunk
        self.chan = chan
        self._fam = fam
        self.collect_health = collect_health
        self.tree: Optional[aggregator.AggregatorTree] = None
        self._health_acc: Optional[Dict[str, torch.Tensor]] = None
        self._final_info = None
        self.totals: Tuple[float, float] = (0.0, 0.0)  # root (count, wsum) after finalize

    def begin_round(self, nb: int) -> None:
        width = self.codec.cfg.m if self.mode == "ae" else self.codec.cfg.block_size
        zero = aggregator.zero_stats(self.mode, nb, width, self.codec.device)
        self.tree = aggregator.AggregatorTree(zero, fanout=self.stream.fanout)
        self._health_acc = None
        self._final_info = None

    def _fold_ea(self, words, alphas, w):
        """This batch's per-client GAMP problems, decoded now."""
        b, nb = alphas.shape
        ghat = ea_solve_flat(
            self.codec, words.reshape((b * nb,) + tuple(words.shape[2:])),
            alphas.reshape(b * nb), self.gamp, packed=True, use_kernels=self.use_kernels,
            chunk=self.recon_chunk, with_info=self.collect_health,
        )
        if not self.collect_health:
            return aggregator.ea_batch_stats(ghat.reshape(b, nb, -1), w)
        ghat, ginfo = ghat
        live = (alphas.reshape(b * nb) > 0).to(torch.float32)
        iters = ginfo.iters.to(torch.float32) * live
        aux = {
            "iters_sum": torch.sum(iters),
            "conv_sum": torch.sum(ginfo.converged.to(torch.float32) * live),
            "iters_max": torch.max(iters),
            "live": torch.sum(live),
        }
        # lazy device-side accumulation: no host sync until health()
        if self._health_acc is None:
            self._health_acc = aux
        else:
            acc = self._health_acc
            for k in ("iters_sum", "conv_sum", "live"):
                acc[k] = acc[k] + aux[k]
            acc["iters_max"] = torch.maximum(acc["iters_max"], aux["iters_max"])
        return aggregator.ea_batch_stats(ghat.reshape(b, nb, -1), w)

    def _fold_ae_mimo(self, words, alphas, w, real: ChannelRealization, draw):
        """One superimposed sub-cohort reception over ``real`` (the round's
        H restricted to this batch's columns): the batch pre-scales by its
        Bussgang weights, transmits at once, and the PS combines the single
        (n_rx, nb, M) signal into the tier's partial stats.  ``draw`` is the
        batch's receive-noise draw."""
        cb = self.codec.codebook
        deq = cb.decode_packed(words, self.codec.cfg.m)  # (B, nb, M)
        wq = bussgang.bussgang_weight(w[:, None], alphas, cb)
        active = (w > 0).to(torch.float32)
        eta = mimo_tx_gain(wq, active)  # this batch's power control
        x = (eta * wq)[..., None] * deq
        y_rx = self._fam.transmit(self.chan, real, x, draw)
        y_eff, nu = self._fam.combine(self.chan, real, y_rx, wq, active, psi=cb.psi,
                                      tx_gain=eta)
        return aggregator.mimo_batch_stats(self.codec, y_eff, nu, alphas, w)

    def fold_batch(self, words, alphas, weights, nu_chan=None, noise=None, mimo=None) -> None:
        """Fold one gathered (padded) sub-cohort batch into the tree.
        ``noise`` is the batch's (B, nb, M) unit receive noise, drawn per
        client (scaled here by ``sqrt(nu_chan)``).  ``mimo`` is ``(real,
        draw)`` -- this batch's columns of the round's channel realization
        and its receive-noise draw ``draw(purpose, shape)`` -- for
        multiple-access streaming (requires construction with ``chan=``)."""
        if self.mode == "ea":
            stats = self._fold_ea(words, alphas, weights)
        elif mimo is not None:
            if self._fam is None:
                raise ValueError("multiple-access fold needs a StreamingPS built with chan=")
            stats = self._fold_ae_mimo(words, alphas, weights, *mimo)
        elif nu_chan is None:
            stats = aggregator.ae_batch_stats(self.codec, words, alphas, weights)
        else:
            scaled = noise * torch.sqrt(nu_chan)[..., None]
            stats = aggregator.ae_batch_stats(self.codec, words, alphas, weights, nu_chan,
                                              scaled)
        self.tree.push(stats)

    def finalize(self) -> Tuple[torch.Tensor, aggregator.PartialStats]:
        """Folds the pending tiers and decodes -> ((nb, N) blocks, root
        stats).  Reads the root's count and weight sum (one host sync, kept
        in ``totals``); an empty round short-circuits to the exact zero
        update, as the barrier blackout does."""
        root = self.tree.root()
        count, wsum = torch.stack([root.count, root.wsum]).tolist()
        self.totals = (count, wsum)
        if count == 0:
            nb = root.y.shape[0]
            zeros = torch.zeros((nb, self.codec.cfg.block_size), device=root.y.device)
            return zeros, root
        out = decode_from_stats(self.codec, root, self.gamp, use_kernels=self.use_kernels,
                                with_info=self.collect_health)
        if self.collect_health:
            out, self._final_info = out  # info is None on the EA path
        return out, root

    def health(self) -> Dict[str, float]:
        """Round decode-health scalars (one host sync; call after finalize).
        EA: GAMP iters/convergence summed over the round's fold batches.
        AE: the finalize decode's GAMP info (the round's single solve)."""
        if not self.collect_health:
            return {}
        if self._final_info is not None:  # ae finalize decode
            return {k: float(v) for k, v in gamp_health(self._final_info).items()}
        if self._health_acc is None:  # ea round with no folds
            return {}
        acc = self._health_acc
        iters_sum, conv_sum, iters_max, live = torch.stack(
            [acc["iters_sum"], acc["conv_sum"], acc["iters_max"], acc["live"]]).tolist()
        live = max(live, 1.0)
        return {
            "gamp_iters_mean": iters_sum / live,
            "gamp_iters_max": iters_max,
            "gamp_converged_frac": conv_sum / live,
        }


def stream_decode(
    codec,
    words: torch.Tensor,  # (C, nb, W) packed wire words of the whole cohort
    alphas: torch.Tensor,  # (C, nb)
    weights: np.ndarray,  # (C,) RAW weights (0 = non-participant)
    batches: List[np.ndarray],  # arrival-ordered position batches
    *,
    mode: str = "ae",
    stream: Optional[StreamConfig] = None,
    gamp: Optional[GampConfig] = None,
    nu_chan: Optional[torch.Tensor] = None,  # (C, nb) channel variance (noisy AE)
    noise: Optional[torch.Tensor] = None,  # (C, nb, M) per-client unit receive noise
    chan: Optional[ChannelConfig] = None,  # multiple-access uplink config
    chan_real: Optional[ChannelRealization] = None,  # its round realization
    chan_draw: Optional[Callable[[int, Tuple[int, ...]], torch.Tensor]] = None,
    use_kernels: bool = False,
    recon_chunk: int = 0,
    ps: Optional[StreamingPS] = None,
) -> Tuple[torch.Tensor, Dict[str, float]]:
    """One streamed round, driven end to end: producers push each arrival
    batch into the bounded buffer (draining one batch first when full --
    backpressure), the consumer folds drained batches into the tree, and the
    round finalizes from the folded root.

    Single-host deterministic simulation of the producer/consumer split; the
    testable unit for fault injection (``batches`` may be reordered,
    duplicated, or partially dropped by the caller).  A short batch is
    padded to ``batch_clients`` slots by replaying its first position with
    weight 0.  Over a multiple-access uplink, ``chan_draw(index, shape)``
    gives the receive noise of the ``index``-th admitted batch (fold order).
    Returns ((nb, N) aggregated blocks, info dict).
    """
    if chan_real is not None and (chan_real.h is None or chan_draw is None):
        raise ValueError(
            "multiple-access streaming needs a realization with a fading "
            "matrix and a per-batch receive-noise draw (chan_real=, chan_draw=)"
        )
    if ps is None:
        ps = StreamingPS(
            codec, mode, gamp, stream or StreamConfig(),
            use_kernels=use_kernels, recon_chunk=recon_chunk, chan=chan,
        )
    cfg = ps.stream
    dev = words.device
    w_np = np.asarray(weights, np.float32)
    nb = alphas.shape[1]
    ps.begin_round(nb)
    buf = BoundedIngestBuffer(cfg.buffer_batches)
    consumed = [0]  # admission counter: the multiple-access noise draw's index
    backpressure = [0]  # forced drains: pushes that found the buffer full

    def consume_one():
        pos, valid = buf.pop()
        idx = torch.as_tensor(pos, device=dev)
        w_b = torch.as_tensor(w_np[pos] * valid, device=dev)
        mimo = None
        if chan_real is not None:
            # this batch's columns of the round's H; one fresh receive-noise
            # draw per admitted batch (deterministic in fold order)
            i = consumed[0]
            real = ChannelRealization(
                chan_real.noise_var[idx], chan_real.mask[idx],
                h=chan_real.h[:, idx], h_hat=chan_real.h_hat[:, idx], sigma2=chan_real.sigma2,
            )
            mimo = (real, lambda purpose, shape: chan_draw(i, shape))
        consumed[0] += 1
        ps.fold_batch(
            _take_rows(words, idx),
            alphas[idx],
            w_b,
            None if nu_chan is None else nu_chan[idx],
            None if noise is None else noise[idx],
            mimo=mimo,
        )

    for pos in batches:
        pos = np.asarray(pos, np.int64)
        key = pos.tobytes()  # content identity: a redelivered batch dedups
        pad = cfg.batch_clients - len(pos)
        if pad < 0:
            raise ValueError(
                f"batch of {len(pos)} clients exceeds batch_clients={cfg.batch_clients}"
            )
        valid = np.concatenate([np.ones(len(pos), np.float32), np.zeros(pad, np.float32)])
        padded = np.concatenate([pos, np.full(pad, pos[0] if len(pos) else 0, np.int64)])
        if buf.full:
            backpressure[0] += 1
            consume_one()  # backpressure: bounded ingest memory
        buf.push(key, (padded, valid))
    while len(buf):
        consume_one()

    ghat, _ = ps.finalize()
    count, wsum = ps.totals
    info = {
        "batches_admitted": buf.admitted,
        "batches_rejected_dup": buf.rejected_dup,
        "batches_backpressure": backpressure[0],
        "buffer_peak_occupancy": buf.peak_occupancy,
        "tree_tiers": len(ps.tree.tiers),
        "peak_live_stats_bytes": ps.tree.peak_live_bytes,
        "participating": count,
        "weight_sum": wsum,
    }
    info.update(ps.health())
    return ghat, info
