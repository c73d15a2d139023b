"""The cohort round engine, barrier rounds (port of ``repro.fed.engine``).

One round is two passes:

  * **client pass** -- every cohort member's gradient, batched through
    ``torch.func.vmap(torch.func.grad(loss))``, flattened to its
    ``(nb, N)`` block grid, then ONE encode over all ``C * nb`` block rows
    (one fused-encoder launch on the kernel route; every encoder stage is
    per block, so batching the rows is the reference's vmapped encode).
  * **PS pass** -- reconstruction from the stacked payloads: ``fedqcs-ea``
    decodes the packed words per (client, block), in chunks of
    ``recon_chunk`` rows, and rho-sums; ``fedqcs-ae`` Bussgang-combines the
    codes and runs one EM-GAMP solve.

Then the FedAdam server step.  Participation contract: a cohort slot with
``rho_k = 0`` contributes nothing and its error-feedback residual carries
the full gradient forward.  This slice ports the ``fedqcs-ae`` and
``fedqcs-ea`` methods over the ideal uplink with the full scheduler; the
other methods, the streamed and chunked client passes, the loop oracle
and the telemetry hooks raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import entry_device, not_in_slice
from repro_torch.core import bussgang
from repro_torch.core.compression import BQCSCodec, FedQCSConfig, Layout, blocks_to_tree
from repro_torch.core.reconstruction import (
    aggregate_and_estimate,
    estimate_and_aggregate_packed,
    gamp_config_from,
)
from repro_torch.fed.channel import ChannelConfig, check_ported
from repro_torch.fed.scheduler import SchedulerConfig, SchedulerState, select_cohort
from repro_torch.fed.server_opt import ServerOptConfig, init_server_state, server_update

__all__ = ["CohortConfig", "CohortEngine", "ArrayClientData"]

PORTED_METHODS = ("fedqcs-ae", "fedqcs-ea")


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    """Engine-level knobs (same fields and defaults as the reference)."""

    method: str = "fedqcs-ae"
    chunk: int = 0
    groups: int = 1
    impl: str = "vmap"
    dither_n: int = 2048
    record_nmse: bool = True
    seed: int = 0
    layout: str = "monolithic"
    encode_stream: bool = False
    grad_accum: int = 1


def _check_ported(c: CohortConfig) -> None:
    if c.method not in PORTED_METHODS:
        raise not_in_slice(f"method {c.method!r}", "item 3")
    if c.dither_n != CohortConfig.dither_n:
        raise not_in_slice(f"qcs-dither re-blocking (dither_n={c.dither_n})", "item 3")
    if c.groups != 1:
        raise not_in_slice(f"AE decode in G={c.groups} groups", "item 6")
    if c.chunk or c.impl != "vmap":
        raise not_in_slice(f"client pass chunk={c.chunk} impl={c.impl!r}", "item 6")
    if c.layout != "monolithic" or c.encode_stream or c.grad_accum != 1:
        raise not_in_slice("per-tensor layouts and the streamed encode", "item 9")


class ArrayClientData:
    """Labeled-array federation: clients are index sets into one (x, y)
    array pair.  Batches are drawn host-side with the reference's numpy
    stream, deterministic in (seed, round, client id), then moved to the
    device."""

    def __init__(self, x, y, parts: List[np.ndarray], batch_size: int = 1, seed: int = 0,
                 device="cuda"):
        self.x, self.y = np.asarray(x), np.asarray(y)
        self.parts = [np.asarray(p, np.int64) for p in parts]
        self.counts = np.array([len(p) for p in self.parts], np.int64)
        if (self.counts == 0).any():
            raise ValueError("every client needs at least one sample")
        self.batch_size = batch_size
        self.seed = seed
        self.device = torch.device(device)
        maxlen = int(self.counts.max())
        self._idx = np.zeros((len(parts), maxlen), np.int64)
        for k, p in enumerate(self.parts):
            self._idx[k, : len(p)] = p
            self._idx[k, len(p) :] = p[0]  # padding never drawn (pos < len)

    def cohort_batch(self, round_idx: int, ids: np.ndarray) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, 0xDA7A, round_idx))
        u = rng.random((len(self.counts), self.batch_size))[ids]  # (C, b)
        pos = (u * self.counts[ids][:, None]).astype(np.int64)
        sel = self._idx[ids[:, None], pos]  # (C, b)
        return {
            "x": torch.as_tensor(self.x[sel], dtype=torch.float32, device=self.device),
            "y": torch.as_tensor(self.y[sel], dtype=torch.int64, device=self.device),
        }


class CohortEngine:
    """Stateful driver: owns params, per-client residuals, server-opt and
    scheduler state; each :meth:`run_round` is one federated round.

    ``params`` is a dict of tensors in the reference's names and layouts;
    ``grad_fn(params, batch)`` returns one client's gradient dict.  ``a``
    injects the sensing matrix (see ``BQCSCodec``).  ``last_ghat`` holds the
    decoded (nb, N) aggregate of the latest round.
    """

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        grad_fn: Callable[[Any, Any], Dict[str, torch.Tensor]],
        data: ArrayClientData,
        fed_cfg: Optional[FedQCSConfig] = None,
        cohort: CohortConfig = CohortConfig(),
        sched: SchedulerConfig = SchedulerConfig(),
        chan: ChannelConfig = ChannelConfig(),
        server: ServerOptConfig = ServerOptConfig(),
        device="cuda",
        a: Optional[torch.Tensor] = None,
    ):
        _check_ported(cohort)
        check_ported(chan)
        self.device = entry_device(device)
        self.cohort, self.sched, self.chan, self.server = cohort, sched, chan, server
        self.fed_cfg = fed_cfg or FedQCSConfig()
        self.grad_fn = grad_fn
        self.data = data
        self.params = {k: v.to(self.device, torch.float32) for k, v in params.items()}
        n = self.fed_cfg.block_size
        self.layout = Layout.monolithic(self.params, n)
        self.nb, self.n = self.layout.rows, n
        self.clients = len(data.counts)
        self.codec = BQCSCodec(self.fed_cfg, a=a, device=self.device)
        self.gamp = gamp_config_from(self.codec)
        self.residuals = torch.zeros((self.clients, self.nb, n), device=self.device)
        self.server_state = init_server_state(server, self.params)
        self.sched_state = SchedulerState.init(self.clients)
        self.round = 0
        self.last_ghat: Optional[torch.Tensor] = None
        self._vgrad = torch.func.vmap(lambda b: self.grad_fn(self.params, b))

    def _grad_blocks(self, batch) -> torch.Tensor:
        """(C, ...) cohort batch -> (C, nb, N) gradient blocks in one pass."""
        return self.layout.to_blocks_batched(self._vgrad(batch))

    def _client_pass(self, batch, residuals, rhos):
        """Gradients + one encode over all C * nb rows."""
        blocks = self._grad_blocks(batch)
        c = blocks.shape[0]
        words, alpha, enc_res = self.codec.compress_blocks_packed(
            blocks.reshape(c * self.nb, self.n), residuals.reshape(c * self.nb, self.n)
        )
        live = (rhos > 0)[:, None, None]
        new_res = torch.where(live, enc_res.reshape(c, self.nb, self.n), blocks + residuals)
        payload = {"words": words.reshape(c, self.nb, -1), "alpha": alpha.reshape(c, self.nb)}
        return payload, blocks, new_res

    def _ps(self, payload, blocks, rhos):
        """Reconstruction once per round from the stacked payloads."""
        stats: Dict[str, torch.Tensor] = {}
        words, alphas = payload["words"], payload["alpha"]
        if self.cohort.method == "fedqcs-ea":
            ghat = estimate_and_aggregate_packed(self.codec, words, alphas, rhos, self.gamp)
        else:  # fedqcs-ae over the ideal uplink
            stats["nu_quant"] = torch.mean(
                bussgang.effective_noise_var(alphas, rhos, self.codec.codebook)
            )
            stats["nu_channel"] = torch.zeros((), device=self.device)
            ghat = aggregate_and_estimate(
                self.codec, self.codec.unpack(words), alphas, rhos, gamp=self.gamp
            )
        if self.cohort.record_nmse:
            true_sum = torch.einsum("k,kbn->bn", rhos, blocks)
            num = torch.sum((ghat - true_sum) ** 2)
            stats["nmse"] = num / (torch.sum(true_sum**2) + 1e-30)
        return ghat, stats

    def run_round(self) -> Dict[str, float]:
        """One federated round; advances params/residuals/server state and
        returns the round's stats (python floats)."""
        t = self.round
        ids, rho0, self.sched_state = select_cohort(
            self.sched, self.sched_state, t, self.data.counts
        )
        # ideal uplink: every cohort member's link closes (mask of ones)
        r = torch.as_tensor(rho0, dtype=torch.float32, device=self.device)
        total = torch.sum(r)
        rhos = torch.where(total > 0, r / torch.clamp(total, min=1e-12), torch.zeros_like(r))
        jids = torch.as_tensor(ids, device=self.device)
        batch = self.data.cohort_batch(t, ids)
        payload, blocks, new_res = self._client_pass(batch, self.residuals[jids], rhos)
        ghat, stats = self._ps(payload, blocks, rhos)
        self.residuals[jids] = new_res
        self.params, self.server_state = server_update(
            self.server, blocks_to_tree(ghat, self.layout), self.server_state, self.params, t
        )
        self.last_ghat = ghat
        self.round = t + 1
        out = {k: float(v) for k, v in stats.items()}
        out["cohort"] = len(ids)
        out["participating"] = float(torch.sum(rhos > 0))
        return out

    def run(self, rounds: int) -> List[Dict[str, float]]:
        return [self.run_round() for _ in range(rounds)]
