"""The cohort round engine, barrier rounds (port of ``repro.fed.engine``).

One round is two passes:

  * **client pass** -- every cohort member's gradient, batched through
    ``torch.func.vmap(torch.func.grad(loss))`` (``cohort.chunk`` clients at
    a time when set, then concatenated) for a flat parameter dict, or one
    client at a time for a nested tree (the model zoo's, whose layers run
    under ``torch.utils.checkpoint``, which ``torch.func`` does not
    transform), flattened to its ``(nb, N)`` block
    grid, then the method's encode over all ``C * nb`` block rows at once
    (one fused-encoder launch on the kernel route; every encoder stage is
    per block, so batching the rows is the reference's vmapped encode).
    ``impl="loop"`` is the reference's per-client oracle: the same batched
    gradient pass, then one encode per client.  ``qcs-dither`` re-blocks
    each client's flat vector into ``dither_n``-wide rows and compresses
    and reconstructs them with that client's dither; ``signsgd`` sends
    signs; ``none`` sends nothing.
  * **PS pass** -- reconstruction from the stacked payloads, per method:
    ``fedqcs-ea`` decodes the packed words per (client, block) and
    rho-sums; ``fedqcs-ae`` Bussgang-combines the codes (in
    ``cohort.groups`` groups over an ideal uplink; after the uplink's noise
    over a noisy one) and runs one EM-GAMP solve; ``qcs-qiht`` runs QIHT per
    (client, block) and rho-sums; ``qcs-dither`` rho-sums the clients'
    reconstructions; ``signsgd`` takes the live clients' majority vote;
    ``none`` is the true sum.

Then the server step (``fed/server_opt.py``).  Participation contract: a
cohort slot with ``rho_k = 0`` -- scheduler dropout or channel outage --
contributes nothing, and its error-feedback residual carries the full
gradient forward.

With ``stream=`` (a :class:`~repro_torch.fed.stream.StreamConfig`; fedqcs-ae
and fedqcs-ea only) the PS pass is a streamed round instead: the cohort's
payloads arrive over simulated time in sub-cohort batches, fold into
partial sufficient statistics (``fed/stream.py``) and decode at the
deadline; a client that misses it is a non-participant (weight 0, full
residual carry, un-stamped), as under channel outage.

Telemetry (``obs=``, a recorder of ``repro_torch.obs``): an active recorder
makes the PS pass also compute the decode health (GAMP iterations and
convergence, the quantizer's clip saturation, the combiner's CSI health),
ends each round phase -- ``uplink``, ``client_pass``, ``decode`` or
``fold``, ``apply`` -- in a device synchronise inside its timing span, and
records one ``round`` event per round (stats, staleness, wire bytes, norms,
``phase_ms``, ``round_ms``).  The null recorder (the default) adds no
synchronise and times nothing, so unrecorded rounds are unchanged.

Every random tensor of a round -- the uplink's fading gains, fading matrix,
CSI error and receive noise, and each client's dither -- comes through ONE
seam, ``draw(round, purpose, shape, client=None)``, which returns a float32
tensor.  The default, :func:`seeded_draw`, draws on the engine's device
from the reference engine's own key path (``repro_torch.prng``, threefry),
so a round's draws are the reference's bit for bit, on the card as on the
CPU; tests may still inject draws through ``CohortEngine(draw=...)``.  A
round's per-client draws (qcs-dither's dither, a streamed round's receive
noise) take ``client=`` the cohort's ids: one draw a client from its own
key, all in one call, so a client's draw depends neither on the cohort nor
on how arrivals batch up; a multiple-access uplink's per-batch noise comes
under ``"batch_noise"`` with ``client=`` the batch's admission index.

The block layout (``core/layout.py``) is built once, in the constructor:
monolithic by default, ``cohort.layout="per_tensor"`` for independently
padded leaf segments, or an explicit ``GradientLayout`` (``layout=``, with
per-segment sparsity budgets if it has them).  With ``cohort.encode_stream``
the client pass takes the gradient one layout segment at a time
(``_client_pass_streamed``: one encode per segment, so the encoder holds one
segment's ``(C, rows, N)`` blocks, never the whole grid; the wire is
bit-identical to the one-pass encode), from one batched gradient pass
(``cohort.grad_accum`` microbatches a client) or from a caller's
``grad_segments_fn(params, batch, layout)``, which yields ``(segment index,
(C, rows, N) blocks)`` in any order: :func:`make_interleaved_segments`
gives the producer that yields each segment as the backward pass makes it
(``repro_torch.models.segment_tap``).

The parameters are any tree of ``repro_torch.tree`` (a flat dict, or the
model zoo's nested dicts with bf16 and fp32 leaves), kept with each leaf's
dtype, as the reference keeps its tree.  :class:`TokenClientData` is the
synthetic-language federation the launcher's cohort mode trains the
registry models on.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import entry_device, prng
from repro_torch import tree as tree_util
from repro_torch.core import baselines, bussgang
from repro_torch.core.compression import (
    BQCSCodec,
    FedQCSConfig,
    blocks_to_tree,
    packed_width,
)
from repro_torch.core.gamp import em_gamp, gamp_health
from repro_torch.core.layout import GradientLayout
from repro_torch.core.reconstruction import (
    aggregate_and_estimate,
    estimate_and_aggregate_packed,
    gamp_config_from,
)
from repro_torch.data.synthetic import affine_rule_batch
from repro_torch.fed.channel import (
    ChannelConfig,
    get_channel_family,
    mimo_tx_gain,
    realize_uplink,
)
from repro_torch.fed.scheduler import SchedulerConfig, SchedulerState, select_cohort
from repro_torch.fed.server_opt import ServerOptConfig, init_server_state, server_update
from repro_torch.fed.stream import (
    StreamConfig,
    StreamingPS,
    batch_arrivals,
    late_discount,
    simulate_arrivals,
    stream_decode,
)
from repro_torch.obs import NULL_RECORDER
from repro_torch.obs.trace import SUB_PHASES, SpanCollector, span

__all__ = ["CohortConfig", "CohortEngine", "ArrayClientData", "TokenClientData",
           "seeded_draw", "make_interleaved_segments", "METHODS", "EF_METHODS"]

EF_METHODS = ("fedqcs-ae", "fedqcs-ea", "qcs-qiht")
METHODS = EF_METHODS + ("qcs-dither", "signsgd", "none")


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    """Engine-level knobs (same fields and defaults as the reference)."""

    method: str = "fedqcs-ae"
    chunk: int = 0
    groups: int = 1
    impl: str = "vmap"
    dither_n: int = 2048  # qcs-dither re-blocking size (power of 2)
    record_nmse: bool = True
    seed: int = 0
    # block layout of the gradient wire (core/layout.py): "monolithic" or
    # "per_tensor"; an explicit GradientLayout (CohortEngine(layout=)) wins
    layout: str = "monolithic"
    # segment-streamed client encode: one layout segment at a time
    encode_stream: bool = False
    # microbatches a client for encode_stream's gradient pass (summed, then
    # divided by grad_accum)
    grad_accum: int = 1


def _check_cohort(c: CohortConfig) -> None:
    """The reference's gates on the cohort's knobs, in its order (the
    method is known)."""
    if c.impl not in ("vmap", "loop"):
        raise ValueError(f"unknown impl {c.impl!r} (choose 'vmap' or 'loop')")
    if c.layout not in ("monolithic", "per_tensor"):
        raise ValueError(
            f"unknown layout {c.layout!r} (choose 'monolithic' or "
            "'per_tensor', or pass an explicit GradientLayout)"
        )
    if c.encode_stream and c.method not in EF_METHODS:
        raise ValueError(
            "encode_stream drives the BQCS encoder one layout segment at a "
            f"time, which only the error-feedback codec methods {EF_METHODS} "
            f"use; got {c.method!r}"
        )
    if c.encode_stream and c.impl == "loop":
        raise ValueError(
            "encode_stream is a vmapped-encode path; the per-client loop "
            "oracle encodes whole block grids (impl='vmap')"
        )
    if c.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {c.grad_accum}")
    if c.grad_accum > 1 and not c.encode_stream:
        raise ValueError(
            "grad_accum microbatching is the encode_stream gradient hook's "
            "knob; set encode_stream=True"
        )


# the round's random tensors, by purpose
_DRAWS = {
    "gain": "rayleigh power gains |h_k|^2 ~ Exp(1), (C,): exponential(k_chan)",
    "h": "mimo_mac fading matrix, (n_rx, C): normal(split(k_chan)[0])",
    "h_err": "mimo_mac CSI estimate error, (n_rx, C): normal(split(k_chan)[1])",
    "noise": "receive noise, the reception's shape: normal(k_noise[, client])",
    "dither": "one client's qcs-dither draw: uniform(fold_in(kr, client), -0.5, 0.5)",
    "batch_noise": "a streamed mimo_mac batch's receive noise (n_rx, nb, M): "
                   "normal(fold_in(k_noise, admission index))",
}


def seeded_draw(seed: int, t: int, purpose: str, shape: Tuple[int, ...],
                client=None, device="cpu") -> torch.Tensor:
    """The default draw seam: a float32 tensor on ``device`` along the
    reference engine's key path -- the round key ``kr = fold_in(PRNGKey(seed),
    t)``, split into ``k_chan`` and ``k_noise`` -- so every purpose and client
    has its own draw and none depends on the cohort's other members or on
    the device (:data:`_DRAWS`).  ``client`` is a global client id (a
    streamed mimo_mac batch's admission index for ``"batch_noise"``), or a
    1-D sequence of ids: then one draw of ``shape`` a client, stacked
    ``(len(client), *shape)`` in one call, as the reference vmaps over its
    client keys."""
    if purpose not in _DRAWS:
        raise ValueError(f"unknown draw purpose {purpose!r} (choose from {sorted(_DRAWS)})")
    kr = prng.fold_in(prng.PRNGKey(seed, device=device), int(t))
    k_chan, k_noise = prng.split(kr).unbind(-2)
    if purpose == "gain":
        return prng.exponential(k_chan, shape)
    if purpose in ("h", "h_err"):
        return prng.normal(prng.split(k_chan)[0 if purpose == "h" else 1], shape)
    ids = None if client is None else torch.as_tensor(client, dtype=torch.int64, device=device)
    if purpose == "dither":
        return prng.uniform(prng.fold_in(kr, ids), shape, -0.5, 0.5)
    return prng.normal(k_noise if ids is None else prng.fold_in(k_noise, ids), shape)


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


class TokenClientData:
    """Synthetic-language federation for the registry models: each client
    holds its own stream of ``data/synthetic.py`` affine-rule sequences.
    Heterogeneity: clients mix ``n_dialects`` rule variants (dialect ``d``
    shifts the additive constant to ``17 + 5 d``) with per-client mixture
    weights drawn from Dir(alpha); alpha = 0 gives every client the uniform
    mixture.  The mixtures ``_p`` come from the reference's numpy stream,
    so they are the reference's bit for bit; a client's batch is drawn on
    the device along the reference's key path,
    ``split(fold_in(fold_in(PRNGKey(seed), round), client id), 4)``, so it
    is the reference's batch too, and a pure function of those three."""

    def __init__(
        self,
        vocab_size: int,
        batch: int,
        seq: int,
        clients: int,
        alpha: float = 0.0,  # 0 = homogeneous (no dialect skew)
        n_dialects: int = 10,
        noise: float = 0.2,
        seed: int = 0,
        device="cuda",
    ):
        self.vocab_size, self.batch, self.seq = vocab_size, batch, seq
        self.noise, self.seed = noise, seed
        self.device = entry_device(device)
        self.counts = np.ones(clients, np.int64)
        rng = np.random.default_rng((seed, 0xD1A1))
        if alpha > 0:
            self._p = rng.dirichlet(np.full(n_dialects, alpha), size=clients)
        else:
            self._p = np.full((clients, n_dialects), 1.0 / n_dialects)

    def cohort_batch(self, round_idx: int, ids: np.ndarray) -> Dict[str, torch.Tensor]:
        """``{"tokens", "labels"}``: (C, batch, seq) int64 on the device, the
        cohort's clients drawn together from their (C, 2) keys (the
        reference's vmap over them)."""
        base = prng.fold_in(prng.PRNGKey(self.seed, device=self.device), round_idx)
        keys = prng.fold_in(base, torch.as_tensor(ids, dtype=torch.int64, device=self.device))
        k1, k2, k3, k4 = prng.split(keys, 4).unbind(-2)
        # one dialect a row, from each client's mixture: the reference's
        # categorical over its f32 log(p + 1e-9)
        p = torch.as_tensor(self._p[ids], dtype=torch.float32, device=self.device)
        dialect = prng.categorical(k4, prng.log(p + float(np.float32(1e-9))),
                                   shape=(self.batch, 1))
        return affine_rule_batch(k1, k2, k3, self.batch, self.seq, self.vocab_size, self.noise,
                                 c=17 + 5 * dialect)


def _client(batch: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Client ``i``'s own batch out of the cohort's (C, ...) batch."""
    return {k: v[i] for k, v in batch.items()}


class CohortEngine:
    """Stateful driver: owns params, per-client residuals, server-opt and
    scheduler state; each :meth:`run_round` is one federated round.

    ``params`` is a tree of tensors in the reference's names and layouts
    (a flat dict, or a model's nested dicts), kept with each leaf's dtype
    on ``device``; ``grad_fn(params, batch)`` returns one client's gradient
    tree of the same structure.  A flat dict's clients go through
    ``torch.func.vmap`` of ``grad_fn`` together; a nested tree's one at a
    time (``grad_fn`` then need not be a ``torch.func`` transform: the
    launcher's is ``torch.autograd``'s).  ``a``
    injects the sensing matrix (see ``BQCSCodec``); ``draw`` replaces the
    draw seam (:func:`seeded_draw`, bound to ``cohort.seed``).  ``dither``
    is the ``qcs-dither`` codec (its signs and rows may be replaced before
    the first round).  ``last_ghat`` holds the decoded (nb, N) aggregate of
    the latest round.  ``stream`` selects streamed rounds (module
    docstring).  ``obs`` is a ``repro_torch.obs`` recorder (default: the
    null recorder); its ``active`` flag is read once, here.  ``layout`` is
    an explicit ``GradientLayout`` (over ``cohort.layout``);
    ``grad_segments_fn(params, batch, layout)`` replaces the streamed
    pass's segment source (``cohort.encode_stream`` only).  ``spec`` is
    ``layout``.
    """

    def __init__(
        self,
        params: Any,
        grad_fn: Callable[[Any, Any], Any],
        data: Any,  # ArrayClientData / TokenClientData duck type
        fed_cfg: Optional[FedQCSConfig] = None,
        cohort: CohortConfig = CohortConfig(),
        sched: SchedulerConfig = SchedulerConfig(),
        chan: ChannelConfig = ChannelConfig(),
        server: ServerOptConfig = ServerOptConfig(),
        stream: Optional[StreamConfig] = None,
        obs: Any = None,
        layout: Optional[GradientLayout] = None,
        grad_segments_fn: Optional[Callable[[Any, Any, GradientLayout], Any]] = None,
        device="cuda",
        a: Optional[torch.Tensor] = None,
        draw: Optional[Callable[..., torch.Tensor]] = None,
    ):
        if cohort.method not in METHODS:
            raise ValueError(f"unknown method {cohort.method!r} (choose from {METHODS})")
        _check_cohort(cohort)
        if grad_segments_fn is not None and not cohort.encode_stream:
            raise ValueError(
                "grad_segments_fn feeds the segment-streamed encode; set encode_stream=True"
            )
        if stream is not None and cohort.method not in ("fedqcs-ae", "fedqcs-ea"):
            raise ValueError(
                f"streaming rounds fold Bussgang/EA sufficient statistics, which "
                f"only the fedqcs methods produce; got {cohort.method!r}"
            )
        if stream is not None and cohort.groups != 1:
            raise ValueError("streaming fedqcs-ae has no group structure (groups must be 1)")
        # gating by the channel family's traits, as the reference does
        fam = get_channel_family(chan.kind)
        if not fam.exact_codes and cohort.method != "fedqcs-ae":
            raise ValueError(
                f"method {cohort.method!r} needs the exact codes at the PS, which "
                "only an ideal (error-free digital) uplink provides; noisy "
                "channels are supported by 'fedqcs-ae' (Bussgang + channel "
                "variance into em_gamp noise_var)"
            )
        if cohort.groups != 1 and (cohort.method != "fedqcs-ae" or not fam.exact_codes):
            raise ValueError("groups != 1 is only defined for fedqcs-ae over an ideal uplink")
        self._chan_family = fam
        self.device = entry_device(device)
        self.cohort, self.sched, self.chan, self.server = cohort, sched, chan, server
        self.stream = stream
        self.obs = obs if obs is not None else NULL_RECORDER
        self._collect = bool(self.obs.active)  # static: read once
        self._spans = SpanCollector() if self._collect else None
        self.fed_cfg = fed_cfg or FedQCSConfig()
        self.grad_fn = grad_fn
        self.data = data
        self.draw = draw or functools.partial(seeded_draw, cohort.seed, device=self.device)
        self.params = tree_util.tree_map(lambda v: v.to(self.device), params)
        # taken once, from the tree: a nested tree (the model zoo's) runs its
        # clients' gradients one at a time -- its layers run under
        # torch.utils.checkpoint, whose saved-tensor hooks torch.func does not
        # transform -- and a flat one (the MLP's) through one vmapped pass
        self._per_client = any(isinstance(v, dict) for v in params.values())
        # the layout is built once and shared by every pass; it IS the spec
        n = self.fed_cfg.block_size
        if layout is not None:
            if layout.n != n:
                raise ValueError(
                    f"explicit layout has block size {layout.n}, "
                    f"FedQCSConfig.block_size is {n}"
                )
            self.layout = layout
        elif cohort.layout == "per_tensor":
            self.layout = GradientLayout.per_tensor(self.params, n)
        else:
            self.layout = GradientLayout.monolithic(self.params, n)
        if self.layout.kind == "per_tensor" and cohort.method == "qcs-dither":
            raise ValueError(
                "qcs-dither re-blocks the monolithic flat vector; a per-tensor "
                "layout interleaves per-segment padding into that vector, so "
                "its geometry does not apply (use the monolithic layout)"
            )
        if not cohort.encode_stream and any(seg.s is not None for seg in self.layout.segments):
            raise ValueError(
                "per-segment sparsity budgets only take effect on the "
                "segment-streamed encode; set encode_stream=True"
            )
        self.spec = self.layout
        self.nbar = self.layout.nbar
        self.nb, self.n = self.layout.rows, n
        self._grad_segments_fn = grad_segments_fn
        self.clients = len(data.counts)
        ef = cohort.method in EF_METHODS
        self.codec = BQCSCodec(self.fed_cfg, a=a, device=self.device) if ef else None
        self.gamp = gamp_config_from(self.codec) if ef else None
        self.dither = (
            baselines.DitherCodec(n=cohort.dither_n,
                                  m=cohort.dither_n // self.fed_cfg.reduction_ratio,
                                  bits=self.fed_cfg.bits, device=self.device)
            if cohort.method == "qcs-dither" else None
        )
        self.residuals = torch.zeros((self.clients, self.nb, n), device=self.device)
        self.server_state = init_server_state(server, self.params)
        self.sched_state = SchedulerState.init(self.clients)
        self.round = 0
        self.last_ghat: Optional[torch.Tensor] = None
        self._vgrad = torch.func.vmap(lambda b: self.grad_fn(self.params, b))
        if stream is not None:
            # one StreamingPS serves every round
            self._stream_ps = StreamingPS(
                self.codec, mode="ae" if cohort.method == "fedqcs-ae" else "ea",
                gamp=self.gamp, stream=stream, use_kernels=self.fed_cfg.use_kernels,
                recon_chunk=self.fed_cfg.recon_chunk,
                chan=self.chan if fam.multiple_access else None,
                collect_health=self._collect,
            )

    def _sync(self) -> None:
        """The end of a timed phase when recording: wait for the device, so
        each phase's device time lands in its own span."""
        if self._collect and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _client_grad(self, batch):
        """One client's gradient tree of its own batch."""
        return self.grad_fn(self.params, batch)

    def _grad_blocks(self, batch) -> torch.Tensor:
        """(C, ...) cohort batch -> (C, nb, N) gradient blocks, one vmapped
        pass, or ``cohort.chunk`` clients a pass when that bounds how many
        per-client gradient dicts exist at once.  A nested tree's clients
        go one at a time, each gradient blocked into its row of one (C, nb,
        N) buffer and then dropped."""
        c = next(iter(batch.values())).shape[0]
        if self._per_client:
            out = torch.empty((c, self.nb, self.n), dtype=torch.float32, device=self.device)
            for i in range(c):
                out[i] = self.layout.to_blocks(self._client_grad(_client(batch, i)))
            return out
        chunk = self.cohort.chunk
        if chunk <= 0 or chunk >= c:
            return self.layout.to_blocks_batched(self._vgrad(batch))
        return torch.cat([
            self.layout.to_blocks_batched(
                self._vgrad({k: v[i:i + chunk] for k, v in batch.items()}))
            for i in range(0, c, chunk)
        ])

    def _dither_rows(self) -> Tuple[int, int]:
        """qcs-dither's re-blocking of the flat vector: (rows, M) per client."""
        return -(-self.layout.nbar // self.cohort.dither_n), self.dither.m

    def _mean_grad(self, grad, batch, axis: int):
        """``grad(batch)``, or with ``cohort.grad_accum`` > 1 the mean over
        that many microbatches of the samples on ``axis`` (1 for the cohort's
        batch, 0 for one client's), summed in the reference's order (the
        first, then each of the rest in turn) before dividing by the
        count."""
        acc = self.cohort.grad_accum
        if acc <= 1:
            return grad(batch)
        bsz = next(iter(batch.values())).shape[axis]
        if bsz % acc:
            raise ValueError(f"grad_accum={acc} must divide the per-client batch size {bsz}")
        mb = bsz // acc
        micro = [{k: v.narrow(axis, i * mb, mb) for k, v in batch.items()} for i in range(acc)]
        gsum = grad(micro[0])
        for b in micro[1:]:
            gsum = tree_util.tree_map(torch.add, gsum, grad(b))
        return tree_util.tree_map(lambda g: g / acc, gsum)

    def _grads_tree(self, batch):
        """(C, ...) cohort batch -> the batched gradient tree (leaves keep
        their shapes and dtypes under a leading client axis); the streamed
        pass slices layout segments out of it.  A nested tree's clients go
        one at a time, each written into its row of the batched tree."""
        if not self._per_client:
            return self._mean_grad(self._vgrad, batch, 1)
        c = next(iter(batch.values())).shape[0]
        out = None
        for i in range(c):
            g = self._mean_grad(self._client_grad, _client(batch, i), 0)
            if out is None:
                out = tree_util.tree_map(lambda x: x.new_empty((c,) + tuple(x.shape)), g)
            for path, leaf in tree_util.leaves(g):
                tree_util.get(out, path)[i] = leaf
        return out

    def _grad_segments(self, batch):
        """The streamed pass's segment source: yields ``(segment index,
        (C, rows, N) blocks)`` in any order.  By default one batched
        gradient pass (:meth:`_grads_tree`) with each layout segment sliced
        out of it; a ``grad_segments_fn(params, batch, layout)`` given to
        the constructor yields them instead (e.g. as a backward pass
        produces them)."""
        if self._grad_segments_fn is not None:
            yield from self._grad_segments_fn(self.params, batch, self.layout)
            return
        grads = self._grads_tree(batch)
        for seg in self.layout.segments:
            yield seg.index, self.layout.segment_blocks_batched(grads, seg.index)

    def _client_pass_streamed(self, batch, residuals, rhos, rhos_nmse):
        """Segment-streamed client pass (``cohort.encode_stream``): the
        gradient arrives one layout segment at a time and each segment is
        encoded on its own (one fused-encoder launch on the kernel route,
        with the segment's top-S budget), so the encoder holds one
        segment's ``(C, rows, N)`` blocks, never the whole grid.  The wire
        is bit-identical to the one-pass encode.  The nmse reference folds
        into a running ``(nb, N)`` ``true_sum`` (weights ``rhos_nmse``)
        rather than carrying every client's blocks to the PS.  Returns
        ``(payload, None, new residuals)``."""
        segs = self.layout.segments
        nseg = len(segs)
        pay: List[Any] = [None] * nseg
        res: List[Any] = [None] * nseg
        tsum: List[Any] = [None] * nseg
        seg_s = self.layout.segment_s(self.fed_cfg.s)
        # "backward" spans the producer's next(), "encode_overlap" the encode
        # of what it yielded
        it = self._grad_segments(batch)
        while True:
            with span("backward", self._spans):
                nxt = next(it, None)
            if nxt is None:
                break
            idx, seg_blocks = nxt
            if not 0 <= idx < nseg:
                raise ValueError(
                    f"grad_segments_fn yielded segment index {idx}, layout has {nseg} segments"
                )
            if pay[idx] is not None:
                raise ValueError(
                    f"grad_segments_fn yielded segment {idx} ({segs[idx].name!r}) twice -- a "
                    "second payload would silently drop the first from the wire"
                )
            with span("encode_overlap", self._spans):
                pay[idx], res[idx] = self._encode(seg_blocks, residuals[:, segs[idx].row_slice],
                                                  rhos, None, s=seg_s[idx])
                if self.cohort.record_nmse:
                    tsum[idx] = torch.einsum("k,kbn->bn", rhos_nmse, seg_blocks)
        missing = [i for i, p in enumerate(pay) if p is None]
        if missing:
            raise ValueError(f"grad_segments_fn never yielded segments {missing}")
        payload = {k: torch.cat([p[k] for p in pay], dim=1) for k in pay[0]}
        if self.cohort.record_nmse:
            payload["true_sum"] = torch.cat(tsum)
        return payload, None, torch.cat(res, dim=1)

    def _client_pass(self, batch, residuals, rhos, unit_dither=None, rhos_nmse=None):
        """Gradients (always batched) + the method's encode: over all
        C * nb rows at once, or with ``impl="loop"`` one client at a time
        (the per-client payloads and residuals concatenated), or with
        ``cohort.encode_stream`` a layout segment at a time.
        ``unit_dither`` is the cohort's (C * rows, M) qcs-dither draw;
        ``rhos_nmse`` the nmse reference's weights where they are not
        ``rhos`` (a streamed round encodes with raw weights).  Returns
        (payload, blocks or None, new residuals)."""
        if self.cohort.encode_stream:
            return self._client_pass_streamed(batch, residuals, rhos,
                                              rhos if rhos_nmse is None else rhos_nmse)
        blocks = self._grad_blocks(batch)
        if self.cohort.impl != "loop":
            payload, new_res = self._encode(blocks, residuals, rhos, unit_dither)
            return payload, blocks, new_res
        rows = 0 if unit_dither is None else self._dither_rows()[0]
        outs = [
            self._encode(blocks[i:i + 1], residuals[i:i + 1], rhos[i:i + 1],
                         None if unit_dither is None else unit_dither[i * rows:(i + 1) * rows])
            for i in range(blocks.shape[0])
        ]
        payload = {k: torch.cat([o[0][k] for o in outs]) for k in outs[0][0]}
        return payload, blocks, torch.cat([o[1] for o in outs])

    def _encode(self, blocks, residuals, rhos, unit_dither, s: Optional[int] = None):
        """The method's encode of (C, rows, N) blocks -> (payload, new
        residuals): the whole grid, or one layout segment's rows with its
        top-S budget ``s`` (the codec's ``s`` when None).  fedqcs-ae and
        fedqcs-ea carry the packed words (AE unpacks them at the PS),
        qcs-qiht the index view.  ``residuals`` (rows of the round's own
        gather of the residuals) is overwritten by the error-feedback
        methods."""
        c, rows = blocks.shape[:2]
        method = self.cohort.method
        payload: Dict[str, torch.Tensor] = {}
        new_res = residuals
        if method in EF_METHODS:
            flat_b = blocks.reshape(c * rows, self.n)
            flat_r = residuals.reshape(c * rows, self.n)
            if method == "qcs-qiht":  # the uint8 index view
                codes, alpha, enc_res = self.codec.compress_blocks(flat_b, flat_r, s)
                payload["codes"] = codes.reshape(c, rows, -1)
            else:  # the packed wire words
                words, alpha, enc_res = self.codec.compress_blocks_packed(flat_b, flat_r, s)
                payload["words"] = words.reshape(c, rows, -1)
            payload["alpha"] = alpha.reshape(c, rows)
            live = (rhos > 0)[:, None, None]
            # the cohort's residual rows come as a fresh gather, which the
            # reference donates: the carry, then the new residual, overwrite it
            carry = residuals.add_(blocks)
            new_res = torch.where(live, enc_res.reshape(c, rows, self.n), carry, out=carry)
        elif method == "qcs-dither":
            nbar, dn = self.layout.nbar, self.cohort.dither_n
            rows, _ = self._dither_rows()
            flat = blocks.reshape(c, -1)[:, :nbar]
            carry = torch.nn.functional.pad(flat, (0, rows * dn - nbar)).reshape(c * rows, dn)
            q, delta, dith = self.dither.compress(carry, unit_dither)
            recon = self.dither.reconstruct(q, delta, dith).reshape(c, -1)[:, :nbar]
            payload["recon"] = torch.nn.functional.pad(
                recon, (0, self.nb * self.n - nbar)).reshape(c, self.nb, self.n)
        elif method == "signsgd":
            payload["signs"] = baselines.signsgd_compress(blocks)
        return payload, new_res

    @staticmethod
    def _true_sum(payload, blocks, rhos):
        """The true aggregate: folded per segment by the streamed encode, or
        the rho-weighted sum of the cohort's blocks (None without either)."""
        if "true_sum" in payload:
            return payload["true_sum"]
        return None if blocks is None else torch.einsum("k,kbn->bn", rhos, blocks)

    def _ps(self, payload, blocks, rhos, real=None, draw=None):
        """Reconstruction once per round from the stacked payloads.  ``real``
        is the round's channel realization and ``draw(purpose, shape)`` its
        draw seam on the device; over a noisy uplink, fedqcs-ae's received
        rows get their noise draw and the channel's variance joins the
        Bussgang term in em_gamp's noise_var."""
        stats: Dict[str, torch.Tensor] = {}
        method = self.cohort.method
        collect = self._collect
        if collect and self.codec is not None:
            # quantizer clip-saturation rate off the wire payload (vq: 0)
            if "words" in payload:
                stats["clip_saturation"] = self.codec.clip_saturation(payload["words"])
            else:
                stats["clip_saturation"] = self.codec.clip_saturation(payload["codes"],
                                                                      packed=False)
        true_sum = self._true_sum(payload, blocks, rhos)
        if method == "none":
            ghat = true_sum
        elif method == "signsgd":
            # unweighted majority vote; rho_k = 0 clients abstain
            alive = (rhos > 0).to(torch.int8)[:, None, None]
            scale = torch.mean(torch.abs(true_sum))
            ghat = baselines.signsgd_aggregate(payload["signs"] * alive, lr_scale=scale)
        elif method == "qcs-dither":
            ghat = torch.einsum("k,kbn->bn", rhos, payload["recon"])
        elif method == "qcs-qiht":
            codes, alphas = payload["codes"], payload["alpha"]
            c, nb, lanes = codes.shape
            parts = baselines.qiht_reconstruct(
                codes.reshape(c * nb, lanes), alphas.reshape(-1),
                self.codec.a, self.codec.codebook, self.fed_cfg.s,
            )
            ghat = torch.einsum("k,kbn->bn", rhos, parts.reshape(c, nb, -1))
        elif method == "fedqcs-ea":
            ghat = estimate_and_aggregate_packed(
                self.codec, payload["words"], payload["alpha"], rhos, self.gamp,
                with_info=collect,
            )
            if collect:
                ghat, ginfo = ghat
                stats.update(gamp_health(ginfo, live=payload["alpha"] > 0))
        else:  # fedqcs-ae
            words, alphas = payload["words"], payload["alpha"]
            q = self.codec.codebook
            fam = self._chan_family
            nu_q = bussgang.effective_noise_var(alphas, rhos, q)
            stats["nu_quant"] = torch.mean(nu_q)
            if fam.exact_codes:
                stats["nu_channel"] = torch.zeros((), device=self.device)
                ghat = aggregate_and_estimate(
                    self.codec, self.codec.unpack(words), alphas, rhos,
                    groups=self.cohort.groups, gamp=self.gamp, with_info=collect,
                )
                if collect:
                    ghat, ginfo = ghat
                    stats.update(gamp_health(ginfo))
            else:
                deq = self.codec.dequantize(self.codec.unpack(words))  # (C, nb, M)
                w = bussgang.bussgang_weight(rhos[:, None], alphas, q)  # (C, nb)
                if fam.multiple_access:
                    # every live client pre-scales by its Bussgang weight
                    # times the round's broadcast power-control scalar and
                    # transmits at once; the PS combines the one reception
                    active = (rhos > 0).to(torch.float32)
                    eta = mimo_tx_gain(w, active)
                    x = (eta * w)[..., None] * deq  # (C, nb, M) transmit rows
                    y_rx = fam.transmit(self.chan, real, x, draw)
                    combined = fam.combine(self.chan, real, y_rx, w, active, psi=q.psi,
                                           tx_gain=eta, with_aux=collect)
                    y, nu_ch = combined[:2]
                    if collect:  # the combiner's CSI health
                        stats.update(combined[2])
                else:
                    # per-client reception: equalized rows + their variance,
                    # Bussgang-combined at the PS (eqs. 23-24 + the channel term)
                    nu_chan = fam.effective_noise(real)
                    y_rx = fam.transmit(self.chan, real, deq, draw)
                    y = torch.sum(w[..., None] * y_rx, dim=0)
                    nu_ch = torch.sum(torch.square(w) * nu_chan, dim=0)  # (nb,)
                stats["nu_channel"] = torch.mean(nu_ch)
                energy = bussgang.signal_energy(alphas, rhos, self.fed_cfg.m, self.n)
                ghat = em_gamp(y, nu_q + nu_ch, self.codec.a, self.gamp, init_var=energy,
                               use_kernels=self.fed_cfg.use_kernels, with_info=collect)
                if collect:
                    ghat, ginfo = ghat
                    stats.update(gamp_health(ginfo))
        if self.cohort.record_nmse and true_sum is not None and method != "none":
            num = torch.sum((ghat - true_sum) ** 2)
            stats["nmse"] = num / (torch.sum(true_sum**2) + 1e-30)
        return ghat, stats

    # -- round loop ---------------------------------------------------------

    def _staleness(self, prev_sched, ids, t) -> np.ndarray:
        """Cohort staleness at selection time: rounds since each member's
        last successful participation (0 for never-participated)."""
        last = prev_sched.last_round[ids]
        return np.where(last < 0, 0, t - 1 - last)

    def _wire_up_bytes(self, participating: float):
        """Uplink wire cost this round: the participants' packed words plus
        one f32 alpha per block for the fedqcs/qiht families, 1 bit/entry for
        signsgd; None where the method has no defined wire format."""
        method = self.cohort.method
        if self.codec is not None and method in EF_METHODS:
            q = self.codec.codebook
            w = packed_width(q.n_codes(self.fed_cfg.m), q.bits)
            return participating * self.nb * (w * 32 + 32) / 8.0
        if method == "signsgd":
            return participating * self.nb * self.n / 8.0
        return None

    def _record_round(self, t, out, staleness, ghat) -> None:
        """Assembles and records the round event (host side, once per
        round): the returned stats plus staleness, wire bytes, norms and the
        phase timings."""
        event: Dict[str, Any] = dict(out)
        event["round"] = t
        event["staleness_mean"] = float(np.mean(staleness)) if len(staleness) else 0.0
        wire = self._wire_up_bytes(out["participating"])
        if wire is not None:
            event["wire_up_bytes"] = wire
            if self.codec is not None and len(self.layout.segments) > 1:
                # each layout segment's share of the uplink (its pad rows
                # are overhead the monolithic layout would not pay)
                q = self.codec.codebook
                w = packed_width(q.n_codes(self.fed_cfg.m), q.bits)
                event["wire_segments"] = [
                    {"name": seg.name, "rows": seg.rows, "pad": seg.pad,
                     "bytes": out["participating"] * seg.rows * (w * 32 + 32) / 8.0}
                    for seg in self.layout.segments
                ]
        # model broadcast: every cohort member pulls the nbar f32 params
        event["wire_down_bytes"] = float(out["cohort"]) * self.nbar * 4.0
        # each leaf's sum of squares in fp32, added in the reference's leaf order
        pn2 = sum(torch.sum(torch.square(p.float())) for _, p in tree_util.leaves(self.params))
        un, pn = torch.stack([torch.sqrt(torch.sum(torch.square(ghat))),
                              torch.sqrt(pn2)]).tolist()
        event["update_norm"], event["param_norm"] = un, pn
        phase = self._spans.drain()
        event["phase_ms"] = phase
        event["round_ms"] = sum(v for k, v in phase.items() if k not in SUB_PHASES)
        self.obs.record("round", event)

    def _uplink(self, t, n_cohort):
        """The round's channel realization (drawn where the draw seam draws,
        then moved to the device) and its outage mask as numpy."""
        real = realize_uplink(self.chan, lambda p, shape: self.draw(t, p, shape),
                              n_cohort, self.nb)
        mask = real.mask.cpu().numpy()
        return real.to(self.device), mask

    @staticmethod
    def _normalized(r: torch.Tensor) -> torch.Tensor:
        total = torch.sum(r)
        return torch.where(total > 0, r / torch.clamp(total, min=1e-12), torch.zeros_like(r))

    def _apply(self, t, jids, new_res, ghat) -> None:
        self.residuals[jids] = new_res
        self.params, self.server_state = server_update(
            self.server, blocks_to_tree(ghat, self.layout), self.server_state, self.params, t
        )
        self.last_ghat = ghat

    def run_round(self) -> Dict[str, float]:
        """One federated round; advances params/residuals/server state and
        returns the round's stats (python floats)."""
        if self.stream is not None:
            return self._run_round_streaming()
        t = self.round
        prev_sched = self.sched_state
        ids, rho0, new_sched = select_cohort(self.sched, prev_sched, t, self.data.counts)
        stale = self._staleness(prev_sched, ids, t) if self._collect else ()
        # the uplink is realized before the cohort passes
        with span("uplink", self._spans):
            real, mask = self._uplink(t, len(ids))
            self._sync()
        # channel outage is a failed participation: those clients keep their
        # last successful round (their residual carries the full gradient)
        dead = ids[mask == 0]
        if len(dead):
            new_sched.last_round[dead] = prev_sched.last_round[dead]
        self.sched_state = new_sched
        rhos = self._normalized(
            torch.as_tensor(rho0 * mask, dtype=torch.float32, device=self.device))
        jids = torch.as_tensor(ids, device=self.device)
        with span("client_pass", self._spans):
            unit_dither = None
            if self.dither is not None:
                shape = self._dither_rows()
                unit_dither = self.draw(t, "dither", shape, client=ids).reshape(
                    -1, shape[-1]).to(self.device)
            batch = self.data.cohort_batch(t, ids)
            payload, blocks, new_res = self._client_pass(batch, self.residuals[jids], rhos,
                                                         unit_dither)
            self._sync()
        with span("decode", self._spans):
            ghat, stats = self._ps(payload, blocks, rhos, real,
                                   lambda p, shape: self.draw(t, p, shape).to(self.device))
            self._sync()
        with span("apply", self._spans):
            self._apply(t, jids, new_res, ghat)
            self._sync()
        self.round = t + 1
        out = {k: float(v) for k, v in stats.items()}
        out["cohort"] = len(ids)
        out["participating"] = float(torch.sum(rhos > 0))
        if self._collect:
            self._record_round(t, out, stale, ghat)
        return out

    def _run_round_streaming(self) -> Dict[str, float]:
        """A streamed round: the same client pass, then the PS folds
        arrival-ordered sub-cohort payload batches through the bounded
        ingest buffer into partial sufficient statistics and decodes at the
        deadline.  Weights fold raw (scheduler rho x outage mask x arrival x
        lateness discount); a missed deadline is a non-participation: weight
        0 (full residual carry) and un-stamped, as channel outage."""
        t = self.round
        prev_sched = self.sched_state
        ids, rho0, new_sched = select_cohort(self.sched, prev_sched, t, self.data.counts)
        stale = self._staleness(prev_sched, ids, t) if self._collect else ()
        with span("uplink", self._spans):
            real, mask = self._uplink(t, len(ids))
            self._sync()
        cfg = self.stream
        alive = (np.asarray(rho0) > 0) & (mask > 0)
        times = simulate_arrivals(cfg, t, len(ids), alive)
        arrived = times <= cfg.deadline
        w_raw = (np.asarray(rho0, np.float64) * mask * arrived
                 * late_discount(cfg, times)).astype(np.float32)
        dead = ids[(mask == 0) | ~arrived]
        if len(dead):
            new_sched.last_round[dead] = prev_sched.last_round[dead]
        self.sched_state = new_sched
        jw = torch.as_tensor(w_raw, device=self.device)
        rhos = self._normalized(jw)  # the nmse reference weighting
        jids = torch.as_tensor(ids, device=self.device)
        with span("client_pass", self._spans):
            batch = self.data.cohort_batch(t, ids)
            payload, blocks, new_res = self._client_pass(batch, self.residuals[jids], jw,
                                                         rhos_nmse=rhos)
            self._sync()
        fam = self._chan_family
        nu_chan = noise = chan_real = chan_draw = None
        batches = batch_arrivals(times, cfg.deadline, cfg.batch_clients)
        with span("fold", self._spans):
            if fam.multiple_access:
                # each arrival batch is one superimposed sub-cohort reception
                # over this round's H, with its own receive noise
                chan_real = real

                def chan_draw(i, shape):
                    return self.draw(t, "batch_noise", shape, client=i).to(self.device)
            elif not fam.exact_codes:
                # per-client receive noise: independent of the batching
                nu_chan = fam.effective_noise(real)
                noise = self.draw(t, "noise", (self.nb, self.fed_cfg.m),
                                  client=ids).to(self.device)
            ghat, sinfo = stream_decode(
                self.codec, payload["words"], payload["alpha"], w_raw, batches,
                nu_chan=nu_chan, noise=noise, chan_real=chan_real, chan_draw=chan_draw,
                ps=self._stream_ps,
            )
            self._sync()
        with span("apply", self._spans):
            self._apply(t, jids, new_res, ghat)
            self._sync()
        self.round = t + 1
        out = {k: float(v) for k, v in sinfo.items() if k != "participating"}
        if self.cohort.record_nmse:
            true_sum = self._true_sum(payload, blocks, rhos)
            num = torch.sum((ghat - true_sum) ** 2)
            out["nmse"] = float(num / (torch.sum(true_sum**2) + 1e-30))
        out["cohort"] = len(ids)
        out["participating"] = float(np.sum(w_raw > 0))
        out["arrived"] = float(np.sum(arrived))
        if self._collect:
            out["clip_saturation"] = float(self.codec.clip_saturation(payload["words"]))
            self._record_round(t, out, stale, ghat)
        return out

    def run(self, rounds: int) -> List[Dict[str, float]]:
        return [self.run_round() for _ in range(rounds)]


def make_interleaved_segments(model_cfg: Any, layout: GradientLayout, grad_accum: int = 1,
                              layer_chunks: int = 1):
    """``grad_segments_fn`` that interleaves the encode with backprop: yields
    each layout segment's ``(C, rows, N)`` blocks as the corresponding layer
    cotangents are made -- backward order -- so the encode of layer L is
    queued while L-1 backprops and the full gradient tree never exists.
    Works for every staged registry family (transformer, moe, vlm, ssm,
    hybrid); build ``layout`` with
    :func:`repro_torch.models.segment_tap.interleaved_layout` (the same
    ``layer_chunks``) and pass BOTH it and the returned producer to
    :class:`CohortEngine` with ``encode_stream=True``.  ``grad_accum`` must
    mirror ``CohortConfig.grad_accum``: the producer microbatches each stage
    as the one-pass tree pass does.  The returned object also exposes
    ``grads_fn`` and ``peak_live_grad_bytes`` (the bit-identity oracle and
    the live-bytes bound)."""
    from repro_torch.models.segment_tap import InterleavedSegments

    return InterleavedSegments(model_cfg, layout, grad_accum=grad_accum,
                               layer_chunks=layer_chunks)


# ---------------------------------------------------------------------------
# Smoke entry point: a tiny synthetic cohort end to end.
#     PYTHONPATH=src python -m repro_torch.fed --device cpu --clients 8 --rounds 2
# ---------------------------------------------------------------------------


def _smoke_main(argv=None):
    import argparse

    from repro_torch.fed.channel import CHANNEL_FAMILIES
    from repro_torch.fed.partition import PartitionConfig, partition_indices
    from repro_torch.fed.toy import toy_classification, toy_loss, toy_params

    ap = argparse.ArgumentParser(description="cohort engine smoke")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sample-frac", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--snr-db", type=float, default=None)
    ap.add_argument(
        "--channel", default=None, choices=sorted(CHANNEL_FAMILIES),
        help="uplink family (default: awgn when --snr-db is set, else ideal)",
    )
    ap.add_argument("--n-rx", type=int, default=8, help="mimo_mac receive antennas")
    ap.add_argument("--csi-error", type=float, default=0.0,
                    help="mimo_mac CSI estimate error variance")
    ap.add_argument("--method", default="fedqcs-ae", choices=METHODS)
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--layout", default="monolithic", choices=("monolithic", "per_tensor"),
                    help="gradient block layout (per_tensor = independently padded leaf segments)")
    ap.add_argument("--encode-stream", action="store_true",
                    help="stream the client encode one layout segment at a time")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches for the encode-stream gradient hook")
    ap.add_argument("--stream", type=int, default=0, metavar="BATCH",
                    help="streaming PS mode: sub-cohort ingest batch size (0 = barrier round)")
    ap.add_argument("--deadline", type=float, default=8.0)
    ap.add_argument("--record", default=None, metavar="RUN_DIR",
                    help="write events.jsonl + meta.json to this run dir (repro_torch.obs)")
    args = ap.parse_args(argv)

    recorder = None
    if args.record:
        from repro_torch.obs import JsonlRecorder

        recorder = JsonlRecorder(args.record, config=vars(args))

    x, y = toy_classification()
    parts = partition_indices(
        y, args.clients, PartitionConfig(kind="dirichlet", alpha=args.alpha, min_size=4)
    )
    engine = CohortEngine(
        toy_params(),
        torch.func.grad(toy_loss),
        ArrayClientData(x, y, parts, batch_size=4, device=args.device),
        fed_cfg=FedQCSConfig(block_size=64, reduction_ratio=2, bits=3, gamp_iters=10),
        cohort=CohortConfig(
            method=args.method, chunk=args.chunk, layout=args.layout,
            encode_stream=args.encode_stream, grad_accum=args.grad_accum,
        ),
        sched=SchedulerConfig(
            kind="uniform" if args.sample_frac < 1.0 else "full",
            sample_frac=args.sample_frac,
        ),
        chan=ChannelConfig(
            kind=args.channel or ("awgn" if args.snr_db is not None else "ideal"),
            snr_db=args.snr_db if args.snr_db is not None else 20.0,
            n_rx=args.n_rx,
            csi_error=args.csi_error,
        ),
        server=ServerOptConfig(kind="fedadam", lr=0.01),
        stream=StreamConfig(batch_clients=args.stream, deadline=args.deadline)
        if args.stream > 0 else None,
        obs=recorder,
        device=args.device,
    )
    for i, stats in enumerate(engine.run(args.rounds)):
        print("round", i, stats)
        if not all(np.isfinite(v) for v in stats.values()):
            raise RuntimeError(f"round {i}: non-finite stats {stats}")
    if recorder is not None:
        recorder.close()
        print("recorded:", recorder.run_dir)
    print("smoke ok:", args.clients, "clients,", args.rounds, "rounds")
