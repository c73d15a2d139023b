"""The paper's own experimental setup (Sec. VI), port of ``repro.paper.mlp``:
a 784-20-10 MLP trained by K=30 non-IID devices with Adam at the PS,
minibatch 1 per device per round.

The MLP is an ``nn.Module`` whose parameters keep the reference's names and
layouts (``w1`` (784, 20), ``b1`` (20,), ``w2`` (20, 10), ``b2`` (10,)), so
the block grid and the wire are the reference's.  The round engine works on
plain parameter dicts through ``torch.func.functional_call``.
:func:`mlp_engine` builds the experiment's cohort engine and
:func:`run_federated` drives it, recording round and ``eval`` events when
given a recorder (``obs=``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch import entry_device, prng
from repro_torch.core.compression import FedQCSConfig
from repro_torch.core.layout import GradientLayout
from repro_torch.data import mnist
from repro_torch.fed.channel import ChannelConfig
from repro_torch.fed.engine import ArrayClientData, CohortConfig, CohortEngine
from repro_torch.fed.partition import PartitionConfig, partition_indices
from repro_torch.fed.scheduler import SchedulerConfig
from repro_torch.fed.server_opt import ServerOptConfig
from repro_torch.fed.stream import StreamConfig

N_IN, N_HID, N_OUT = 784, 20, 10  # N_bar = 15,910
Params = Dict[str, torch.Tensor]


class MLP(nn.Module):
    """784-20-10 ReLU MLP, weights stored (in, out) as in the reference."""

    def __init__(self, key: Optional[torch.Tensor] = None, device="cpu"):
        """``key`` (a ``repro_torch.prng`` key) draws the weights as the
        reference's ``init_mlp(key)``: ``split(key)`` into w1's and w2's,
        each normal times 1/sqrt(fan_in); without one they are left empty."""
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.w1 = nn.Parameter(torch.empty((N_IN, N_HID), **kw))
        self.b1 = nn.Parameter(torch.zeros((N_HID,), **kw))
        self.w2 = nn.Parameter(torch.empty((N_HID, N_OUT), **kw))
        self.b2 = nn.Parameter(torch.zeros((N_OUT,), **kw))
        if key is not None:
            k1, k2 = prng.split(key).unbind(-2)
            with torch.no_grad():
                self.w1.copy_(prng.normal(k1, (N_IN, N_HID)) * float(1.0 / np.sqrt(N_IN)))
                self.w2.copy_(prng.normal(k2, (N_HID, N_OUT)) * float(1.0 / np.sqrt(N_HID)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


_SKELETON = MLP(device="meta")  # parameter-free shell for functional_call


def init_mlp(seed: int, device="cuda") -> Params:
    """The reference's ``init_mlp(PRNGKey(seed))``, drawn on the CPU then
    moved, so the CPU and the card start from the same weights."""
    model = MLP(prng.PRNGKey(seed))
    return {k: v.detach().to(device) for k, v in model.named_parameters()}


def mlp_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.func.functional_call(_SKELETON, params, (x,))


def mlp_loss(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(mlp_logits(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None]))


def device_grad(params: Params, x: torch.Tensor, y: torch.Tensor) -> Params:
    """One device's gradient of the loss on (x, y)."""
    return torch.func.grad(mlp_loss)(params, x, y)


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(mlp_logits(params, x), dim=-1) == y).float())


def mlp_grad_fn(params: Params, batch) -> Params:
    """Engine-facing gradient of one client's {"x", "y"} batch."""
    return torch.func.grad(mlp_loss)(params, batch["x"], batch["y"])


@dataclasses.dataclass
class RunResult:
    accs: List[float]
    nmses: List[float]
    losses: List[float]
    bits_per_entry: float
    wall_s: float
    round_ms: List[float]  # host wall time of each run_round (synchronised)
    last_ghat: torch.Tensor  # the last round's decoded (nb, N) aggregate


def mlp_engine(
    method: str,
    k_devices: int = 30,
    fed_cfg: Optional[FedQCSConfig] = None,
    lr: float = 0.003,
    seed: int = 0,
    batch_per_device: int = 1,
    groups: int = 1,
    record_nmse: bool = True,
    partition: str = "paper",
    alpha: float = 0.1,
    scheduler: str = "full",
    sample_frac: float = 1.0,
    dropout: float = 0.0,
    channel: str = "ideal",
    snr_db: float = 20.0,
    n_rx: int = 8,
    csi_error: float = 0.0,
    combiner: str = "lmmse",
    server: str = "fedadam",
    chunk: int = 0,
    impl: str = "vmap",
    stream: Optional[StreamConfig] = None,
    obs: Any = None,
    layout: Union[str, GradientLayout] = "monolithic",
    encode_stream: bool = False,
    grad_accum: int = 1,
    device="cuda",
    params: Optional[Params] = None,
    a: Optional[torch.Tensor] = None,
) -> Tuple[CohortEngine, Tuple[np.ndarray, np.ndarray]]:
    """The cohort engine of the paper's experiment, before its first round,
    and the test split ``(x, y)``: what :func:`run_federated` drives (its
    arguments are the engine's), for callers that step the engine
    themselves.  Two calls with the same arguments give engines in the same
    state.  ``layout`` is ``cohort.layout`` ("monolithic" or "per_tensor")
    or an explicit ``GradientLayout`` of the MLP's parameters at N = 1591;
    ``encode_stream`` and ``grad_accum`` are the cohort's."""
    dev = entry_device(device)
    (xtr, ytr, xte, yte), _ = mnist.load(seed)
    parts = partition_indices(
        ytr, k_devices, PartitionConfig(kind=partition, alpha=alpha, seed=seed)
    )
    fed_cfg = fed_cfg or FedQCSConfig(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=25)
    # Paper blocking: B=10 blocks -> N = ceil(15910/10) = 1591.
    fed_cfg = dataclasses.replace(fed_cfg, block_size=1591)
    if params is None:
        params = init_mlp(seed, dev)
    engine = CohortEngine(
        params,
        mlp_grad_fn,
        ArrayClientData(xtr, ytr, parts, batch_size=batch_per_device, seed=seed, device=dev),
        fed_cfg=fed_cfg,
        cohort=CohortConfig(method=method, groups=groups, record_nmse=record_nmse,
                            chunk=chunk, impl=impl, seed=seed,
                            layout=layout if isinstance(layout, str) else layout.kind,
                            encode_stream=encode_stream, grad_accum=grad_accum),
        sched=SchedulerConfig(kind=scheduler, sample_frac=sample_frac,
                              dropout_prob=dropout, seed=seed),
        chan=ChannelConfig(kind=channel, snr_db=snr_db, n_rx=n_rx, csi_error=csi_error,
                           combiner=combiner),
        server=ServerOptConfig(kind=server, lr=lr, b1=0.9, b2=0.999, eps=1e-8),
        stream=stream,
        obs=obs,
        layout=None if isinstance(layout, str) else layout,
        device=dev,
        a=a,
    )
    return engine, (xte, yte)


def run_federated(
    method: str,  # fedqcs-ea | fedqcs-ae | qcs-qiht | qcs-dither | signsgd | none
    steps: int = 300,
    k_devices: int = 30,
    fed_cfg: Optional[FedQCSConfig] = None,
    lr: float = 0.003,
    eval_every: int = 25,
    seed: int = 0,
    batch_per_device: int = 1,
    groups: int = 1,
    record_nmse: bool = True,
    partition: str = "paper",
    alpha: float = 0.1,
    scheduler: str = "full",
    sample_frac: float = 1.0,
    dropout: float = 0.0,
    channel: str = "ideal",  # any registered family: ideal | awgn | rayleigh | mimo_mac
    snr_db: float = 20.0,
    n_rx: int = 8,  # mimo_mac receive antennas
    csi_error: float = 0.0,  # mimo_mac CSI estimate error variance
    combiner: str = "lmmse",  # mimo_mac spatial combiner: lmmse | zf
    server: str = "fedadam",
    chunk: int = 0,
    impl: str = "vmap",
    obs: Any = None,  # repro_torch.obs recorder (None = the null recorder)
    stream: Optional[StreamConfig] = None,  # streamed rounds (fedqcs-ae / fedqcs-ea)
    layout: Union[str, GradientLayout] = "monolithic",  # or "per_tensor", or a layout
    encode_stream: bool = False,  # the segment-streamed client encode
    grad_accum: int = 1,  # encode_stream's microbatches a client
    device="cuda",
    params: Optional[Params] = None,
    a: Optional[torch.Tensor] = None,
) -> RunResult:
    """Runs the federated loop on the cohort engine; returns the accuracy /
    NMSE traces.  The default ``fed_cfg`` is the reference's:
    ``FedQCSConfig(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=25)``,
    i.e. the XLA-algorithm route (``use_kernels=False``: exact top-S, one
    GEMM, exact-variance GAMP on the plain loop); pass
    ``use_kernels=True, gamp_variance_mode="scalar"`` for the kernel route.
    ``params`` and ``a`` inject an initial parameter dict and sensing matrix
    (e.g. the reference's, via ``convert.from_reference``) in place of the
    port's own seeded draws.  ``channel`` with ``snr_db``, ``n_rx``,
    ``csi_error`` and ``combiner`` is the uplink (``fed/channel.py``; the
    reference's ``run_federated`` has no ``combiner`` argument and always
    combines with lmmse); only ``fedqcs-ae`` runs over a noisy one.

    ``obs`` threads into the engine: round events flow to its sink, and each
    evaluation is recorded as an ``eval`` event, so ``python -m
    repro_torch.obs summarize <run_dir>`` renders the run.  ``stream``
    runs streamed rounds, and ``layout``, ``encode_stream`` and
    ``grad_accum`` pick the block layout and the segment-streamed encode
    (:func:`mlp_engine`); none of the four is an argument of the
    reference's ``run_federated``, whose engine takes them."""
    engine, (xte, yte) = mlp_engine(
        method, k_devices=k_devices, fed_cfg=fed_cfg, lr=lr, seed=seed,
        batch_per_device=batch_per_device, groups=groups, record_nmse=record_nmse,
        partition=partition, alpha=alpha, scheduler=scheduler, sample_frac=sample_frac,
        dropout=dropout, channel=channel, snr_db=snr_db, n_rx=n_rx, csi_error=csi_error,
        combiner=combiner, server=server, chunk=chunk, impl=impl, stream=stream, obs=obs,
        layout=layout, encode_stream=encode_stream, grad_accum=grad_accum,
        device=device, params=params, a=a,
    )
    dev = engine.device
    accs, nmses, losses, round_ms = [], [], [], []
    xte_t = torch.as_tensor(xte, device=dev)
    yte_t = torch.as_tensor(yte, dtype=torch.int64, device=dev)
    t0 = time.time()
    for t in range(steps):
        r0 = time.perf_counter()
        stats = engine.run_round()  # float() of the stats synchronises
        round_ms.append(1e3 * (time.perf_counter() - r0))
        if record_nmse and "nmse" in stats:
            nmses.append(stats["nmse"])
        if t % eval_every == 0 or t == steps - 1:
            with torch.no_grad():
                acc = float(accuracy(engine.params, xte_t, yte_t))
                loss = float(mlp_loss(engine.params, xte_t, yte_t))
            accs.append(acc)
            losses.append(loss)
            engine.obs.record("eval", {"round": t, "accuracy": acc, "loss": loss})
    cfg = engine.fed_cfg
    bits = 32.0 if method == "none" else 1.0 if method == "signsgd" else cfg.bits_per_entry
    return RunResult(accs, nmses, losses, bits, time.time() - t0, round_ms, engine.last_ghat)
