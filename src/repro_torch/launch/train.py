"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
        --steps 50 --fedqcs --pods 2 --device cpu

Pod mode wires together the config registry, the synthetic token data, the
FedQCS train step (``impl="auto"``), checkpointing with resume from the
latest checkpoint, and periodic loss logs.  Every arch it trains runs on
the reference's ``(pods, 2, 2)`` mesh: ``pods * 4`` processes, one per
device (``launch/spawn.py``: gloo; ``--device cpu`` or, on a card, every
rank on ``cuda:(rank % device_count)``), rank 0 printing; the dense, MoE
(with MLA and MTP), VLM, SSM and hybrid families alike;
``--int8-opt-state`` keeps int8 moments on each rank's shards.  The token
data has neither frames nor patch embeddings: the audio family raises
ValueError before the world starts, and the VLM's ranks raise KeyError
(``patches``) at their first step; the reference's pod mode fails on the
same missing keys.  The FedQCS point is
the reference's: N = 255, ``--R``, ``--Q``, ``--s-ratio``, 15
scalar-variance GAMP iterations.  ``--device`` defaults to ``cuda``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b --smoke \
        --fedqcs --pods 2 --int8-opt-state --steps 3 --device cpu

Cohort mode (``--fed-cohort``) replaces the pod collective with the
``repro_torch.fed`` engine: the registry model is trained by a simulated
federation of ``--clients`` devices (Dirichlet ``--alpha`` dialect skew over
the synthetic language, ``--sample-frac`` uniform participation,
``--dropout`` stragglers, ``--snr-db`` AWGN uplink), each client's gradient
taken one at a time:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
        --fed-cohort --clients 8 --steps 2 --device cpu

``--interleave CHUNKS`` takes the cohort's gradients through the
backward-interleaved producer (``repro_torch.models.segment_tap``): a
per-tensor layout split at CHUNKS layer chunks, each segment encoded as the
backward pass makes it (``--grad-accum M``: M microbatches a client):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
        --fed-cohort --interleave 2 --clients 8 --steps 2 --device cpu

Pod mode does not read ``--interleave`` and rejects it; the production mesh
raises, naming its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import entry_device
from repro_torch import tree as tree_util
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.core.compression import FedQCSConfig
from repro_torch.data.synthetic import TokenDataset
from repro_torch.fed.channel import ChannelConfig
from repro_torch.fed.engine import (
    CohortConfig,
    CohortEngine,
    TokenClientData,
    make_interleaved_segments,
)
from repro_torch.fed.scheduler import SchedulerConfig
from repro_torch.fed.server_opt import ServerOptConfig
from repro_torch.fed.stream import StreamConfig
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.spawn import run_world
from repro_torch.models import model as model_api
from repro_torch.models.segment_tap import interleaved_layout
from repro_torch.obs import JsonlRecorder
from repro_torch.optim.adam import OptConfig
from repro_torch.runtime import steps


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--fedqcs", action="store_true")
    ap.add_argument("--R", type=int, default=3)
    ap.add_argument("--Q", type=int, default=3)
    ap.add_argument("--s-ratio", type=float, default=0.05)
    ap.add_argument("--pods", type=int, default=2)
    # -- cohort mode (repro_torch.fed engine) ---------------------------------
    ap.add_argument("--fed-cohort", action="store_true",
                    help="train via the fed cohort engine instead of the pod step")
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="Dirichlet dialect concentration (0 = homogeneous)")
    ap.add_argument("--snr-db", type=float, default=None,
                    help="AWGN uplink SNR in dB (unset = ideal channel)")
    ap.add_argument("--sample-frac", type=float, default=1.0)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-round straggler probability")
    ap.add_argument("--stream", type=int, default=0, metavar="BATCH",
                    help="streaming PS round mode: fold arrival batches of "
                         "BATCH clients (0 = one-shot barrier)")
    ap.add_argument("--deadline", type=float, default=8.0,
                    help="streaming round deadline (latency units); late "
                         "clients carry full residuals")
    ap.add_argument("--scheduler", default=None, choices=["full", "uniform", "async"],
                    help="default: uniform when --sample-frac < 1, else full")
    ap.add_argument("--server-opt", default="fedadam", choices=["fedadam", "fedavg", "fedavgm"])
    ap.add_argument("--record", default=None, metavar="RUN_DIR",
                    help="cohort mode: record round/eval events to RUN_DIR "
                         "(render with `python -m repro_torch.obs summarize`)")
    ap.add_argument("--client-batch", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=16,
                    help="clients per pass in the vmapped cohort pass (a registry "
                         "model's clients go one at a time)")
    ap.add_argument("--interleave", type=int, default=0, metavar="CHUNKS",
                    help="cohort mode: backward-interleaved client encode over "
                         "CHUNKS layer chunks")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="interleave mode: microbatches per client pass")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 2x16x16 mesh (ROADMAP.md item 10g)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--int8-opt-state", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.fed_cohort:
        return run_fed_cohort(args, cfg)
    if args.interleave:
        raise ValueError("--interleave is the cohort mode's backward-interleaved encode: "
                         "pass --fed-cohort (pod mode does not read it)")
    if cfg.family == "audio":  # the reference's pod mode fails on the same missing key
        raise ValueError(f"--arch {args.arch}: the audio family trains on frame embeddings "
                         "('frames'), which the launcher's token data does not have")
    if args.production_mesh:
        make_production_mesh(multi_pod=args.pods > 1)  # raises: not in the slice
    # the reference's (pods, 2, 2) mesh: one process per device
    run_world(_pod_rank, args.pods * 2 * 2, args=(args,), device=args.device)


def _pod_rank(rank: int, world: int, device, args) -> None:
    """One rank of pod mode's world: the loop on its part of the (pods, 2,
    2) mesh (rank 0 prints)."""
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_debug_mesh(args.pods, 2, 2)
    fed = (
        FedQCSConfig(block_size=255, reduction_ratio=args.R, bits=args.Q,
                     s_ratio=args.s_ratio, gamp_iters=15, gamp_variance_mode="scalar")
        if args.fedqcs
        else None
    )
    opt = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                    decay_steps=max(args.steps, 100),
                    state_dtype="int8" if args.int8_opt_state else "float32")
    ds = TokenDataset(cfg.vocab_size, batch=args.batch, seq=args.seq, seed=0)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    state = steps.init_train_state(cfg, opt, fed, 0, mesh=mesh, device=device)
    whole, specs = steps.state_specs(cfg, opt, fed, mesh)
    n_params = sum(int(p.numel()) for _, p in tree_util.leaves(whole["params"]))
    say(f"[train] arch={cfg.name} params={n_params:,} mesh={mesh.shape} "
        f"fedqcs={'on' if fed else 'off'}"
        + (f" ({fed.bits_per_entry:.2f} bits/entry)" if fed else ""), flush=True)

    ckpt = Checkpointer(args.ckpt_dir or f"runs/ckpt_{cfg.name}", keep=2)
    start = 0
    if ckpt.latest_step() is not None:
        state, start = ckpt.restore(whole, specs=specs, mesh=mesh, device=device)
        say(f"[train] resumed from step {start}", flush=True)
    step_fn = steps.make_train_step(cfg, opt, fed, mesh, device=device)

    t0 = time.time()
    for t in range(start, args.steps):
        state, metrics = step_fn(state, ds.get_batch(t, device=device))
        if t % args.log_every == 0 or t == args.steps - 1:
            say(f"step {t:5d}  loss {float(metrics['loss']):.4f}  "
                f"({(time.time() - t0):.0f}s)", flush=True)
        if args.ckpt_every and t and t % args.ckpt_every == 0:
            ckpt.save(t, state, specs=specs, mesh=mesh)
    ckpt.save(args.steps - 1, state, specs=specs, mesh=mesh)
    ckpt.wait()
    say("[train] done", flush=True)


def cohort_fed(args) -> FedQCSConfig:
    """The cohort mode's FedQCS point (the reference's)."""
    return FedQCSConfig(block_size=255, reduction_ratio=args.R, bits=args.Q,
                        s_ratio=args.s_ratio, gamp_iters=15, gamp_variance_mode="scalar")


def make_fed_cohort(args, cfg, fed: Optional[FedQCSConfig] = None, params=None):
    """The cohort engine :func:`run_fed_cohort` drives, its eval loss and
    its recorder (None without ``--record``): ``fed`` replaces
    :func:`cohort_fed`'s point (e.g. with the kernel route), ``params`` a
    parameter tree on ``--device`` replaces the one drawn from seed 0."""
    missing = {"audio": "frame embeddings ('frames')", "vlm": "patch embeddings ('patches')"}
    if cfg.family in missing:  # the reference's first round fails on the same missing key
        raise ValueError(f"--arch {args.arch}: the {cfg.family} family trains on "
                         f"{missing[cfg.family]}, which the cohort's token data does not have")
    dev = entry_device(args.device)
    fed = fed or cohort_fed(args)
    if params is None:
        params = model_api.init_params(cfg, 0, dev)
    # --interleave: the per-tensor layout split at the producer's chunk
    # bounds, and the backward-interleaved producer feeding the streamed encode
    layout = grad_segments_fn = None
    if args.interleave:
        layout = interleaved_layout(cfg, fed.block_size, layer_chunks=args.interleave)
        grad_segments_fn = make_interleaved_segments(cfg, layout, grad_accum=args.grad_accum,
                                                     layer_chunks=args.interleave)
    data = TokenClientData(cfg.vocab_size, batch=args.client_batch, seq=args.seq,
                           clients=args.clients, alpha=args.alpha, device=dev)
    sched_kind = args.scheduler or ("uniform" if args.sample_frac < 1.0 else "full")
    recorder = None
    if args.record:
        recorder = JsonlRecorder(args.record, config=vars(args), extra={"arch": cfg.name})
    engine = CohortEngine(
        params,
        lambda p, b: steps.value_and_grad(p, b, cfg)[1],
        data,
        fed_cfg=fed,
        cohort=CohortConfig(method="fedqcs-ae", chunk=args.chunk,
                            encode_stream=bool(args.interleave), grad_accum=args.grad_accum),
        sched=SchedulerConfig(kind=sched_kind, sample_frac=args.sample_frac,
                              dropout_prob=args.dropout),
        chan=(ChannelConfig(kind="awgn", snr_db=args.snr_db)
              if args.snr_db is not None else ChannelConfig()),
        server=ServerOptConfig(kind=args.server_opt, lr=args.lr),
        stream=(StreamConfig(batch_clients=args.stream, deadline=args.deadline)
                if args.stream > 0 else None),
        obs=recorder,
        layout=layout,
        grad_segments_fn=grad_segments_fn,
        device=dev,
    )
    probe = TokenDataset(cfg.vocab_size, batch=16, seq=args.seq, seed=123).get_batch(0, device=dev)

    def eval_loss(p) -> float:
        with torch.no_grad():
            return float(model_api.train_loss(p, probe, cfg))

    return engine, eval_loss, recorder


def run_fed_cohort(args, cfg):
    """Registry-model training through the ``repro_torch.fed`` cohort
    engine: clients hold dialect-skewed synthetic-language streams, the
    uplink is ideal or AWGN at ``--snr-db``, and the PS applies
    ``--server-opt`` to the reconstructed aggregate (fedqcs-ae).  Runs on
    one device; the audio and VLM families raise (the token data has no
    frames or patches)."""
    engine, eval_loss, recorder = make_fed_cohort(args, cfg)
    fed = engine.fed_cfg
    if args.interleave:
        prod, layout = engine._grad_segments_fn, engine.layout
        peak = prod.peak_live_grad_bytes(args.clients)
        print(f"[fed-cohort] interleave: {len(layout.segments)} segments, "
              f"stages {prod.stage_names}, "
              f"peak live grad+enc {peak / 1e6:.1f} MB "
              f"(whole tree {args.clients * layout.nbar * 4 / 1e6:.1f} MB)")
    n_params = sum(int(p.numel()) for _, p in tree_util.leaves(engine.params))
    print(f"[fed-cohort] arch={cfg.name} params={n_params:,} "
          f"clients={args.clients} alpha={args.alpha} "
          f"sample_frac={args.sample_frac} "
          f"channel={'awgn@%gdB' % args.snr_db if args.snr_db is not None else 'ideal'} "
          f"server={args.server_opt} ({fed.bits_per_entry:.2f} bits/entry)")
    t0 = time.time()
    for t in range(args.steps):
        stats = engine.run_round()
        if t % args.log_every == 0 or t == args.steps - 1:
            loss = eval_loss(engine.params)
            engine.obs.record("eval", {"round": t, "loss": loss})
            print(f"round {t:5d}  eval-loss {loss:.4f}  "
                  f"cohort {stats['cohort']:4.0f} "
                  f"(part {stats['participating']:4.0f})  "
                  f"nmse {stats.get('nmse', float('nan')):.3f}  "
                  f"({time.time() - t0:.0f}s)")
    if recorder is not None:
        recorder.close()
        print(f"[fed-cohort] run log: {recorder.run_dir}")
    print("[fed-cohort] done")
    return engine


if __name__ == "__main__":
    main()
