"""Distributed LM training with FedQCS cross-pod gradient compression, on the
PyTorch port (the counterpart of ``examples/distributed_train.py``).

    PYTHONPATH=src python examples/distributed_train_torch.py --steps 40 --device cpu
    PYTHONPATH=src python examples/distributed_train_torch.py --arch mamba2-1.3b --steps 40
    PYTHONPATH=src python examples/distributed_train_torch.py --inject-failure 20

Runs the reduced config of the chosen architecture on the reference's
(pod=2, data=2, model=2) mesh: eight processes, one a device
(``repro_torch.launch.spawn.run_world``: gloo; ``--device cpu``, or every
rank on the card, default ``cuda``), rank 0 printing: every arch.  The
token data has neither frames nor patch embeddings: the audio arch raises
ValueError before the world starts, and the VLM's ranks raise KeyError
(``patches``) at their first step; the reference's example fails on the
same missing keys.  With: FedQCS
compressed cross-pod reduction at the reference's point, a checkpoint
every 10 steps (gathered from the ranks' shards), optional
pod-failure injection (pod 1 leaves ``state["participating"]`` for 5
steps; the step goes on with the surviving pod's gradient, the dead pod's
residual keeping its full carry), and exact restart: a rerun resumes from
the latest checkpoint and its parameters match the uninterrupted run's bit
for bit.  The checkpoint of step t holds the state after step t, so a
restart runs on from step t + 1 (the reference's example runs step t
again).  A step is logged every 5 steps, at the last one and whenever a pod
is down.  :func:`main` returns the final train state, whole, on the CPU.
"""

import argparse
import os
import sys

import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import smoke_config
from repro_torch.core.compression import FedQCSConfig
from repro_torch.data.synthetic import TokenDataset
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.spawn import run_world
from repro_torch.optim.adam import OptConfig
from repro_torch.runtime import steps

MESH = (2, 2, 2)


def main(argv=None):
    """Runs the example; returns the final train state (whole, on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default="runs/example_ckpt_torch")
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="step at which pod 1 dies for 5 steps")
    ap.add_argument("--no-fedqcs", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if smoke_config(args.arch).family == "audio":
        raise ValueError(f"--arch {args.arch}: the audio family trains on frame embeddings "
                         "('frames'), which the example's token data does not have")
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:  # the ranks import this file by its module name
        sys.path.insert(0, here)
    return run_world(_rank, MESH[0] * MESH[1] * MESH[2], args=(args,), device=args.device)[0]


def _rank(rank, world, dev, args):
    """One rank of the (2, 2, 2) world: rank 0 returns the final state."""
    return _train(args, make_debug_mesh(*MESH), dev)


def _train(args, mesh, dev):
    """The example's loop on this rank's part of the in-pod ``mesh``."""
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    cfg = smoke_config(args.arch)
    fed = None if args.no_fedqcs else FedQCSConfig(
        block_size=255, reduction_ratio=3, bits=3, s_ratio=0.05,
        gamp_iters=15, gamp_variance_mode="scalar",
    )
    opt = OptConfig(lr=3e-3, warmup_steps=5, decay_steps=2000)
    ds = TokenDataset(cfg.vocab_size, batch=16, seq=64, seed=0)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)

    state = steps.init_train_state(cfg, opt, fed, 0, n_pods=2, mesh=mesh, device=dev)
    whole, specs = steps.state_specs(cfg, opt, fed, mesh)
    start = 0
    if ckpt.latest_step() is not None:
        state, done = ckpt.restore(whole, specs=specs, mesh=mesh, device=dev)
        start = done + 1
        say(f"[restore] resumed after step {done}", flush=True)
    step_fn = steps.make_train_step(cfg, opt, fed, mesh, device=dev)

    if fed is not None:
        nb = whole["residual"].shape[1]
        bits = nb * (fed.m * fed.bits + 32)
        say(f"[wire] compressed payload/pod/step: {bits / 8 / 1024:.0f} KiB "
            f"({fed.bits_per_entry:.2f} bits/entry; fp32 all-reduce would be "
            f"{nb * fed.block_size * 32 / 8 / 1024:.0f} KiB)", flush=True)

    for t in range(start, args.steps):
        down = fed is not None and args.inject_failure >= 0 and (
            args.inject_failure <= t < args.inject_failure + 5)
        if fed is not None:
            state["participating"] = torch.tensor([1.0, 0.0 if down else 1.0], device=dev)
        state, metrics = step_fn(state, ds.get_batch(t, device=dev))
        if t % 5 == 0 or t == args.steps - 1 or down:
            note = " [pod1 DOWN]" if down else ""
            say(f"step {t:4d}  loss {float(metrics['loss']):.4f}{note}", flush=True)
        if t and t % 10 == 0:
            ckpt.save(t, state, specs=specs, mesh=mesh)
    ckpt.wait()
    say("done; checkpoints in", args.ckpt_dir, flush=True)
    state = steps.gather_state(state, specs, mesh)
    if mesh.rank != 0:
        return None
    return tree_util.tree_map(
        lambda v: type(v)(*(x.cpu() for x in v)) if isinstance(v, tuple) else v.cpu(), state)


if __name__ == "__main__":
    main()
