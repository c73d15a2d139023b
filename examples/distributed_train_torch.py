"""Distributed LM training with FedQCS cross-pod gradient compression, on the
PyTorch port (the counterpart of ``examples/distributed_train.py``).

    PYTHONPATH=src python examples/distributed_train_torch.py --steps 40 --device cpu
    PYTHONPATH=src python examples/distributed_train_torch.py --arch qwen2-7b --steps 40
    PYTHONPATH=src python examples/distributed_train_torch.py --inject-failure 20

Runs the reduced config of the chosen architecture on a (pod=2, data=1,
model=1) mesh, one device a pod (the reference's pods are 2 x 2: ROADMAP.md
item 10b), both pods simulated on ``--device`` (default ``cuda``) by the
``impl="auto"`` train step, with: FedQCS compressed cross-pod reduction at
the reference's point, a checkpoint every 10 steps, optional pod-failure
injection (pod 1 leaves ``state["participating"]`` for 5 steps; the step
goes on with the surviving pod's gradient, the dead pod's residual keeping
its full carry), and exact restart: a rerun resumes from the latest
checkpoint and its parameters match the uninterrupted run's bit for bit.
The checkpoint of step t holds the state after step t, so a restart runs on
from step t + 1 (the reference's example runs step t again).  A step is
logged every 5 steps, at the last one and whenever a pod is down.
"""

import argparse

import torch

from repro_torch import entry_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import smoke_config
from repro_torch.core.compression import FedQCSConfig
from repro_torch.data.synthetic import TokenDataset
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.optim.adam import OptConfig
from repro_torch.runtime import steps


def main(argv=None):
    """Runs the example; returns the final train state."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt-dir", default="runs/example_ckpt_torch")
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="step at which pod 1 dies for 5 steps")
    ap.add_argument("--no-fedqcs", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = entry_device(args.device)
    mesh = make_debug_mesh(2, 1, 1)
    cfg = smoke_config(args.arch)
    fed = None if args.no_fedqcs else FedQCSConfig(
        block_size=255, reduction_ratio=3, bits=3, s_ratio=0.05,
        gamp_iters=15, gamp_variance_mode="scalar",
    )
    opt = OptConfig(lr=3e-3, warmup_steps=5, decay_steps=2000)
    ds = TokenDataset(cfg.vocab_size, batch=16, seq=64, seed=0)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)

    state = steps.init_train_state(cfg, opt, fed, 0, n_pods=2, device=dev)
    start = 0
    if ckpt.latest_step() is not None:
        state, done = ckpt.restore(state)
        start = done + 1
        print(f"[restore] resumed after step {done}")
    step_fn = steps.make_train_step(cfg, opt, fed, mesh, device=dev)

    if fed is not None:
        nb = state["residual"].shape[1]
        bits = nb * (fed.m * fed.bits + 32)
        print(f"[wire] compressed payload/pod/step: {bits / 8 / 1024:.0f} KiB "
              f"({fed.bits_per_entry:.2f} bits/entry; fp32 all-reduce would be "
              f"{nb * fed.block_size * 32 / 8 / 1024:.0f} KiB)")

    for t in range(start, args.steps):
        down = fed is not None and args.inject_failure >= 0 and (
            args.inject_failure <= t < args.inject_failure + 5)
        if fed is not None:
            state["participating"] = torch.tensor([1.0, 0.0 if down else 1.0], device=dev)
        state, metrics = step_fn(state, ds.get_batch(t, device=dev))
        if t % 5 == 0 or t == args.steps - 1 or down:
            note = " [pod1 DOWN]" if down else ""
            print(f"step {t:4d}  loss {float(metrics['loss']):.4f}{note}")
        if t and t % 10 == 0:
            ckpt.save(t, state)
    ckpt.wait()
    print("done; checkpoints in", args.ckpt_dir)
    return state


if __name__ == "__main__":
    main()
