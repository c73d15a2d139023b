"""Training launcher, pod mode (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
        --steps 50 --fedqcs --pods 2 --device cpu

Wires together the config registry, the synthetic token data, the FedQCS
train step (``impl="auto"``: the ``--pods`` pods simulated on one device),
checkpointing with resume from the latest checkpoint, and periodic loss
logs.  The FedQCS point is the reference's: N = 255, ``--R``, ``--Q``,
``--s-ratio``, 15 scalar-variance GAMP iterations.  ``--device`` defaults to
``cuda``.  The cohort mode (``--fed-cohort``), the interleaved producer
(``--interleave``) and the production mesh raise, naming their ROADMAP.md
items.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import not_in_slice
from repro_torch import tree as tree_util
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.core.compression import FedQCSConfig
from repro_torch.data.synthetic import TokenDataset
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
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
    ap.add_argument("--fed-cohort", action="store_true",
                    help="train via the fed cohort engine (ROADMAP.md item 11)")
    ap.add_argument("--interleave", type=int, default=0, metavar="CHUNKS",
                    help="backward-interleaved client encode (ROADMAP.md item 11b)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 2x16x16 mesh (ROADMAP.md item 10b)")
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
        raise not_in_slice("the cohort mode (--fed-cohort, TokenClientData)",
                           "item 11, its cohort slice")
    if args.interleave:
        raise not_in_slice("the interleaved segment producer (--interleave)", "item 11b")
    if cfg.family == "audio":  # the reference's pod mode fails on the same missing key
        raise ValueError(f"--arch {args.arch}: the audio family trains on frame embeddings "
                         "('frames'), which the launcher's token data does not have")
    mesh = (make_production_mesh(multi_pod=args.pods > 1) if args.production_mesh
            else make_debug_mesh(args.pods, 1, 1))
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

    state = steps.init_train_state(cfg, opt, fed, 0, n_pods=args.pods, device=args.device)
    n_params = sum(int(p.numel()) for _, p in tree_util.leaves(state["params"]))
    print(f"[train] arch={cfg.name} params={n_params:,} mesh={mesh.shape} "
          f"fedqcs={'on' if fed else 'off'}"
          + (f" ({fed.bits_per_entry:.2f} bits/entry)" if fed else ""))

    ckpt = Checkpointer(args.ckpt_dir or f"runs/ckpt_{cfg.name}", keep=2)
    start = 0
    if ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
        print(f"[train] resumed from step {start}")
    step_fn = steps.make_train_step(cfg, opt, fed, mesh, device=args.device)

    t0 = time.time()
    for t in range(start, args.steps):
        state, metrics = step_fn(state, ds.get_batch(t, device=args.device))
        if t % args.log_every == 0 or t == args.steps - 1:
            print(f"step {t:5d}  loss {float(metrics['loss']):.4f}  "
                  f"({(time.time() - t0):.0f}s)")
        if args.ckpt_every and t and t % args.ckpt_every == 0:
            ckpt.save(t, state)
    ckpt.save(args.steps - 1, state)
    ckpt.wait()
    print("[train] done")


if __name__ == "__main__":
    main()
