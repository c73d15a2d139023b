"""Accuracy vs uplink SNR on the PyTorch port: ``examples/fed_snr_sweep.py``
on ``repro_torch``, plus ``--device`` (default ``cuda``).

Sweeps the AWGN (or Rayleigh block-fading) uplink SNR for FedQCS-AE on the
paper's MNIST MLP with a Dirichlet non-IID federation and partial
participation (uniform sampling), and prints the accuracy/NMSE ladder: the
channel's effective noise variance joins the Bussgang term in EM-GAMP's
``noise_var``, so reconstruction degrades gracefully as the uplink worsens.

    PYTHONPATH=src python examples/fed_snr_sweep_torch.py                # defaults
    PYTHONPATH=src python examples/fed_snr_sweep_torch.py --channel rayleigh \
        --clients 200 --sample-frac 0.2 --steps 60
    PYTHONPATH=src python examples/fed_snr_sweep_torch.py --device cpu --steps 2 \
        --clients 20 --snrs 10 --json-out ""
"""

import argparse
import json
import os

from repro_torch.core.compression import FedQCSConfig
from repro_torch.paper.mlp import run_federated


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--sample-frac", type=float, default=0.3)
    ap.add_argument("--channel", default="awgn", choices=["awgn", "rayleigh"])
    ap.add_argument("--snrs", default="0,5,10,20",
                    help="comma-separated SNR (dB) points; 'ideal' is always run")
    ap.add_argument("--json-out", default="runs/bench/fed_snr_sweep_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()

    fed = FedQCSConfig(reduction_ratio=3, bits=3, s_ratio=0.1,
                       gamp_iters=15, gamp_variance_mode="scalar")
    common = dict(
        steps=args.steps, fed_cfg=fed, k_devices=args.clients,
        partition="dirichlet", alpha=args.alpha,
        scheduler="uniform", sample_frac=args.sample_frac,
        eval_every=max(args.steps // 4, 1), device=args.device,
    )
    points = [("ideal", None)] + [
        (args.channel, float(s)) for s in args.snrs.split(",") if s
    ]
    print(f"FedQCS-AE, K={args.clients} Dirichlet(alpha={args.alpha}), "
          f"{args.sample_frac:.0%} sampling, {args.steps} rounds, device={args.device}")
    print(f"{'uplink':>14s} {'final acc':>9s} {'mean NMSE':>9s}")
    results = []
    for kind, snr in points:
        r = run_federated(
            "fedqcs-ae", channel=kind, snr_db=snr if snr is not None else 20.0,
            **common,
        )
        nm = sum(r.nmses) / len(r.nmses) if r.nmses else float("nan")
        label = "ideal" if kind == "ideal" else f"{kind}@{snr:g}dB"
        print(f"{label:>14s} {r.accs[-1]:9.3f} {nm:9.3f}")
        results.append({"uplink": label, "snr_db": snr, "acc": r.accs[-1],
                        "accs": r.accs, "mean_nmse": nm, "wall_s": r.wall_s})
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump({"sweep": "accuracy_vs_snr", "channel": args.channel,
                       "clients": args.clients, "alpha": args.alpha,
                       "sample_frac": args.sample_frac, "device": args.device,
                       "results": results}, f, indent=2)
        print(f"wrote {args.json_out}")


if __name__ == "__main__":
    main()
