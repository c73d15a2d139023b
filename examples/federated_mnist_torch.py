"""End-to-end paper reproduction (Sec. VI) on the PyTorch port:
train the 784-20-10 MLP with K=30 non-IID devices and FedQCS compression at
1 bit/entry.

    PYTHONPATH=src python examples/federated_mnist_torch.py --method fedqcs-ea --steps 300
    PYTHONPATH=src python examples/federated_mnist_torch.py --compare --device cpu
    PYTHONPATH=src python examples/federated_mnist_torch.py --channel mimo_mac --n-rx 32 \
        --csi-error 0.01 --snr-db 10 --steps 50

``examples/federated_mnist.py`` on ``repro_torch``, plus ``--device``
(default ``cuda``).  ``--method`` takes all six methods; ``--compare`` runs
the reference's rows: every method with lloyd_max, then fedqcs-ae and
fedqcs-ea with the dithered_uniform and vq codebooks.  The uplink is
``--channel`` (ideal, awgn, rayleigh, mimo_mac) with ``--snr-db``,
``--n-rx`` and ``--csi-error``; a code-domain method falls back to the
ideal uplink, as in the reference.  ``--record RUN_DIR`` writes each row's
round and eval events (``repro_torch.obs``; one run directory per row under
RUN_DIR when there are several), which ``python -m repro_torch.obs
summarize <run_dir>`` renders.

Uses real MNIST if $MNIST_DIR points at the IDX files, else the
deterministic synthMNIST surrogate.
"""

import argparse
import dataclasses

from repro_torch.core.compression import FedQCSConfig
from repro_torch.fed.channel import get_channel_family
from repro_torch.obs import JsonlRecorder
from repro_torch.paper.mlp import run_federated

METHODS = ["fedqcs-ea", "fedqcs-ae", "qcs-qiht", "qcs-dither", "signsgd", "none"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="fedqcs-ae", choices=METHODS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--R", type=int, default=3)
    ap.add_argument("--Q", type=int, default=3)
    ap.add_argument("--s-ratio", type=float, default=0.1)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--codebook", default="lloyd_max",
                    choices=["lloyd_max", "dithered_uniform", "vq"])
    ap.add_argument("--vq-dim", type=int, default=2,
                    help="vector-codebook dimension d (with --codebook vq); "
                    "wire drops to Q/d bits per measurement")
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--partition", default="paper",
                    choices=["paper", "iid", "shard", "dirichlet"])
    ap.add_argument("--alpha", type=float, default=0.1,
                    help="Dirichlet concentration (with --partition dirichlet)")
    ap.add_argument("--sample-frac", type=float, default=1.0,
                    help="cohort fraction per round (uniform sampling when < 1)")
    ap.add_argument("--snr-db", type=float, default=None,
                    help="uplink SNR in dB (unset = ideal channel)")
    ap.add_argument("--channel", default=None,
                    help="uplink family (ideal/awgn/rayleigh/mimo_mac; "
                         "default: awgn when --snr-db is set, else ideal)")
    ap.add_argument("--n-rx", type=int, default=8,
                    help="mimo_mac receive antennas")
    ap.add_argument("--csi-error", type=float, default=0.0,
                    help="mimo_mac CSI estimate error variance")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-round straggler probability")
    ap.add_argument("--chunk", type=int, default=0,
                    help="clients per client-pass chunk (0 = whole cohort in one pass)")
    ap.add_argument("--record", default=None, metavar="RUN_DIR",
                    help="record round/eval events to RUN_DIR (repro_torch.obs)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()

    fed = FedQCSConfig(reduction_ratio=args.R, bits=args.Q, s_ratio=args.s_ratio,
                       gamp_iters=25, gamp_variance_mode="scalar",
                       codebook=args.codebook, vq_dim=args.vq_dim)
    if args.compare:
        rows = [(m, "lloyd_max", args.Q) for m in METHODS[::-1]]
        rows += [("fedqcs-ae", "dithered_uniform", args.Q),
                 ("fedqcs-ea", "dithered_uniform", args.Q)]
        # vq at Q*vq_dim bits per code = the same Q bits per measurement
        vq_bits = args.Q * args.vq_dim
        m_paper = 1591 // args.R
        if vq_bits > 8:
            print(f"  (skipping vq rows: Q*d = {vq_bits} bits/code > 8)")
        elif m_paper % args.vq_dim:
            print(f"  (skipping vq rows: vq_dim={args.vq_dim} does not divide M={m_paper})")
        else:
            rows += [("fedqcs-ae", "vq", vq_bits), ("fedqcs-ea", "vq", vq_bits)]
    else:
        rows = [(args.method, args.codebook, args.Q)]
    cohort_kw = dict(
        k_devices=args.clients,
        partition=args.partition,
        alpha=args.alpha,
        scheduler="uniform" if args.sample_frac < 1.0 else "full",
        sample_frac=args.sample_frac,
        dropout=args.dropout,
        channel=args.channel or ("awgn" if args.snr_db is not None else "ideal"),
        snr_db=args.snr_db if args.snr_db is not None else 20.0,
        n_rx=args.n_rx,
        csi_error=args.csi_error,
        chunk=args.chunk,
    )
    print(f"(R,Q)=({args.R},{args.Q}) -> {fed.bits_per_entry:.2f} bits/entry "
          f"[{args.codebook}]; K={args.clients} {args.partition} devices; {args.steps} rounds; "
          f"channel={cohort_kw['channel']}; device={args.device}")
    print(f"{'method':24s} {'bits/entry':>10s} {'final acc':>9s} {'mean NMSE':>9s} {'wall':>6s}")
    for m, cbk, q in rows:
        kw = dict(cohort_kw)
        if m != "fedqcs-ae" and not get_channel_family(kw["channel"]).exact_codes:
            # code-domain methods need the exact codes at the PS: only the
            # Bussgang-linearized AE path absorbs uplink noise
            print(f"  ({m}: noisy uplink unsupported -> ideal channel)")
            kw["channel"] = "ideal"
        row_fed = dataclasses.replace(fed, codebook=cbk, bits=q, vq_dim=args.vq_dim)
        label = m if cbk == "lloyd_max" else f"{m}+{cbk}"
        recorder = None
        if args.record:
            run_dir = f"{args.record}/{label}" if len(rows) > 1 else args.record
            recorder = JsonlRecorder(
                run_dir, config={"method": m, "codebook": cbk, "Q": q, **cohort_kw})
        r = run_federated(m, steps=args.steps, fed_cfg=row_fed,
                          eval_every=max(args.steps // 10, 1), device=args.device,
                          obs=recorder, **kw)
        if recorder is not None:
            recorder.close()
        nm = sum(r.nmses) / len(r.nmses) if r.nmses else float("nan")
        print(f"{label:24s} {r.bits_per_entry:10.2f} {r.accs[-1]:9.3f} {nm:9.3f} {r.wall_s:5.0f}s")
        print(f"  acc trace: {[round(a, 3) for a in r.accs]}")
    if args.record:
        print(f"run log(s) in {args.record}: "
              f"render with `python -m repro_torch.obs summarize <run_dir>`")


if __name__ == "__main__":
    main()
