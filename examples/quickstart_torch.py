"""Quickstart on the PyTorch port: compress a gradient dict with BQCS,
reconstruct at the PS.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py --device cuda

``examples/quickstart.py`` on ``repro_torch``: the same round -- block
sparsification (+ error feedback), random projection, Lloyd-Max
quantization, then both reconstruction strategies (estimate-and-aggregate /
aggregate-and-estimate) -- with the reference's default config (the
XLA-algorithm route: exact top-S, one GEMM, exact-variance EM-GAMP), and
prints NMSE + wire accounting.  ``--device cuda`` needs a card.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core.compression import FedQCSConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    def f32(x):
        return np.asarray(x, np.float32)

    # A fake "model gradient": any dict of tensors works.
    grads = {
        "dense/w": f32(rng.standard_t(4, (256, 128)) * 0.01),
        "dense/b": f32(rng.standard_t(4, (128,)) * 0.01),
        "head/w": f32(rng.standard_t(4, (128, 64)) * 0.01),
    }
    n_entries = sum(x.size for x in grads.values())

    cfg = FedQCSConfig(
        block_size=1024,      # N
        reduction_ratio=4,    # R = N/M
        bits=2,               # Q  -> Q/R = 0.5 bits per gradient entry
        s_ratio=0.05,         # top-5% kept per block
        gamp_iters=30,
    )
    codec = api.make_codec(cfg, device=args.device)
    print(f"protocol: N={cfg.block_size} M={cfg.m} Q={cfg.bits} "
          f"-> {cfg.bits_per_entry:.3f} bits/entry (fp32 baseline: 32) on {codec.device}")

    # --- K=4 simulated workers, each with its own noisy gradient + EF state
    k = 4
    # the noise is drawn leaf by leaf in sorted name order, as the
    # reference's jax.tree.map walks a dict, so both scripts see the same data
    workers = [{n: torch.as_tensor(grads[n] + f32(rng.normal(0, 0.002, grads[n].shape)),
                                   device=args.device) for n in sorted(grads)}
               for _ in range(k)]
    states = [api.init_state(codec, grads) for _ in range(k)]
    payloads = []
    for i in range(k):
        p, spec, states[i] = api.compress(codec, workers[i], states[i])
        payloads.append(p)
    rhos = [1.0 / k] * k
    # payload.codes IS the wire format (packed uint32 words); wire_bits is
    # derived from the actual word count, alphas included.
    bits = payloads[0].wire_bits()
    assert payloads[0].codes.dtype == torch.uint32
    print(f"wire: {bits} bits/worker/round = {bits / n_entries:.3f} bits/entry")

    truth = {n: sum(r * w[n] for r, w in zip(rhos, workers)) for n in grads}
    for mode in ("ea", "ae"):
        ghat = api.reconstruct(codec, payloads, rhos, spec, recon=api.ReconSpec(mode=mode))
        num = sum(float(torch.sum((ghat[n] - truth[n]) ** 2)) for n in grads)
        den = sum(float(torch.sum(truth[n] ** 2)) for n in grads)
        print(f"reconstruction [{mode}]: NMSE vs dense truth = {num / den:.4f}")
    print("(error feedback carries the sparsification remainder to the next round)")


if __name__ == "__main__":
    main()
