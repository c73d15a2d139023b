#!/usr/bin/env python3
"""Drives the PyTorch port's main path on one NVIDIA card and checks it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

 1. Device: the card's name and count, ``nvidia-smi``'s name and power limit,
    torch/CUDA versions, and the build of the CUDA kernels from
    ``src/repro_torch/csrc`` (timed).
 2. Each kernel against its plain PyTorch version at the main path's shapes,
    on the card, inputs from a seed: the fused encoder (300 x 1591, S=159,
    Q=3), one qgamp_step and the 25-step EA driver (300 rows), one gamp_step
    and the 25-step AE driver (10 rows).
 3. The main path: ``paper.mlp.run_federated`` for fedqcs-ae and fedqcs-ea at
    full width (K=30, N=1591, M=530, Q=3), 3 rounds each, with every launch
    count set to 0 just before each run and read just after.  Then one round
    of each from the same A and initial weights with the plain versions
    swapped in; the decoded gradients must agree to NMSE <= 1e-3.
 4. ``torch.profiler`` traces per method: a steady round's device busy time
    beside its wall time (the idle share), and the top device events.
 5. Times with CUDA events (warm-up, then many back-to-back launches queued
    behind a sleep kernel so host launch cost stays out): each kernel, its
    plain version, and where one exists the PyTorch call for the same work;
    the step kernels at 1 and 2 rows per block ([tune]).

The next-to-last lines are the kernels JSON and ``nvidia-smi``'s name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout of the repository, it exits 2 and prints
no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and fp32 outside the
# tensor cores.  A bound is the larger of bytes / rate and FLOPs / peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
K, N, M, Q, S, ITERS = 30, 1591, 530, 3, 159, 25
ROUNDS = 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nmse(x, ref) -> float:
    import torch

    return float(torch.sum((x - ref) ** 2) / torch.clamp(torch.sum(ref**2), min=1e-30))


class GpuTimer:
    """Mean device time of ``fn`` over back-to-back calls.

    A sleep kernel holds the stream while the host queues the calls, so the
    events bracket device work only.  If the host could not queue them within
    the sleep (a plain version launches hundreds of small kernels and fills
    the CUDA launch queue), the run is repeated with fewer calls."""

    def __init__(self):
        import torch

        self.torch = torch
        cycles = 20_000_000
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        s.record()
        torch.cuda._sleep(cycles)
        e.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = cycles / s.elapsed_time(e)

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        for _ in range(8):
            sleep_ms = 2.0 * reps * host_ms + 5.0
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(sleep_ms * self.cycles_per_ms))
            t0 = time.perf_counter()
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            queued_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            if queued_ms < 0.8 * sleep_ms:
                return s.elapsed_time(e) / reps
            if reps == 1:
                host_ms *= 4.0  # one call still outlasted the sleep: sleep longer
            reps = max(1, reps // 4)
        raise RuntimeError("could not queue the timed calls behind the sleep kernel")


@contextlib.contextmanager
def plain_kernels():
    """Swaps the plain PyTorch versions in for the three kernels inside the
    drivers, for comparison runs on the card (the wrappers themselves always
    launch their kernel on CUDA tensors)."""
    from repro_torch.core.compression import unpack_codes
    from repro_torch.kernels import ops, ref

    saved = (ops._encode, ops.qgamp_step, ops.gamp_step)

    def encode(blocks, residual, a_t, taus, s, m, bits):
        return ref.bqcs_encode_fused_ref(blocks, residual, a_t[:, :m], taus, s, bits)

    def qstep(ghat, nu_g, shat, theta, obs, alpha, lo, hi, a, n_components=3, em=True, bits=0):
        codes = unpack_codes(obs, bits, shat.shape[1]) if bits else obs
        return ref.qgamp_step_ref(ghat, nu_g, shat, theta, codes, alpha, lo, hi, a,
                                  n_components, em)

    def gstep(ghat, nu_g, shat, theta, y, nu_d, a, n_components=3, em=True):
        return ref.gamp_step_ref(ghat, nu_g, shat, theta, y, nu_d, a, n_components, em)

    ops._encode, ops.qgamp_step, ops.gamp_step = encode, qstep, gstep
    try:
        yield
    finally:
        ops._encode, ops.qgamp_step, ops.gamp_step = saved


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch

    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} x{torch.cuda.device_count()} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    lib = build.library()
    print(f"[build] {lib.path.name}: nvcc build {lib.build_s:.1f} s (0.0 = reused)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("[build]", line.strip())
    return name, smi


def phase_kernels(dev):
    """Each kernel vs its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch.core import bussgang
    from repro_torch.core.codebook import make_codebook
    from repro_torch.core.compression import FedQCSConfig, pack_codes, unpack_codes
    from repro_torch.core.gamp import tau_tables
    from repro_torch.core.sensing import sensing_matrix
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import qgamp_step as q_mod
    from repro_torch.kernels.bqcs_encode_fused import bqcs_encode_fused
    from repro_torch.kernels.gamp_step import gamp_step
    from repro_torch.kernels.qgamp_step import qgamp_step

    def launched(mod, since: int, want: int) -> int:
        n = mod.launches - since
        check(n == want, f"{mod.__name__}: {n} launches in this check, want {want}")
        return n

    out = {}
    cfg = FedQCSConfig(block_size=N, reduction_ratio=3, bits=Q, use_kernels=True)
    cb = make_codebook(cfg)
    taus = cb.thresholds_t(dev)
    a = sensing_matrix(cfg.seed, M, N, dev)
    a_t = ops.encoder_a_t(a, Q)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = K * 10
    blocks = (0.05 * torch.randn((rows, N), generator=gen)).to(dev)
    resid0 = (0.01 * torch.randn((rows, N), generator=gen)).to(dev)
    blocks[7] = 0.0
    resid0[7] = 0.0  # one dead row

    # -- fused encoder --------------------------------------------------------
    n0 = enc_mod.launches
    words, alpha, resid = bqcs_encode_fused(blocks, resid0, a_t, taus, S, M, Q)
    n_enc = launched(enc_mod, n0, 1)
    w_p, al_p, res_p = ref.bqcs_encode_fused_ref(blocks, resid0, a_t[:, :M], taus, S, Q)
    torch.cuda.synchronize()
    check(torch.equal(resid, res_p), "encoder resid must be bit-identical")
    rel = float(torch.max(torch.abs(alpha - al_p) / torch.clamp(torch.abs(al_p), min=1e-30)))
    check(rel <= 1e-6, f"encoder alpha rtol {rel:.3g} > 1e-6")
    codes, codes_p = unpack_codes(words, Q, M), unpack_codes(w_p, Q, M)
    diff = codes != codes_p
    sparse, _ = ref.block_topk_ref(blocks + resid0, S)
    y = (sparse * al_p[:, None]) @ a.T
    gap = torch.amin(torch.abs(y[..., None] - taus), dim=-1)
    n_diff = int(diff.sum())
    if n_diff:
        check(float(gap[diff].max()) < 1e-5, "a differing code lane is not near a threshold")
    kept = sparse != 0
    out["encode"] = dict(
        max_abs_err=float(torch.max(torch.abs(alpha - al_p))), kept=int(kept.sum()),
        a_rows=int(kept.any(dim=0).sum()), args=(blocks, resid0, a_t, taus, S, M, Q),
    )
    print(f"[encode] 300x1591 S=159 Q=3: resid bit-identical, alpha max rel err {rel:.3g}, "
          f"{n_diff} differing code lanes of {codes.numel()} (each within 1e-5 of a threshold), "
          f"dead row alpha {float(alpha[7])}; launches {n_enc}")

    lo, hi = tau_tables(taus)
    L = 3

    # -- one qgamp_step on 300 rows (state and codes from a seed) ----------------
    rng = np.random.default_rng(1)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    ghat = t(rng.normal(0, 0.1, (rows, N)))
    nug = t(rng.uniform(0.01, 0.1, (rows, N)))
    shat = t(rng.normal(0, 0.1, (rows, M)))
    theta = t(np.concatenate([np.full((rows, 1), 0.9), np.full((rows, L), 0.1 / L),
                              rng.normal(0, 0.1, (rows, L)), np.full((rows, L), 0.01)], 1))
    al2 = t(rng.uniform(0.8, 1.25, (rows, 1)))
    # codes consistent with the state (x ~ N(phat, nu_p)), as the reference's
    # kernel tests draw them
    x = al2 * (ghat @ a.T) + t(rng.normal(0, 0.1, (rows, M)))
    qcodes = torch.searchsorted(taus, x.contiguous()).to(torch.int32)
    qwords = pack_codes(qcodes, Q)
    n0 = q_mod.launches
    step_k = qgamp_step(ghat, nug, shat, theta, qwords, al2, lo, hi, a, L, True, Q)
    step_p = ref.qgamp_step_ref(ghat, nug, shat, theta, qcodes, al2, lo, hi, a, L, True)
    torch.cuda.synchronize()
    errs = []
    for name, k_, p_ in zip(("ghat", "nu_g", "shat", "theta"), step_k, step_p):
        torch.testing.assert_close(k_, p_, rtol=1e-3, atol=1e-5, msg=f"qgamp_step {name}")
        errs.append(float(torch.max(torch.abs(k_ - p_))))
    # -- the 25-step EA driver on the encoder's words (incl. the dead row) -------
    ea_k = ops.qgamp_ea_run_packed(words, alpha, a, taus, bits=Q, m=M)
    with plain_kernels():
        ea_p = ops.qgamp_ea_run_packed(words, alpha, a, taus, bits=Q, m=M)
    e_ea = nmse(ea_k, ea_p)
    check(e_ea <= 1e-4, f"EA driver NMSE {e_ea:.3g} > 1e-4")
    check(not bool(ea_k[7].any()), "dead row must decode to exactly zero")
    n_q = launched(q_mod, n0, 1 + ITERS)
    out["qgamp"] = dict(max_abs_err=max(errs),
                        args=(ghat, nug, shat, theta, qwords, al2, lo, hi, a, L, True, Q),
                        gemm=(ghat, shat, a))
    print(f"[qgamp_step] one step, 300 rows: allclose rtol 1e-3 atol 1e-5, max abs err "
          f"{max(errs):.3g}; 25-step EA driver on the encoder's words: NMSE {e_ea:.3g} "
          f"(<= 1e-4); launches {n_q}")

    # -- one gamp_step on 10 rows, then the 25-step AE driver --------------------
    nb = 10
    g10, n10, s10, th10 = ghat[:nb].contiguous(), nug[:nb].contiguous(), shat[:nb].contiguous(), \
        theta[:nb].contiguous()
    y10 = t(rng.normal(0, 1, (nb, M)))
    nud10 = t(np.full((nb, 1), 0.05))
    n0 = g_mod.launches
    step_k = gamp_step(g10, n10, s10, th10, y10, nud10, a, L, True)
    step_p = ref.gamp_step_ref(g10, n10, s10, th10, y10, nud10, a, L, True)
    torch.cuda.synchronize()
    errs = []
    for name, k_, p_ in zip(("ghat", "nu_g", "shat", "theta"), step_k, step_p):
        torch.testing.assert_close(k_, p_, rtol=2e-4, atol=1e-6, msg=f"gamp_step {name}")
        errs.append(float(torch.max(torch.abs(k_ - p_))))
    w3, a3 = words.reshape(K, 10, -1), alpha.reshape(K, 10)
    rhos = torch.full((K,), 1.0 / K, device=dev)
    y_ae = bussgang.aggregate_packed(w3, a3, rhos, cb, M)
    nu_ae = bussgang.effective_noise_var(a3, rhos, cb)
    e_ae_in = bussgang.signal_energy(a3, rhos, M, N)
    ae_k = ops.gamp_ae_run(y_ae, nu_ae, a, e_ae_in)
    with plain_kernels():
        ae_p = ops.gamp_ae_run(y_ae, nu_ae, a, e_ae_in)
    e_ae = nmse(ae_k, ae_p)
    check(e_ae <= 1e-4, f"AE driver NMSE {e_ae:.3g} > 1e-4")
    n_g = launched(g_mod, n0, 1 + ITERS)
    out["gamp"] = dict(max_abs_err=max(errs), args=(g10, n10, s10, th10, y10, nud10, a, L, True),
                       gemm=(g10, s10, a))
    print(f"[gamp_step] one step, 10 rows: allclose rtol 2e-4 atol 1e-6, max abs err "
          f"{max(errs):.3g}; 25-step AE driver on the Bussgang aggregate of the encoder's "
          f"words: NMSE {e_ae:.3g} (<= 1e-4); launches {n_g}")
    return out


def phase_main_path(dev):
    import numpy as np

    from repro_torch.kernels import bqcs_encode_fused as enc
    from repro_torch.kernels import gamp_step as gs
    from repro_torch.kernels import qgamp_step as qs
    from repro_torch.paper.mlp import run_federated

    mods = {"bqcs_encode_fused": enc, "qgamp_step": qs, "gamp_step": gs}
    launches = {k: 0 for k in mods}
    round_ms = {}
    for method, decoder in (("fedqcs-ae", "gamp_step"), ("fedqcs-ea", "qgamp_step")):
        for mod in mods.values():
            mod.launches = 0
        res = run_federated(method, steps=ROUNDS, eval_every=1, device=dev)
        counts = {k: mod.launches for k, mod in mods.items()}
        other = "qgamp_step" if decoder == "gamp_step" else "gamp_step"
        print(f"[main] {method}: nmse {[round(v, 6) for v in res.nmses]} accuracy "
              f"{[round(v, 4) for v in res.accs]} round ms {[round(v, 2) for v in res.round_ms]} "
              f"launches {counts}")
        check(all(np.isfinite(res.nmses)) and max(res.nmses) < 1.0, f"{method} nmse {res.nmses}")
        check(all(0.0 <= v <= 1.0 for v in res.accs), f"{method} accuracy {res.accs}")
        check(counts["bqcs_encode_fused"] == ROUNDS, f"{method}: 1 encode launch per round")
        check(counts[decoder] == ITERS * ROUNDS, f"{method}: {ITERS} {decoder} launches per round")
        check(counts[other] == 0, f"{method}: no {other} launches")
        for k in mods:
            launches[k] += counts[k]
        round_ms[method] = res.round_ms

    # the same round from the same A and init, kernels vs plain versions
    for method in ("fedqcs-ae", "fedqcs-ea"):
        res_k = run_federated(method, steps=1, device=dev)
        with plain_kernels():
            res_p = run_federated(method, steps=1, device=dev)
        e = nmse(res_k.last_ghat, res_p.last_ghat)
        print(f"[main] {method} round 0, kernels vs plain versions on the card: decoded "
              f"gradient NMSE {e:.3g} (<= 1e-3); nmse stat {res_k.nmses[0]:.6f} vs "
              f"{res_p.nmses[0]:.6f}")
        check(e <= 1e-3, f"{method}: kernel round vs plain round NMSE {e:.3g} > 1e-3")
    return launches, round_ms


def _device_ms(fn) -> dict:
    """Device-side events (kernels, copies) of ``fn`` from a ``torch.profiler``
    trace: name -> [count, ms]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: [e.count, e.self_device_time_total / 1e3]
            for e in prof.key_averages() if e.device_type != DeviceType.CPU}


def phase_profile(round_ms, dev):
    """Device busy time of a steady round per method, beside its unprofiled
    wall time.  ``run_federated`` with 3 steps minus 1 step is two rounds
    and one evaluation, without the set-up (data and weights to the card)
    that both calls share; halved, it is one round."""
    from repro_torch.paper.mlp import run_federated

    for method, ms in round_ms.items():
        one = _device_ms(lambda: run_federated(method, steps=1, device=dev))
        three = _device_ms(lambda: run_federated(method, steps=3, device=dev))
        per_round = {k: ((c - one.get(k, [0, 0.0])[0]) / 2, (t - one.get(k, [0, 0.0])[1]) / 2)
                     for k, (c, t) in three.items()}
        busy = sum(t for _, t in per_round.values())
        wall = sum(ms[1:]) / (len(ms) - 1)
        if busy <= 0.0:
            print(f"[profile] {method}: the trace holds no device time (not measured)")
            continue
        top = sorted(per_round.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"[profile] {method}: device busy {busy:.4f} ms per round vs round wall "
              f"{wall:.4f} ms, idle share {1.0 - busy / wall:.3f}; per round: "
              + "; ".join(f"{k[:48]} x{c:g} {t:.4f} ms" for k, (c, t) in top))


def phase_times(dev, k_in):
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bqcs_encode_fused import bqcs_encode_fused
    from repro_torch.kernels.gamp_step import gamp_step
    from repro_torch.kernels.qgamp_step import qgamp_step

    timer = GpuTimer()
    rows = K * 10
    res = {}

    blocks, resid0, a_t, taus, s, m, q = k_in["encode"]["args"]
    w = a_t.shape[1] // (32 // q)
    nbytes = 4 * (3 * rows * N + k_in["encode"]["a_rows"] * a_t.shape[1]) + 4 * rows * (w + 1)
    b_ms, b_by = bound_ms(nbytes, 2 * k_in["encode"]["kept"] * m)
    res["bqcs_encode_fused"] = dict(
        ms=timer(lambda: bqcs_encode_fused(*k_in["encode"]["args"])),
        plain_ms=timer(lambda: ref.bqcs_encode_fused_ref(blocks, resid0, a_t[:, :m], taus, s, q)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

    from repro_torch.core.compression import unpack_codes

    qa = k_in["qgamp"]["args"]
    ghat, nug, shat, theta, words, al, lo, hi, a, L, em, bits = qa
    state = 4 * rows * (2 * N + M + 1 + 3 * L)
    nbytes = 2 * state + 4 * M * N + 4 * words.numel() + 4 * rows + 8 * lo.numel()
    b_ms, b_by = bound_ms(nbytes, 4 * rows * N * M)
    g1, s1, a1 = k_in["qgamp"]["gemm"]
    res["qgamp_step"] = dict(
        ms=timer(lambda: qgamp_step(*qa)),
        plain_ms=timer(lambda: ref.qgamp_step_ref(ghat, nug, shat, theta,
                                                  unpack_codes(words, bits, M), al, lo, hi, a,
                                                  L, em)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: (torch.matmul(g1, a1.T), torch.matmul(s1, a1))),
    )

    ga = k_in["gamp"]["args"]
    nb = ga[0].shape[0]
    state = 4 * nb * (2 * N + M + 1 + 3 * 3)
    nbytes = 2 * state + 4 * M * N + 4 * nb * M + 4 * nb
    b_ms, b_by = bound_ms(nbytes, 4 * nb * N * M)
    g2, s2, a2 = k_in["gamp"]["gemm"]
    res["gamp_step"] = dict(
        ms=timer(lambda: gamp_step(*ga)),
        plain_ms=timer(lambda: ref.gamp_step_ref(*ga)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: (torch.matmul(g2, a2.T), torch.matmul(s2, a2))),
    )
    # rows of a tile sharing one pass over A: fewer rows fill more SMs, more
    # rows read A from L2 fewer times (the wrappers' qgamp_step.rows_per_cta)
    from repro_torch.kernels.qgamp_step import rows_per_cta

    for nb_, step, args in ((rows, qgamp_step, qa), (ga[0].shape[0], gamp_step, ga)):
        auto = rows_per_cta(nb_, dev)
        for r in (1, 2):
            ms = timer(lambda: step(*args, _rows=r))
            print(f"[tune] {step.__name__} {nb_} rows, {r} rows per block: {ms:.4f} ms"
                  + (" (the wrapper's choice)" if r == auto else ""))
    for name, r in res.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} (GEMMs only)"
        print(f"[time] {name}: kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | library {lib}")
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import entry_device

    dev = entry_device("cuda")
    t0 = time.perf_counter()
    name, smi = phase_device()
    k_in = phase_kernels(dev)
    launches, round_ms = phase_main_path(dev)
    phase_profile(round_ms, dev)
    times = phase_times(dev, k_in)
    for method, ms in round_ms.items():
        print(f"[round] {method}: wall ms per round {[round(v, 3) for v in ms]}, "
              f"mean of rounds 1..{ROUNDS - 1}: {sum(ms[1:]) / (len(ms) - 1):.3f}")
    meta = {
        "bqcs_encode_fused": ("cuda", "src/repro_torch/csrc/bqcs_encode_fused.cu",
                              "src/repro/kernels/bqcs_encode_fused.py:194", "encode"),
        "qgamp_step": ("cuda", "src/repro_torch/csrc/qgamp_step.cu",
                       "src/repro/kernels/qgamp_step.py:180", "qgamp"),
        "gamp_step": ("cuda", "src/repro_torch/csrc/gamp_step.cu",
                      "src/repro/kernels/gamp_step.py:108", "gamp"),
    }
    kernels = []
    for kname, (route, source, replaces, key) in meta.items():
        tm = times[kname]
        kernels.append({
            "name": kname, "route": route, "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": k_in[key]["max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
        })
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
