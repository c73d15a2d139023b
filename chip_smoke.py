#!/usr/bin/env python3
"""Drives the PyTorch port's paths on one NVIDIA card and checks them.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

 1. Device: the card's name and count, ``nvidia-smi``'s name and power limit,
    torch/CUDA versions, and the build of the five CUDA kernels from
    ``src/repro_torch/csrc`` (one nvcc per source, all started together;
    timed), with each kernel's registers, shared memory and spills.
 2. [kernels] Each kernel against its plain PyTorch version at the paths'
    shapes, on the card, inputs from a seed: the fused encoder's scalar,
    dither and vq branches (300 x 1591, S=159, Q=3), block_topk
    (bit-identical) and the staged bqcs_encode (and a second launch
    bit-identical), qgamp_step at the chooser's
    (rows per tile, cluster) and at cluster 1 and the 25-step EA driver (300
    rows), gamp_step at the same two shapes and the 25-step AE driver (10
    rows), and gamp_step's two shapes at 300 rows (the vq EA decode's); both
    step kernels at 64 rows (a chunk of [routes]' chunked EA decode);
    gamp_step at 30 and 100 rows (the AE decode in 3 and 10 groups) and the
    fused encoder at 10 rows (one client of the loop oracle: bit-identical
    to the 300-row launch's first 10 rows); qgamp_step at 80 rows (one fold
    of [stream]'s EA decode); at [layout]'s shapes, the fused encoder at 390
    rows and at 30 rows (S = 159, and a bias segment's s = 79; the 30-row
    launch at S = 159 bit-identical to the 390-row launch's first rows),
    qgamp_step at 390 rows (a partial last tile) with the 25-step EA driver,
    at 30 and at 104 rows, gamp_step at 13 rows with the 25-step AE driver.
 3. [staged] The staged encode path of ``kernels/ops.py``
    (``block_sparsify`` -> ``bqcs_encode`` -> ``pack_codes``) with its launch
    counts set to 0 just before and read just after, held against the
    fused encoder's wire from the same input.
 4. [main] ``paper.mlp.run_federated`` at full width (K=30, N=1591, M=530,
    Q=3) for fedqcs-ae and fedqcs-ea with the lloyd_max codebook (3
    rounds), the dithered_uniform and vq codebooks (2 rounds each), and one
    lloyd_max EA round with exact-variance GAMP; every launch count is set
    to 0 just before each run and read just after, and checked per round.
    Then one round of each configuration from the same A and initial
    weights with the plain versions swapped in; the decoded gradients must
    agree to NMSE <= 1e-3.
 4b. [prng] The reference's threefry draws (``repro_torch.prng``; every
    phase draws through it): (a) PRNG_GOLDEN -- jax.random's known answers,
    keys and first words, held against JAX by tests/test_torch_prng.py --
    drawn on the card, exactly; (b) the card against the CPU, bit for bit:
    random_bits, uniform, randint and bernoulli over 2**26 elements each,
    split and fold_in of 2**16 keys, permutation(1591), choice(1591, 530),
    and the normal, exponential and Gumbel transforms on all 2**23 inputs
    (differing count and largest ulp gap printed, both bound to 0); (c)
    ``run_federated(seed=0)`` with the default draws, one round each of
    fedqcs-ae and fedqcs-ea (lloyd_max, kernel route) and qcs-dither, on
    the card and on the CPU: A bit-identical, round 0's wire under
    ``wire_vs_cpu``'s contract (QCS-Dither: its signs, rows and dither draws
    bit-identical, the decoded aggregate to NMSE <= 1e-3), launch counts
    checked; (d) the device times of random_bits and normal at 2**28
    elements and of one cohort client's AWGN draw (2,337,477 x 85 normals),
    and ``init_params(qwen3-0.6b, 0, "cuda")`` at full width (wall, peak
    memory), each beside ``nvidia-smi``'s name and power limit.
 5. [routes] The reference's default config (``run_federated`` with no
    ``fed_cfg``: the XLA-algorithm route, exact-variance GAMP) for
    fedqcs-ae and fedqcs-ea (2 rounds each, every launch count 0), round 0
    of each against the same round run on the CPU (differing wire lanes
    only within 1e-5 of a threshold, decoded gradient NMSE <= 1e-3); one EA
    round with ``sparsifier="bisect"``; the chunked EA decode on the kernel
    route (lloyd_max and vq, ``recon_chunk=64``: 5 chunks, 125 step launches
    a round) against ``recon_chunk=0`` (NMSE <= 1e-4) and against the plain
    versions (NMSE <= 1e-3); early stop (bit-identical to the fixed trip
    count) and the two-phase sweep (NMSE <= 1e-6 of its composition) on the
    default EA round's payload.
 6. [baselines] ``run_federated`` at full width for qcs-qiht on the kernel
    route and on the default config, and qcs-dither, signsgd and none on
    the default config (2 rounds each): launch counts (the fused encoder
    once a QIHT kernel-route round, every other count 0), and round 0
    against the same round on the CPU (the same A, weights and draws): QIHT
    wire lanes differ only within 1e-5 of a threshold, the decoded
    aggregate to NMSE <= 1e-3, QIHT's flipped support entries printed.
 7. [channels] fedqcs-ae with lloyd_max on the kernel route over awgn 20 dB,
    rayleigh 20 dB (outages printed, the scheduler's un-stamp checked),
    mimo_mac lmmse (n_rx=8) and mimo_mac zf (n_rx=32, csi_error=0.01), 2
    rounds each: 25 gamp_step launches a round, nu_quant / nu_channel /
    nmse per round, round 0 against the plain versions with the same draws
    (NMSE <= 1e-3), each round's nmse within 1e-3 (relative) of the same
    run on the CPU (the reference's draws; its own mimo_mac runs pass nmse
    1 at round 1); fedqcs-ea and qcs-dither over awgn raise ValueError.
 8. [knobs] fedqcs-ae with lloyd_max on the kernel route: the AE decode in
    G = 3 and G = 10 groups (2 rounds each, 25 gamp_step launches a round
    on 30 and 100 rows; round 0 against the plain versions, NMSE <= 1e-3);
    ``impl="loop"`` against ``impl="vmap"`` from the same seed (30 encoder
    launches of 10 rows a round against 1 of 300; round 0's wire words and
    the parameters after 2 rounds bit-identical); the SNR sweep's scenario
    (K = 100, dirichlet alpha 0.1, uniform 30%, dropout 0.25, awgn 10 dB,
    fedavgm, chunk 10: cohort, finite stats, launches, and the chunked
    gradients against one pass, reported).
 9. [stream] Streamed rounds (``StreamConfig(batch_clients=8,
    buffer_batches=2, fanout=2, deadline=1e9)``) on the kernel route, 2
    each: AE (25 gamp_step launches at 10 rows a round) and EA (4 folds of
    25 qgamp_step launches at 80 rows, the last fold with 20 padded rows)
    against the barrier round of an engine in the same state (decoded
    aggregate NMSE <= 1e-8, parameters within 1e-5) and round 0 against the
    plain versions (NMSE <= 1e-3); a blackout round (every client past the
    deadline: zero update, residuals == gradients bit for bit, nobody
    stamped); awgn 20 dB batched by 8 against by 30 (NMSE <= 1e-8); and
    mimo_mac lmmse (n_rx = 8).  Wall, launches, live statistics bytes and
    buffer occupancy printed.
 10. [layout] The MLP's per-tensor layout (b1, b2, w1, w2: 1, 1, 10 and
    1 block rows, 13 a client) through ``run_federated`` on the kernel route,
    2 rounds each: EA and AE one-pass rounds (the encoder at 390 rows,
    qgamp_step at 390, gamp_step at 13), ``encode_stream`` EA (encoder
    launches of 30, 30, 300 and 30 rows; round 0's wire and the residuals
    and parameters after 2 rounds bit-identical to the one-pass run),
    per-segment budgets (s = 79 on the biases), ``grad_accum=2`` with batch
    2 a client, streamed AE and EA rounds (EA folds of 8 x 13 = 104 rows,
    NMSE <= 1e-8 to the barrier round); each round 0 against the plain
    versions (NMSE <= 1e-3); ``api.reconstruct(emit=)`` on a round's
    payload (4 segments: qgamp_step at 30 and 300 rows; NMSE <= 1e-4 to the
    whole-grid decode); the default route's streamed vs one-pass wire
    (differing lanes counted, each near a threshold).
 11. [record] ``run_federated(obs=JsonlRecorder(dir))``, 3 rounds each of
    fedqcs-ae and fedqcs-ea (a temporary directory): the run directory
    validates, the stats and decoded aggregate equal an unrecorded run's,
    and each round's ``phase_ms`` (uplink, client_pass, decode, apply; each
    phase ends in a device sync) and ``round_ms`` are printed with the
    reader's summary; each phase's device busy time from a traced run
    with the phases as profiler ranges; then a streamed AE engine under an
    ``InMemoryRecorder`` (phases uplink, client_pass, fold, apply).
 12. [profile] One ``torch.profiler`` trace of 3 rounds per configuration of
    [main], [routes], [baselines], [channels], [knobs], [stream] and
    [layout]: each
    round's device busy time (the device events that start inside its
    ``run_round``), the steady rounds' mean beside their unprofiled wall
    time (the idle share), and the top device events.
 13. [train] The pod-level FedQCS train step (``runtime/steps.py``) on
    Qwen3-0.6B as published (28 layers, d_model 1024, vocab 151,936, bf16;
    2 pods x 2,337,792 block rows of N = 255, M = 85, Q = 3, S = 12):
    (a) two full-width ``impl="auto"`` steps each of AE and EA in one
    ``torch.profiler`` trace (loss, wall, device busy, launches: the
    encoder twice, then 15 gamp_step or qgamp_step; peak device memory),
    one more step untraced, the loss finite and the parameters moved;
    each kernel on a 65,536-row slice of a real step's blocks against its
    plain version and both 15-step drivers (NMSE <= 1e-4); [time] at the
    step's shapes.  At 2 layers and full width: (b) ``impl="shard_map"``
    at world size 1 over NCCL (gather_codes AE and EA, psum_dequant AE)
    against ``impl="auto"`` at one pod, ``auto_sharded`` against ``auto``,
    the baseline; (c) the decoded aggregate of a real step's blocks on the
    kernel route against the plain versions (AE and EA, NMSE <= 1e-3);
    (d) a checkpoint saved, restored and replayed 2 steps bit for bit.
    (e) The same step on Mamba2-1.3B at every published width, 2 of 48
    layers: (a)'s steps, then the decoded
    aggregate of a real step's blocks against the plain versions (AE and
    EA, NMSE <= 1e-3, residuals bit-identical) and [time] of the three
    kernels at its rows.
 14. [cohort] The launcher's cohort mode (``launch/train.py::
    make_fed_cohort``: ``TokenClientData``, the cohort engine over the
    model's nested bf16 tree, one client's gradient at a time, fedqcs-ae at
    [train]'s FedQCS point, FedAdam) on the kernel route: (a) Qwen3-0.6B
    as published, 8 clients of which 4 are sampled a round (2 x 64 tokens
    each), 2 rounds (the encoder once over the 4 x 2,337,451 rows, then 15
    gamp_step launches over 2,337,451 rows, checked a round): wall, device
    busy and idle share (round 1 traced), peak, eval loss, wire bytes;
    round 0's aggregate against the plain versions' decode of its payload
    (NMSE <= 1e-3); [time] of both kernels at those shapes.  (b) The
    reference's three cohort archs at their smoke configs, one round each
    (and Qwen3-0.6B's with ``--stream 2``, ``--snr-db 10``, ``--server-opt
    fedavgm``, and the interleaved producer: ``--interleave 2`` on
    Qwen3-0.6B's and Mamba2-1.3B's, ``--interleave 1`` on Zamba2-2.7B's)
    on the card against the CPU: aggregate NMSE <= 1e-3, parameters within
    2 lr, residuals 1e-5.  (c) ``examples/distributed_train_torch.py`` (12
    smoke steps, pod 1 down at steps 3-7) restarted after its step-10
    checkpoint, bit for bit.  (d) (a)'s run with ``--interleave 4``: the
    backward-interleaved producer (``models/segment_tap.py``) over the
    per-tensor layout split at 4 layer chunks (46 segments, 2,337,477 rows
    a client; one encoder launch a segment, 46 a round, then 15 gamp_step
    launches, checked a round), (a)'s card-drawn parameters; round 0's
    wall, each phase's, the client pass's peak above its start beside the
    producer's ``peak_live_grad_bytes`` and (a)'s one-pass peak, the
    round's peak; round 1 traced; round 0's wire bit-identical to the
    one-pass encode of the producer's ``grads_fn`` tree, that tree against
    the per-client ``steps.value_and_grad`` trees (bf16, each entry within
    1e-2 of itself and 1e-2 of the leaf's largest), round 0's aggregate
    against the plain versions (NMSE <= 1e-3); [time] of the encoder on
    the largest segment's 4 x 610,128 rows.
 15. [serve] The serve path (``runtime/steps.py``: ``make_prefill_step``,
    ``make_decode_step``) and the rest of the transformer family: MLA's
    absorbed decode against its decompressed train attention (one
    DeepSeek-V3 layer at full width, fp32, rtol 2e-3 / atol 2e-4);
    Qwen2-VL-7B's prefill logits against sequential decode (full width, 4
    layers, fp32, a text-only prompt, rtol/atol 2e-2); one Qwen3-MoE layer
    at full width in fp32 on 64 tokens against a per-token loop over each
    token's kept experts (drops included), zeroed experts giving exactly 0;
    ``card_params``' rule against ``init_params`` for every leaf of the six
    served archs (on the CPU); the MoE, MLA (+MTP), VLM, SSM, hybrid and
    audio smoke configs in fp32 on the card against the CPU (loss,
    gradients, prefill logits and cache, 8 decode steps) and one
    ``impl="auto"`` FedQCS step of each, AE and EA, on the kernel route
    against the plain versions (its launches counted in the JSON line).
    Then Qwen3-MoE-235B-A22B (2 of 94 layers; prefill 4 x 2048), DeepSeek-V3
    (1 dense + 1 MoE layer and the MTP block; prefill 2 x 1024, the latent
    cache), Qwen2-VL-7B (28 layers; prefill 2 x 2048: 512 patch and 1536
    text positions), Mamba2-1.3B (48 layers; prefill 4 x 2048),
    Zamba2-2.7B (54 layers; prefill 2 x 2048) and Whisper-base (6 + 6
    layers; prefill 4 x 1500 frames) at every published width, bf16
    weights drawn on the card, each followed by 64 greedy tokens through
    ``donate=True`` decode steps (the first checked per cache kind: an
    attention cache changes slot ``pos`` and no other, bit for bit, the
    cross K/V not at all, the Mamba states by one plain recurrence step):
    weight bytes, prefill ms, decode ms a token (median of 64) and
    tokens/s, peak memory, the bounds, the dropped MoE pairs at the
    prefill's capacity, and the prefill and 8 decode steps under
    ``torch.profiler`` (device busy, idle share).
 16. [inpod] The train step on the reference's (2, 2, 2) mesh
    (``launch/mesh.py``, ``models/sharding.py``, ``runtime/steps.py``'s
    in-pod program): eight gloo ranks, one process a device, all on the
    one card (``launch/spawn.py``; their collectives on host copies).
    Every model at full width and the [train] point.  Qwen3-0.6B: one
    ``auto_sharded`` AE step at INPOD_SHARDED_LAYERS layers against the
    same 8-rank program with the plain versions (aggregate NMSE <= 1e-3),
    one ``auto`` AE and one ``auto`` EA step at INPOD_LAYERS layers.
    Mamba2-1.3B (INPOD_SSM_LAYERS of 48 layers) and Zamba2-2.7B (6 of 54:
    one group and its shared block): one ``auto`` AE step each; Mamba2-1.3B: one
    ``auto`` EA step with int8 Adam states, every rank's QLeafs after one
    more Adam update on its shards the shards of the update on the whole
    leaves, bit for bit.  Whisper-base at full width and depth (6 + 6
    layers, its 51,865-row tied embedding held whole over ``model``; 1,500
    frames beside 64 text tokens): one ``auto`` AE and one ``auto`` EA
    step.  Qwen3-MoE-235B-A22B, DeepSeek-V3 (MLA, MoE, MTP) and Qwen2-VL-7B
    at their smoke configs (fp32; their full widths do not fit eight ranks
    on one card): one ``auto`` AE step each, which checks the program and
    is neither timed nor counted in the JSON.  The ``auto`` steps: the
    world's gradient rows against one process's (within INPOD_BF16_FLOORS
    x one process's own bf16-to-fp32 NMSE; INPOD_FP32_ROWS for an fp32
    model) and the world's exchange and decode of one process's rows
    against one process's aggregate (NMSE <= 1e-3).  Each step: the loss
    against one process's (1e-3 relative), each rank's launches (1
    encoder, 15 step kernel), rank 0's wall, each rank's peak and the
    card's memory in use.  [time] of the three kernels alone at a rank's
    rows: Qwen3-0.6B's full-depth mesh (584,448), and each full-width
    family model's at its depth (Zamba2-2.7B runs AE only: no
    ``qgamp_step``).  Then the serve steps on the same world (the in-pod
    ``make_prefill_step`` / ``make_decode_step``: prefill over (pod, data)
    with heads over ``model``, split-KV decode over ``model``):
    Qwen3-0.6B at full width and depth, bf16, seed 0's weights, a prompt
    of 8 x 2048 into 2112 slots (1056 a ``model`` rank), 32 donated
    decode steps teacher-forced with one process's greedy tokens; before
    the world one process runs the same on the card in bf16 and its fp32
    cast.  The world's prefill logits, decode logits and each rank's cache
    shard against one process's: NMSE within INPOD_BF16_FLOORS x one
    process's own bf16-to-fp32 NMSE of each; its greedy tokens (every
    rank of a row alike) equal to one process's but at a near tie (the
    margin within INPOD_BF16_FLOORS x that row's bf16-to-fp32 gap); rank
    0's prefill wall and decode ms a token, each rank's peak, the card's
    memory in use.  The dense, MoE, MLA and VLM smoke configs (fp32, 8 x
    6 into 16 slots, 5 steps from slot 6: ``model`` rank 0's slots, then
    rank 1's) against one process, max abs within 1e-4.
 17. [time] Times with CUDA events (warm-up, then many back-to-back launches
    queued behind a sleep kernel so host launch cost stays out): each kernel,
    its plain version, and where one exists the PyTorch call for the same
    work; the default route's encode (no kernel) beside the fused
    encoder's, for the record.  [tune]: the staged bqcs_encode (300 rows)
    at every cluster size, each held against the plain version first;
    qgamp_step at 30, 64, 80, 104, 300 and 390 rows and gamp_step at 10,
    13, 30, 64, 100 and 300 rows at every (rows per tile, cluster), each
    held against the plain step
    first, and at the chooser's pick without the EM refresh.  The
    chooser's pick is marked.

``python3 chip_smoke.py --levels 4,5,6,7`` runs phases 1-2 and then the
[levels] sweep of the bisection's pass size (``phase_levels``), and stops.
``python3 chip_smoke.py --inpod`` runs the build and [inpod] alone, and
stops.  ``python3 chip_smoke.py --inpod-wide`` runs the build and
[inpod-wide] (``phase_inpod_wide``): INPOD_WIDE's model at full width on
[inpod]'s eight ranks, one ``auto`` AE step with int8, then fp32, Adam
moments, and each rank's peak or where one ran out of device memory; and
stops.
``python3 chip_smoke.py --against DIR`` runs phases 1-2 and then
[against] (``phase_against``): the kernels this tree shares with the
checkout at DIR, through this tree's wrappers with DIR's kernel library and
with this one's, held bit for bit and timed in turns, and stops.

The next-to-last lines are the kernels JSON and ``nvidia-smi``'s name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout of the repository, it exits 2 and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
BF16_FLOPS_PER_S = 989e12  # dense, on the tensor cores ([serve]'s bf16 GEMMs)
K, N, M, Q, S, ITERS = 30, 1591, 530, 3, 159, 25
CHUNK_ROWS = 64  # [routes]' recon_chunk: 300 EA rows -> 5 chunks, the last with 20 dead rows
# [stream]'s StreamConfig: 8-client batches (K = 30 -> 3 full batches and one
# of 6 padded to 8), a 2-batch ingest buffer, fanout 2, a deadline no client
# misses; an EA fold decodes 8 x 10 = 80 rows
STREAM = dict(batch_clients=8, buffer_batches=2, fanout=2, deadline=1e9)
FOLD_ROWS = STREAM["batch_clients"] * 10
STREAM_BATCHES = -(-K // STREAM["batch_clients"])
# [layout]: the MLP's per-tensor layout at N = 1591 -- b1 (20), b2 (10), w1
# (15,680), w2 (200) in sorted order, 1, 1, 10 and 1 block rows: 13 a client,
# 390 a cohort; a 0.05 budget on the biases keeps s = 79 of their 1591
LAYOUT_SEG_ROWS = (1, 1, 10, 1)
LAYOUT_ROWS = K * sum(LAYOUT_SEG_ROWS)
BIAS_S = 79

# The main-path runs: (method, codebook, GAMP variance mode, rounds, the
# launches per round of each kernel module).  The dithered EA decode and the
# exact-variance decode run the reference's GAMP loop as plain PyTorch (no
# step kernel); the vq EA decode runs gamp_step over all K x 10 rows.
MAIN_RUNS = (
    ("fedqcs-ae", "lloyd_max", "scalar", 3, dict(encode=1, gamp=ITERS, qgamp=0)),
    ("fedqcs-ea", "lloyd_max", "scalar", 3, dict(encode=1, gamp=0, qgamp=ITERS)),
    ("fedqcs-ae", "dithered_uniform", "scalar", 2, dict(encode=1, gamp=ITERS, qgamp=0)),
    ("fedqcs-ea", "dithered_uniform", "scalar", 2, dict(encode=1, gamp=0, qgamp=0)),
    ("fedqcs-ae", "vq", "scalar", 2, dict(encode=1, gamp=ITERS, qgamp=0)),
    ("fedqcs-ea", "vq", "scalar", 2, dict(encode=1, gamp=ITERS, qgamp=0)),
    ("fedqcs-ea", "lloyd_max", "exact", 1, dict(encode=1, gamp=0, qgamp=0)),
)


def fed_cfg(codebook: str = "lloyd_max", variance: str = "scalar"):
    """The paper's experiment config (``run_federated``'s default) with the
    codebook family and GAMP variance mode swapped."""
    from repro_torch.core.compression import FedQCSConfig

    return FedQCSConfig(reduction_ratio=3, bits=Q, s_ratio=0.1, gamp_iters=ITERS,
                        use_kernels=True, gamp_variance_mode=variance, codebook=codebook)


def run_label(method: str, codebook: str, variance: str) -> str:
    return f"{method} {codebook}" + ("" if variance == "scalar" else f" {variance}-variance")


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

    def direct(self, fn, reps: int = 1, warmup: int = 1) -> float:
        """Mean device time of ``fn`` between two events, with no sleep in
        front: for a call whose launches fill the CUDA launch queue (so it
        cannot be queued behind the sleep) and whose kernels are long enough
        that the device never waits for the host."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps


@contextlib.contextmanager
def plain_kernels():
    """Swaps the plain PyTorch versions in for the kernels inside the drivers
    of ``kernels/ops.py``, for comparison runs on the card (the wrappers
    themselves always launch their kernel on CUDA tensors)."""
    from repro_torch.core.compression import unpack_codes
    from repro_torch.kernels import ops, ref

    saved = (ops._encode, ops.qgamp_step, ops.gamp_step, ops._topk, ops._staged_encode)

    def encode(blocks, residual, a_t, tab, s, m, bits, dither=None, half_norms=None):
        if tab.dim() == 2:
            return ref.bqcs_encode_fused_ref(blocks, residual, a_t, None, s, bits,
                                             centroids=tab, half_norms=half_norms)
        return ref.bqcs_encode_fused_ref(blocks, residual, a_t[:, :m], tab, s, bits,
                                         dither=None if dither is None else dither[:m])

    def qstep(ghat, nu_g, shat, theta, obs, alpha, lo, hi, a, n_components=3, em=True, bits=0):
        codes = unpack_codes(obs, bits, shat.shape[1]) if bits else obs
        return ref.qgamp_step_ref(ghat, nu_g, shat, theta, codes, alpha, lo, hi, a,
                                  n_components, em)

    def gstep(ghat, nu_g, shat, theta, y, nu_d, a, n_components=3, em=True):
        return ref.gamp_step_ref(ghat, nu_g, shat, theta, y, nu_d, a, n_components, em)

    ops._encode, ops.qgamp_step, ops.gamp_step = encode, qstep, gstep
    ops._topk, ops._staged_encode = ref.block_topk_ref, ref.bqcs_encode_ref
    try:
        yield
    finally:
        ops._encode, ops.qgamp_step, ops.gamp_step, ops._topk, ops._staged_encode = saved


def kernel_modules():
    """name -> the wrapper module whose ``launches`` counts that kernel."""
    from repro_torch.kernels import block_topk, bqcs_encode, bqcs_encode_fused, gamp_step
    from repro_torch.kernels import qgamp_step

    return {"encode": bqcs_encode_fused, "qgamp": qgamp_step, "gamp": gamp_step,
            "topk": block_topk, "staged": bqcs_encode}


def zero_counts() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_counts() -> dict:
    return {k: mod.launches for k, mod in kernel_modules().items()}


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
    for line in ptxas_lines(lib.log):
        print("[build]", line)
    return name, smi


def ptxas_lines(log: str) -> list:
    """One line per kernel from nvcc's ``-Xptxas -v`` output: source, kernel
    (template argument in brackets), registers and shared memory, spills."""
    import re

    out, src, kernel, spill = [], "", "", ""
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:]
        elif "Compiling entry function" in line:
            m = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)E)?", line)
            kernel = (m[1] + (f"<{m[2]}>" if m[2] else "")) if m else line.strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{src} {kernel}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def step_vs_plain(kind: str, args, dev, shapes=None):
    """One GAMP step kernel (``kind`` "gamp" or "qgamp") at each (rows per
    tile, cluster) of ``shapes`` against its plain step on the same inputs:
    allclose rtol 2e-4 / atol 1e-6 for gamp_step, rtol 1e-3 / atol 1e-5 for
    qgamp_step (the tests' tolerances).  By default the chooser's pick and
    the same rows at cluster 1 (the whole-row form).  Returns (max abs err
    per output over all shapes, the shapes run)."""
    import torch

    from repro_torch.core.compression import unpack_codes
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.kernels import qgamp_step as q_mod
    from repro_torch.kernels import ref

    if kind == "qgamp":
        ghat, nug, shat, theta, obs, alpha, lo, hi, a, L, em, bits = args
        codes = unpack_codes(obs, bits, shat.shape[1]) if bits else obs
        want = ref.qgamp_step_ref(ghat, nug, shat, theta, codes, alpha, lo, hi, a, L, em)
        step, launch_shape, rtol, atol = q_mod.qgamp_step, q_mod.launch_shape, 1e-3, 1e-5
    else:
        want = ref.gamp_step_ref(*args)
        step, launch_shape, rtol, atol = g_mod.gamp_step, g_mod.launch_shape, 2e-4, 1e-6
    if shapes is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rows, cluster = launch_shape(args[0].shape[0], sms)
        shapes = [(rows, cluster)] + ([(rows, 1)] if cluster > 1 else [])
    errs = [0.0] * 4
    for rows, cluster in shapes:
        got = step(*args, _rows=rows, _cluster=cluster)
        torch.cuda.synchronize()
        for i, (name, k_, p_) in enumerate(zip(("ghat", "nu_g", "shat", "theta"), got, want)):
            torch.testing.assert_close(
                k_, p_, rtol=rtol, atol=atol,
                msg=f"{kind}_step {args[0].shape[0]} rows at {rows} rows per tile, cluster "
                    f"{cluster}: {name}")
            errs[i] = max(errs[i], float(torch.max(torch.abs(k_ - p_))))
    return errs, shapes


def staged_vs_plain(x, a_tt, taus, cluster=None):
    """The staged bqcs_encode at ``cluster`` blocks a tile (default: the
    chooser's pick) against its plain version: alpha to 1e-6 relative, a
    differing code only on a lane within 1e-5 of a threshold, and a second
    launch bit-identical (no atomics).  Returns (alpha max rel err, alpha max
    abs err, differing code lanes)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bqcs_encode import bqcs_encode

    codes, alpha = bqcs_encode(x, a_tt, taus, _cluster=cluster)
    codes2, alpha2 = bqcs_encode(x, a_tt, taus, _cluster=cluster)
    codes_p, alpha_p = ref.bqcs_encode_ref(x, a_tt, taus)
    torch.cuda.synchronize()
    shape = f"cluster {cluster}" if cluster else "the chooser's pick"
    check(torch.equal(codes, codes2) and torch.equal(alpha, alpha2),
          f"bqcs_encode at {shape}: a second launch must give the same bits")
    rel = float(torch.max(torch.abs(alpha - alpha_p) / torch.clamp(torch.abs(alpha_p), min=1e-30)))
    check(rel <= 1e-6, f"bqcs_encode at {shape}: alpha rtol {rel:.3g} > 1e-6")
    diff = codes != codes_p
    gap = torch.amin(torch.abs(((x * alpha_p[:, None]) @ a_tt)[..., None] - taus), dim=-1)
    n_diff = int(diff.sum())
    if n_diff:
        check(float(gap[diff].max()) < 1e-5, f"bqcs_encode at {shape}: a differing code lane "
              "is not near a threshold")
    return rel, float(torch.max(torch.abs(alpha - alpha_p))), n_diff


def qgamp_inputs(rows: int, seed: int, a, taus, dev):
    """One qgamp_step's arguments at ``rows`` rows, drawn from a seed: a GAMP
    state and Q = 3 packed codes consistent with it (x ~ N(phat, nu_p)), as
    the reference's kernel tests draw them.  Returns (the generator, so
    callers draw on from it, the arguments)."""
    import numpy as np
    import torch

    from repro_torch.core.compression import pack_codes
    from repro_torch.core.gamp import tau_tables

    L = 3
    lo, hi = tau_tables(taus)
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    ghat = t(rng.normal(0, 0.1, (rows, N)))
    nug = t(rng.uniform(0.01, 0.1, (rows, N)))
    shat = t(rng.normal(0, 0.1, (rows, M)))
    theta = t(np.concatenate([np.full((rows, 1), 0.9), np.full((rows, L), 0.1 / L),
                              rng.normal(0, 0.1, (rows, L)), np.full((rows, L), 0.01)], 1))
    al2 = t(rng.uniform(0.8, 1.25, (rows, 1)))
    x = al2 * (ghat @ a.T) + t(rng.normal(0, 0.1, (rows, M)))
    qwords = pack_codes(torch.searchsorted(taus, x.contiguous()).to(torch.int32), Q)
    return rng, (ghat, nug, shat, theta, qwords, al2, lo, hi, a, L, True, Q)


def phase_kernels(dev):
    """Each kernel vs its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch.core import bussgang
    from repro_torch.core.codebook import make_codebook
    from repro_torch.core.compression import packed_width, unpack_codes
    from repro_torch.core.gamp import GampConfig, qem_gamp_packed, tau_tables
    from repro_torch.core.sensing import sensing_matrix
    from repro_torch.kernels import block_topk as t_mod
    from repro_torch.kernels import bqcs_encode as s_mod
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import qgamp_step as q_mod
    from repro_torch.kernels.block_topk import block_topk
    from repro_torch.kernels.bqcs_encode_fused import bqcs_encode_fused

    def launched(mod, since: int, want: int) -> int:
        n = mod.launches - since
        check(n == want, f"{mod.__name__}: {n} launches in this check, want {want}")
        return n

    out = {}
    a = sensing_matrix(fed_cfg().seed, M, N, dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = K * 10
    blocks = (0.05 * torch.randn((rows, N), generator=gen)).to(dev)
    resid0 = (0.01 * torch.randn((rows, N), generator=gen)).to(dev)
    blocks[7] = 0.0
    resid0[7] = 0.0  # one dead row

    # -- fused encoder, one branch per codebook family ---------------------------
    enc_out = {}
    sparse, _ = ref.block_topk_ref(blocks + resid0, S)
    kept = sparse != 0
    for key, family in (("encode", "lloyd_max"), ("encode_dither", "dithered_uniform"),
                        ("encode_vq", "vq")):
        cb = make_codebook(dataclasses.replace(fed_cfg(family), block_size=N))
        a_t = ops.encoder_a_t(a, cb)
        tab = ops.encoder_tables(cb, M, dev)
        kw = dict(dither=tab.dither, half_norms=tab.half_norms)
        n0 = enc_mod.launches
        words, alpha, resid = bqcs_encode_fused(blocks, resid0, a_t, tab.tab, S, M, Q, **kw)
        n_enc = launched(enc_mod, n0, 1)
        if cb.dim > 1:
            w_p, al_p, res_p = ref.bqcs_encode_fused_ref(
                blocks, resid0, a_t, None, S, Q, centroids=tab.tab, half_norms=tab.half_norms)
        else:
            w_p, al_p, res_p = ref.bqcs_encode_fused_ref(
                blocks, resid0, a_t[:, :M], tab.tab, S, Q,
                dither=None if tab.dither is None else tab.dither[:M])
        torch.cuda.synchronize()
        check(torch.equal(resid, res_p), f"{family} encoder resid must be bit-identical")
        rel = float(torch.max(torch.abs(alpha - al_p) / torch.clamp(torch.abs(al_p), min=1e-30)))
        check(rel <= 1e-6, f"{family} encoder alpha rtol {rel:.3g} > 1e-6")
        lanes = cb.n_codes(M)
        check(tuple(words.shape) == (rows, packed_width(lanes, Q)), f"{family} word count")
        codes, codes_p = unpack_codes(words, Q, lanes), unpack_codes(w_p, Q, lanes)
        diff = codes != codes_p
        y = (sparse * al_p[:, None]) @ a.T
        if cb.dim > 1:  # the gap between the two centroid scores the codes took
            c = tab.tab
            sc = torch.einsum("rjg,lj->rgl", y.reshape(rows, cb.dim, -1), c) - tab.half_norms
            pick = lambda k: torch.gather(sc, 2, k.long()[..., None])[..., 0]
            gap = torch.abs(pick(codes) - pick(codes_p))
        else:
            yd = y if tab.dither is None else y + tab.dither[:M]
            gap = torch.amin(torch.abs(yd[..., None] - tab.tab), dim=-1)
        n_diff = int(diff.sum())
        if n_diff:
            check(float(gap[diff].max()) < 1e-5, f"{family}: a differing code lane is not "
                  "within 1e-5 of a decision")
        full = unpack_codes(words, Q, words.shape[1] * (32 // Q))
        check(not bool(full[:, lanes:].any()), f"{family}: pad lanes must carry code 0")
        out[key] = dict(
            max_abs_err=float(torch.max(torch.abs(alpha - al_p))), kept=int(kept.sum()),
            a_rows=int(kept.any(dim=0).sum()), args=(blocks, resid0, a_t, tab.tab, S, M, Q),
            kwargs=kw, words=words.shape[1],
        )
        print(f"[encode] {family}: 300x1591 S=159 Q=3 -> {lanes} code lanes in "
              f"{words.shape[1]} words: resid bit-identical, alpha max rel err {rel:.3g}, "
              f"{n_diff} differing code lanes of {codes.numel()} (each within 1e-5 of a "
              f"decision), dead row alpha {float(alpha[7])}; launches {n_enc}")
        enc_out[family] = (words, alpha, cb)
        if family == "lloyd_max":
            taus = tab.tab

    # -- block_topk (bit-identical) and the staged bqcs_encode -------------------
    carry = blocks + resid0
    n0 = t_mod.launches
    sp_k, res_k = block_topk(carry, S)
    n_t = launched(t_mod, n0, 1)
    sp_p, res_p = ref.block_topk_ref(carry, S)
    torch.cuda.synchronize()
    check(torch.equal(sp_k, sp_p) and torch.equal(res_k, res_p),
          "block_topk sparse and resid must be bit-identical")
    out["topk"] = dict(max_abs_err=0.0, args=(carry, S))
    print(f"[block_topk] 300x1591 S=159: sparse and resid bit-identical; launches {n_t}")
    a_tt = a.T.contiguous()
    n0 = s_mod.launches
    rel, abs_err, n_diff = staged_vs_plain(sparse, a_tt, taus)
    n_s = launched(s_mod, n0, 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pick = s_mod.launch_shape(rows, N, M, sms)
    out["staged"] = dict(max_abs_err=abs_err, args=(sparse, a_tt, taus))
    print(f"[bqcs_encode] 300x1591 -> 530 Q=3 (the top-S blocks), (rows per tile, cluster) "
          f"{pick}: alpha max rel err {rel:.3g}, {n_diff} differing code lanes of {rows * M} "
          f"(each within 1e-5 of a threshold), a second launch bit-identical; launches {n_s}")
    words, alpha, cb = enc_out["lloyd_max"]

    lo, hi = tau_tables(taus)
    L = 3

    # -- one qgamp_step on 300 rows (state and codes from a seed) ----------------
    rng, qargs = qgamp_inputs(rows, 1, a, taus, dev)
    ghat, nug, shat, theta = qargs[:4]
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    n0 = q_mod.launches
    errs, shapes = step_vs_plain("qgamp", qargs, dev)
    # -- the 25-step EA driver on the encoder's words (incl. the dead row) -------
    ea_k = ops.qgamp_ea_run_packed(words, alpha, a, taus, bits=Q, m=M)
    with plain_kernels():
        ea_p = ops.qgamp_ea_run_packed(words, alpha, a, taus, bits=Q, m=M)
    e_ea = nmse(ea_k, ea_p)
    check(e_ea <= 1e-4, f"EA driver NMSE {e_ea:.3g} > 1e-4")
    check(not bool(ea_k[7].any()), "dead row must decode to exactly zero")
    n_q = launched(q_mod, n0, len(shapes) + ITERS)
    out["qgamp"] = dict(max_abs_err=max(errs), args=qargs, gemm=(ghat, shat, a))
    print(f"[qgamp_step] one step, 300 rows, (rows per tile, cluster) {shapes}: allclose rtol "
          f"1e-3 atol 1e-5, max abs err {max(errs):.3g}; 25-step EA driver on the encoder's "
          f"words: NMSE {e_ea:.3g} (<= 1e-4); launches {n_q}")

    # -- one gamp_step on 10 rows, then the 25-step AE driver --------------------
    nb = 10
    g10, n10, s10, th10 = ghat[:nb].contiguous(), nug[:nb].contiguous(), shat[:nb].contiguous(), \
        theta[:nb].contiguous()
    y10 = t(rng.normal(0, 1, (nb, M)))
    nud10 = t(np.full((nb, 1), 0.05))
    args10 = (g10, n10, s10, th10, y10, nud10, a, L, True)
    n0 = g_mod.launches
    errs, shapes = step_vs_plain("gamp", args10, dev)
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
    n_g = launched(g_mod, n0, len(shapes) + ITERS)
    out["gamp"] = dict(max_abs_err=max(errs), args=args10, gemm=(g10, s10, a))
    print(f"[gamp_step] one step, 10 rows, (rows per tile, cluster) {shapes}: allclose rtol "
          f"2e-4 atol 1e-6, max abs err {max(errs):.3g}; 25-step AE driver on the Bussgang "
          f"aggregate of the encoder's words: NMSE {e_ae:.3g} (<= 1e-4); launches {n_g}")

    # -- one gamp_step on 300 rows, then the vq EA decode over K x 10 rows -------
    y300 = t(rng.normal(0, 1, (rows, M)))
    nud300 = t(np.full((rows, 1), 0.05))
    args300 = (ghat, nug, shat, theta, y300, nud300, a, L, True)
    n0 = g_mod.launches
    errs, shapes = step_vs_plain("gamp", args300, dev)
    vq_words, vq_alpha, vq_cb = enc_out["vq"]
    gcfg = GampConfig(variance_mode="scalar")
    vq_k = qem_gamp_packed(vq_words, vq_alpha, a, vq_cb, gcfg, M, use_kernels=True)
    with plain_kernels():
        vq_p = qem_gamp_packed(vq_words, vq_alpha, a, vq_cb, gcfg, M, use_kernels=True)
    e_vq = nmse(vq_k, vq_p)
    check(e_vq <= 1e-4, f"vq EA decode NMSE {e_vq:.3g} > 1e-4")
    check(not bool(vq_k[7].any()), "dead row must decode to exactly zero")
    n_g = launched(g_mod, n0, len(shapes) + ITERS)
    out["gamp300"] = dict(max_abs_err=max(errs), args=args300, gemm=(ghat, shat, a))
    print(f"[gamp_step] one step, 300 rows, (rows per tile, cluster) {shapes}: allclose rtol "
          f"2e-4 atol 1e-6, max abs err {max(errs):.3g}; 25-step vq EA decode on the vq "
          f"encoder's words: NMSE {e_vq:.3g} (<= 1e-4); launches {n_g}")

    # -- gamp_step at the grouped AE decode's rows ([knobs]: G = 3 and 10) -------
    for g in KNOB_GROUPS:
        nb_g = 10 * g
        args_g = tuple(v[:nb_g].contiguous() if torch.is_tensor(v) and v.dim()
                       and v.shape[0] == rows else v for v in args300)
        n0 = g_mod.launches
        errs, shapes = step_vs_plain("gamp", args_g, dev)
        n_k = launched(g_mod, n0, len(shapes))
        out[f"gamp{nb_g}"] = dict(max_abs_err=max(errs), args=args_g,
                                  gemm=(args_g[0], args_g[2], a))
        print(f"[gamp_step] one step, {nb_g} rows (the AE decode at G = {g}), (rows per tile, "
              f"cluster) {shapes}: allclose rtol 2e-4 atol 1e-6, max abs err {max(errs):.3g}; "
              f"launches {n_k}")

    # -- the fused encoder at 10 rows (one client: [knobs]' loop oracle) ---------
    out["encode10"] = encoder_vs_plain("lloyd_max at 10 rows (one client)",
                                       blocks[:10].contiguous(), resid0[:10].contiguous(), a,
                                       out["encode"], S)
    words300, alpha300, _ = enc_out["lloyd_max"]
    w10, al10, _ = out["encode10"]["out"]
    check(torch.equal(w10, words300[:10]) and torch.equal(al10, alpha300[:10]),
          "the fused encoder at 10 rows must give the 300-row launch's first 10 rows bit for bit")
    print("[encode] 10-row launch: words and alpha bit-identical to the 300-row launch's first "
          "10 rows")

    # -- both step kernels at one chunk of the chunked EA decode ([routes]) ------
    for kind, key, args, mod in (("qgamp", "qgamp64", qargs, q_mod),
                                 ("gamp", "gamp64", args300, g_mod)):
        args64 = tuple(v[:CHUNK_ROWS].contiguous() if torch.is_tensor(v) and v.dim()
                       and v.shape[0] == rows else v for v in args)
        n0 = mod.launches
        errs, shapes = step_vs_plain(kind, args64, dev)
        n_k = launched(mod, n0, len(shapes))
        out[key] = dict(max_abs_err=max(errs), args=args64,
                        gemm=(args64[0], args64[2], a))
        print(f"[{kind}_step] one step, {CHUNK_ROWS} rows (a chunk of the chunked EA decode), "
              f"(rows per tile, cluster) {shapes}: max abs err {max(errs):.3g}; launches {n_k}")

    # -- qgamp_step at one fold of the streamed EA decode ([stream]) -------------
    args80 = tuple(v[:FOLD_ROWS].contiguous() if torch.is_tensor(v) and v.dim()
                   and v.shape[0] == rows else v for v in qargs)
    n0 = q_mod.launches
    errs, shapes = step_vs_plain("qgamp", args80, dev)
    n_k = launched(q_mod, n0, len(shapes))
    out["qgamp80"] = dict(max_abs_err=max(errs), args=args80, gemm=(args80[0], args80[2], a))
    print(f"[qgamp_step] one step, {FOLD_ROWS} rows (one fold of the streamed EA decode: "
          f"{STREAM['batch_clients']} clients x 10 blocks), (rows per tile, cluster) {shapes}: "
          f"allclose rtol 1e-3 atol 1e-5, max abs err {max(errs):.3g}; launches {n_k}")
    out.update(layout_kernels(dev, a, out, args300))
    return out


def encoder_vs_plain(label, blocks, resid0, a, k300, s):
    """The fused lloyd_max encoder at ``s`` against its plain version:
    resid bit-identical, alpha to 1e-6 relative, a differing code only
    within 1e-5 of a threshold, pad lanes 0.  Returns the [time] record."""
    import torch

    from repro_torch.core.compression import unpack_codes
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.bqcs_encode_fused import bqcs_encode_fused

    a_t, tab = k300["args"][2], k300["args"][3]
    rows = blocks.shape[0]
    n0 = enc_mod.launches
    words, alpha, resid = bqcs_encode_fused(blocks, resid0, a_t, tab, s, M, Q, **k300["kwargs"])
    n_enc = enc_mod.launches - n0
    w_p, al_p, res_p = ref.bqcs_encode_fused_ref(blocks, resid0, a_t[:, :M], tab, s, Q)
    torch.cuda.synchronize()
    check(n_enc == 1, f"{label}: {n_enc} launches, want 1")
    check(torch.equal(resid, res_p), f"{label}: resid must be bit-identical to the plain")
    rel = float(torch.max(torch.abs(alpha - al_p) / torch.clamp(torch.abs(al_p), min=1e-30)))
    check(rel <= 1e-6, f"{label}: alpha rtol {rel:.3g} > 1e-6")
    sparse, _ = ref.block_topk_ref(blocks + resid0, s)
    diff = unpack_codes(words, Q, M) != unpack_codes(w_p, Q, M)
    gap = torch.amin(torch.abs(((sparse * al_p[:, None]) @ a.T)[..., None] - tab), dim=-1)
    n_diff = int(diff.sum())
    if n_diff:
        check(float(gap[diff].max()) < 1e-5, f"{label}: a differing code lane is not within "
              "1e-5 of a threshold")
    full = unpack_codes(words, Q, words.shape[1] * (32 // Q))
    check(not bool(full[:, M:].any()), f"{label}: pad lanes must carry code 0")
    kept = sparse != 0
    print(f"[encode] {label}: {rows}x{N} S={s} Q={Q}: resid bit-identical, alpha max rel err "
          f"{rel:.3g}, {n_diff} differing code lanes of {diff.numel()} (each within 1e-5 of a "
          f"threshold); launches {n_enc}")
    return dict(max_abs_err=float(torch.max(torch.abs(alpha - al_p))), kept=int(kept.sum()),
                a_rows=int(kept.any(dim=0).sum()),
                args=(blocks, resid0, a_t, tab, s, M, Q), kwargs=k300["kwargs"],
                words=words.shape[1], out=(words, alpha, resid))


def layout_kernels(dev, a, k_in, args300):
    """[kernels] at the per-tensor layout's shapes ([layout]): the fused
    encoder at 390 rows (one pass over 30 clients x 13 rows) and at 30 rows
    (one client segment of one row each) with S = 159 and with a bias
    segment's budget s = 79 -- the 30-row launch at S = 159 bit-identical
    to the 390-row launch's first 30 rows; qgamp_step at 390 rows (4 rows x
    cluster 2, a partial last tile) with the 25-step EA driver on the
    390-row words, at 30 rows (a segment-local decode) and at 104 rows (a
    streamed EA fold of 8 clients x 13 rows); gamp_step at 13 rows with the
    25-step AE driver on the Bussgang aggregate of the 390-row words."""
    import torch

    from repro_torch.core import bussgang
    from repro_torch.core.codebook import make_codebook
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import qgamp_step as q_mod

    out = {}
    rows = LAYOUT_ROWS
    gen = torch.Generator(device="cpu").manual_seed(5)
    blocks = (0.05 * torch.randn((rows, N), generator=gen)).to(dev)
    resid0 = (0.01 * torch.randn((rows, N), generator=gen)).to(dev)
    blocks[3] = 0.0
    resid0[3] = 0.0  # one dead row
    k300 = k_in["encode"]
    out["encode390"] = encoder_vs_plain(f"lloyd_max at {rows} rows (30 clients x 13)", blocks,
                                        resid0, a, k300, S)
    b30, r30 = blocks[:K].contiguous(), resid0[:K].contiguous()
    out["encode30"] = encoder_vs_plain(f"lloyd_max at {K} rows, a bias segment's s={BIAS_S}",
                                       b30, r30, a, k300, BIAS_S)
    same = encoder_vs_plain(f"lloyd_max at {K} rows, S={S}", b30, r30, a, k300, S)["out"]
    words, alpha, _ = out["encode390"]["out"]
    check(all(torch.equal(x, y[:K]) for x, y in zip(same, out["encode390"]["out"])),
          f"the fused encoder at {K} rows must give the {rows}-row launch's first rows bit for bit")
    print(f"[encode] {K}-row launch at S={S}: words, alpha and resid bit-identical to the "
          f"{rows}-row launch's first {K} rows")

    # qgamp_step at 390 rows, state and codes from a seed as at 300 rows
    taus = k300["args"][3]
    _, qargs = qgamp_inputs(rows, 2, a, taus, dev)
    for nb in (rows, K, STREAM["batch_clients"] * 13):
        args = tuple(v[:nb].contiguous() if torch.is_tensor(v) and v.dim() and v.shape[0] == rows
                     else v for v in qargs)
        n0 = q_mod.launches
        errs, shapes = step_vs_plain("qgamp", args, dev)
        extra = ""
        if nb == rows:
            ea_k = ops.qgamp_ea_run_packed(words, alpha, a, taus, bits=Q, m=M)
            with plain_kernels():
                ea_p = ops.qgamp_ea_run_packed(words, alpha, a, taus, bits=Q, m=M)
            e_ea = nmse(ea_k, ea_p)
            check(e_ea <= 1e-4, f"EA driver at {rows} rows: NMSE {e_ea:.3g} > 1e-4")
            check(not bool(ea_k[3].any()), "dead row must decode to exactly zero")
            extra = f"; 25-step EA driver on the {rows}-row encoder's words: NMSE {e_ea:.3g}"
        n_k = q_mod.launches - n0
        check(n_k == len(shapes) + (ITERS if nb == rows else 0), f"qgamp_step {nb} rows: "
              f"{n_k} launches")
        out[f"qgamp{nb}"] = dict(max_abs_err=max(errs), args=args, gemm=(args[0], args[2], a))
        print(f"[qgamp_step] one step, {nb} rows, (rows per tile, cluster) {shapes}: allclose "
              f"rtol 1e-3 atol 1e-5, max abs err {max(errs):.3g}{extra}; launches {n_k}")

    # gamp_step at 13 rows: the per-tensor AE decode
    args13 = tuple(v[:13].contiguous() if torch.is_tensor(v) and v.dim() and v.shape[0] == K * 10
                   else v for v in args300)
    n0 = g_mod.launches
    errs, shapes = step_vs_plain("gamp", args13, dev)
    cb = make_codebook(dataclasses.replace(fed_cfg(), block_size=N))
    w3, a3 = words.reshape(K, 13, -1), alpha.reshape(K, 13)
    rhos = torch.full((K,), 1.0 / K, device=dev)
    y_ae = bussgang.aggregate_packed(w3, a3, rhos, cb, M)
    nu_ae = bussgang.effective_noise_var(a3, rhos, cb)
    e_in = bussgang.signal_energy(a3, rhos, M, N)
    ae_k = ops.gamp_ae_run(y_ae, nu_ae, a, e_in)
    with plain_kernels():
        ae_p = ops.gamp_ae_run(y_ae, nu_ae, a, e_in)
    e_ae = nmse(ae_k, ae_p)
    check(e_ae <= 1e-4, f"AE driver at 13 rows: NMSE {e_ae:.3g} > 1e-4")
    n_k = g_mod.launches - n0
    check(n_k == len(shapes) + ITERS, f"gamp_step 13 rows: {n_k} launches")
    out["gamp13"] = dict(max_abs_err=max(errs), args=args13, gemm=(args13[0], args13[2], a))
    print(f"[gamp_step] one step, 13 rows (the per-tensor AE decode), (rows per tile, cluster) "
          f"{shapes}: allclose rtol 2e-4 atol 1e-6, max abs err {max(errs):.3g}; 25-step AE "
          f"driver on the Bussgang aggregate of the {rows}-row words: NMSE {e_ae:.3g}; launches "
          f"{n_k}")
    return out


def phase_staged(dev):
    """The staged encode path (the reference's unfused baseline) through the
    drivers a user calls, with its launch counts set to 0 just before and
    read just after, held against the fused encoder's wire."""
    import torch

    from repro_torch.core.codebook import make_codebook
    from repro_torch.core.compression import pack_codes, unpack_codes
    from repro_torch.core.sensing import sensing_matrix
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(fed_cfg(), block_size=N)
    cb = make_codebook(cfg)
    a = sensing_matrix(cfg.seed, M, N, dev)
    gen = torch.Generator(device="cpu").manual_seed(3)
    blocks = (0.05 * torch.randn((K * 10, N), generator=gen)).to(dev)
    resid0 = (0.01 * torch.randn((K * 10, N), generator=gen)).to(dev)
    zero_counts()
    sparse, res_s = ops.block_sparsify(blocks + resid0, S)
    codes_s, alpha_s = ops.bqcs_encode(sparse, a, cb)
    words_s = pack_codes(codes_s, Q)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == dict(encode=0, qgamp=0, gamp=0, topk=1, staged=1),
          f"staged path launches {counts}")
    words_f, alpha_f, res_f = ops.bqcs_encode_fused(blocks, resid0, a, cb, S)
    torch.cuda.synchronize()
    check(torch.equal(res_s, res_f), "staged resid must equal the fused encoder's bit for bit")
    rel = float(torch.max(torch.abs(alpha_s - alpha_f) / torch.clamp(alpha_f.abs(), min=1e-30)))
    check(rel <= 1e-6, f"staged alpha rtol {rel:.3g} > 1e-6")
    check(words_s.shape == words_f.shape, "staged and fused word counts")
    # a code may differ only on a lane within float rounding of a threshold
    gap = torch.amin(torch.abs(((sparse * alpha_f[:, None]) @ a.T)[..., None]
                               - cb.thresholds_t(dev)), dim=-1)

    def near_threshold(diff, what):
        if bool(diff.any()):
            check(float(gap[diff].max()) < 1e-5, f"staged vs {what}: a differing lane is not "
                  "near a threshold")
        return int(diff.sum())

    diff = unpack_codes(words_s, Q, M) != unpack_codes(words_f, Q, M)
    n_diff = near_threshold(diff, "the fused encoder")
    with plain_kernels():
        sp_p, _ = ops.block_sparsify(blocks + resid0, S)
        codes_p, _ = ops.bqcs_encode(sp_p, a, cb)
    check(torch.equal(sp_p, sparse), "staged sparse vs the plain staged path")
    n_plain = near_threshold(codes_p != codes_s, "the plain staged path")
    print(f"[staged] block_sparsify -> bqcs_encode -> pack_codes, 300x1591 -> 530 Q=3: "
          f"launches {counts}; vs the fused encoder's wire: resid bit-identical, alpha max rel "
          f"err {rel:.3g}, {n_diff} of {diff.numel()} code lanes differ (each within 1e-5 of a "
          f"threshold); vs the plain staged path: {n_plain} code lanes differ (each near a "
          f"threshold)")
    return {"block_topk": counts["topk"], "bqcs_encode": counts["staged"]}


def phase_main_path(dev):
    """Each MAIN_RUNS configuration through ``run_federated``, counts set to 0
    just before and read just after; then kernels vs plain versions."""
    import numpy as np

    from repro_torch.paper.mlp import run_federated

    per_run, round_ms = {}, {}
    for method, codebook, variance, rounds, per_round in MAIN_RUNS:
        label = run_label(method, codebook, variance)
        zero_counts()
        res = run_federated(method, steps=rounds, eval_every=1, device=dev,
                            fed_cfg=fed_cfg(codebook, variance))
        counts = read_counts()
        print(f"[main] {label}: nmse {[round(v, 6) for v in res.nmses]} accuracy "
              f"{[round(v, 4) for v in res.accs]} round ms {[round(v, 2) for v in res.round_ms]} "
              f"bits/entry {res.bits_per_entry} launches {counts}")
        check(all(np.isfinite(res.nmses)) and max(res.nmses) < 1.0, f"{label} nmse {res.nmses}")
        check(all(0.0 <= v <= 1.0 for v in res.accs), f"{label} accuracy {res.accs}")
        want = dict({k: v * rounds for k, v in per_round.items()}, topk=0, staged=0)
        check(counts == want, f"{label}: launches {counts}, want {want}")
        per_run[(method, codebook, variance)] = counts
        round_ms[label] = (method, fed_cfg(codebook, variance), res.round_ms, {})

    # the same round from the same A and init, kernels vs plain versions
    for method, codebook, variance, _, _ in MAIN_RUNS:
        label = run_label(method, codebook, variance)
        cfg = fed_cfg(codebook, variance)
        res_k = run_federated(method, steps=1, device=dev, fed_cfg=cfg)
        with plain_kernels():
            res_p = run_federated(method, steps=1, device=dev, fed_cfg=cfg)
        e = nmse(res_k.last_ghat, res_p.last_ghat)
        print(f"[main] {label} round 0, kernels vs plain versions on the card: decoded "
              f"gradient NMSE {e:.3g} (<= 1e-3); nmse stat {res_k.nmses[0]:.6f} vs "
              f"{res_p.nmses[0]:.6f}")
        check(e <= 1e-3, f"{label}: kernel round vs plain round NMSE {e:.3g} > 1e-3")
    return per_run, round_ms


# jax.random's answers (jax 0.9.0: threefry2x32, jax_threefry_partitionable),
# written here as constants; tests/test_torch_prng.py holds them against JAX
# itself.  [prng] draws them on the card and must get them exactly.
PRNG_GOLDEN = {
    "threefry2x32": [((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
                     ((0xFFFFFFFF,) * 4, (0x1CB996FC, 0xBB002BE7)),
                     ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
                      (0xC4923A9C, 0x483DF7A0))],
    "PRNGKey": [(0, (0, 0)), (42, (0, 42)), (2**32 - 1, (0, 4294967295))],
    "fold_in": [((0, 7), (2716826189, 292468403))],
    "split": [(1797259609, 2579123966), (928981903, 3453687069)],  # split(PRNGKey(0))
    # the first words of PRNGKey(0)'s draws: bits, normal (f32 bit patterns),
    # randint over randint_range
    "random_bits": [4070199207, 4202968722, 1427181096, 2012915765, 2447653815, 710830403,
                    1332275837, 2961296638],
    "normal": [0x3FCFB2BD, 0x40019DF0, 0xBEDE0017, 0xBDA10222, 0x3E34512C, 0xBF78DAD7,
               0xBEFD97CC, 0x3EFD1F31],
    "randint_range": (0, 151936),
    "randint": [28261, 85072, 140104, 80957, 135171, 11731, 143120, 108575],
}
PRNG_CHECK_N = 1 << 26  # card against CPU, bit for bit
PRNG_TIME_N = 1 << 28
PRNG_AWGN = (2_337_477, 85)  # one Qwen3-0.6B cohort client's receive noise, (rows, M)


def prng_golden(dev) -> None:
    """[prng] (a): the golden table drawn on the card, exactly."""
    import torch

    from repro_torch import prng

    g = PRNG_GOLDEN
    for (k1, k2, x1, x2), want in g["threefry2x32"]:
        got = prng.threefry2x32(torch.tensor(k1, dtype=torch.int64, device=dev), k2, x1, x2)
        check(tuple(int(v) for v in got) == want, f"[prng] threefry2x32 {got} != {want}")
    for seed, want in g["PRNGKey"]:
        got = tuple(prng.key_data(prng.PRNGKey(seed, device=dev)).tolist())
        check(got == want, f"[prng] PRNGKey({seed}) = {got}, want {want}")
    for (seed, data), want in g["fold_in"]:
        got = tuple(prng.fold_in(prng.PRNGKey(seed, device=dev), data).tolist())
        check(got == want, f"[prng] fold_in(PRNGKey({seed}), {data}) = {got}, want {want}")
    k0 = prng.PRNGKey(0, device=dev)
    check(prng.split(k0).tolist() == [list(w) for w in g["split"]], "[prng] split(PRNGKey(0))")
    n = len(g["random_bits"])
    check(prng.random_bits(k0, (n,)).tolist() == g["random_bits"], "[prng] random_bits")
    normal = prng.normal(k0, (n,)).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    check(normal.tolist() == g["normal"], f"[prng] normal bits {normal.tolist()}")
    check(prng.randint(k0, (n,), *g["randint_range"]).tolist() == g["randint"], "[prng] randint")
    print(f"[prng] (a) golden values on the card, exactly: 3 threefry2x32 known answers, "
          f"PRNGKey, fold_in, split and the first {n} words of random_bits, normal and "
          f"randint{g['randint_range']} from PRNGKey(0)")


def ulp_gap(a, b):
    """(entries that differ, the largest gap in f32 ulps) of two f32 tensors
    on the same device."""
    import torch

    def ordered(x):  # f32 bit patterns to integers that sort like the floats
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    gap = torch.abs(ordered(a) - ordered(b))
    return int((gap != 0).sum()), int(gap.max())


def prng_card_vs_cpu(dev) -> None:
    """[prng] (b): the card's draws against the CPU's, bit for bit over
    PRNG_CHECK_N elements each; the three float transforms over all 2**23
    inputs they can see."""
    import numpy as np
    import torch

    from repro_torch import prng

    n = PRNG_CHECK_N
    t0 = time.perf_counter()
    # the CPU's uniform and bernoulli of a key are maps of its bits, word by
    # word: one CPU draw of the bits serves the three
    key, key_g = prng.PRNGKey(100), prng.PRNGKey(100, device=dev)
    bits = prng.random_bits(key, (n,))
    u = prng.from_bits("uniform")(bits)
    for name, card, cpu in (
            ("random_bits", prng.random_bits(key_g, (n,)), bits),
            ("uniform", prng.uniform(key_g, (n,)), u),
            ("bernoulli(0.2)", prng.bernoulli(key_g, 0.2, (n,)), u < float(np.float32(0.2))),
            ("randint(0, 151936)", prng.randint(key_g, (n,), 0, 151936),
             prng.randint(key, (n,), 0, 151936))):
        check(torch.equal(card.cpu(), cpu), f"[prng] {name} of {n} on the card differs from "
              "the CPU's")
    keys = prng.split(prng.PRNGKey(7), 1 << 16)
    ids = torch.arange(1 << 16)
    for name, fn in (("split(keys, 4)", lambda k: prng.split(k, 4)),
                     ("fold_in(keys, ids)", lambda k: prng.fold_in(k, ids.to(k.device)))):
        check(torch.equal(fn(keys.to(dev)).cpu(), fn(keys)), f"[prng] {name} differs")
    for name, fn in (("permutation(1591)", lambda k: prng.permutation(k, 1591)),
                     ("choice(1591, 530)", lambda k: prng.choice(k, 1591, (530,), replace=False))):
        check(torch.equal(fn(prng.PRNGKey(3, device=dev)).cpu(), fn(prng.PRNGKey(3))),
              f"[prng] {name} differs")
    print(f"[prng] (b) card vs CPU: random_bits, uniform, randint(0, 151936) and "
          f"bernoulli(0.2) over {n} elements each, split and fold_in of {1 << 16} keys, "
          f"permutation(1591) and choice(1591, 530): bit-identical "
          f"({time.perf_counter() - t0:.1f} s)")
    words = torch.arange(1 << 23, dtype=torch.int64) << 9
    small = 1 << 22  # under TABLE_MIN: the CPU runs the transform, the card reads its table
    for name in ("normal", "exponential", "gumbel"):
        card = prng.from_bits(name)(words.to(dev)).cpu()
        cpu = prng.from_bits(name)(words)
        n_diff, ulps = ulp_gap(card, cpu)
        draw = getattr(prng, name)
        table = torch.equal(draw(prng.PRNGKey(9, device=dev), (small,)).cpu().view(torch.int32),
                            draw(prng.PRNGKey(9), (small,)).view(torch.int32))
        print(f"[prng] (b) {name} transform on all 2**23 inputs, card vs CPU: {n_diff} "
              f"differ, largest gap {ulps} ulp (bound: 0 and 0); a draw of {small} through "
              f"the card's table vs the CPU's transform: bit-identical {table}")
        check(n_diff == 0 and table, f"[prng] {name}: {n_diff} of 2**23 inputs differ on "
              f"the card, or its table draw differs from the CPU's")


def prng_round(dev) -> None:
    """[prng] (c): the paper's round from a seed with the default draws,
    one round each of fedqcs-ae and fedqcs-ea (lloyd_max, kernel route)
    and qcs-dither (the default config), on the card and on the CPU: A
    bit-identical, round 0's wire under ``wire_vs_cpu``'s contract (the
    dither draws and QCS-Dither's signs and rows bit-identical), launch
    counts reported."""
    import numpy as np
    import torch

    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.paper.mlp import run_federated

    default_cfg = FedQCSConfig(reduction_ratio=3, bits=Q, s_ratio=0.1, gamp_iters=ITERS)
    runs = (("fedqcs-ae", fed_cfg(), dict(encode=1, gamp=ITERS, qgamp=0)),
            ("fedqcs-ea", fed_cfg(), dict(encode=1, gamp=0, qgamp=ITERS)),
            ("qcs-dither", default_cfg, dict(encode=0, gamp=0, qgamp=0)))
    for method, cfg, per_round in runs:
        with captured_rounds() as card:
            zero_counts()
            run_federated(method, steps=1, seed=0, device=dev, fed_cfg=cfg)
            counts = read_counts()
        with captured_rounds() as cpu:
            run_federated(method, steps=1, seed=0, device="cpu", fed_cfg=cfg)
        k0, c0 = card[0], cpu[0]
        want = dict(per_round, topk=0, staged=0)
        check(counts == want, f"[prng] {method}: launches {counts}, want {want}")
        eng_k, eng_c = k0["engine"], c0["engine"]
        if method == "qcs-dither":
            d_k, d_c = eng_k.dither, eng_c.dither
            check(torch.equal(d_k.rademacher.cpu(), d_c.rademacher)
                  and torch.equal(d_k.rows.cpu(), d_c.rows), "[prng] qcs-dither signs or rows")
            shape, ids = eng_k._dither_rows(), np.arange(K)
            same = torch.equal(eng_k.draw(0, "dither", shape, client=ids).cpu(),
                               eng_c.draw(0, "dither", shape, client=ids))
            check(same, "[prng] qcs-dither: the card's dither draws differ from the CPU's")
            e = nmse(k0["ghat"], c0["ghat"].to(dev))
            check(e <= 1e-3, f"[prng] qcs-dither round 0 vs the CPU: NMSE {e:.3g} > 1e-3")
            detail = (f"signs, rows and the {K} clients' dither draws bit-identical; decoded "
                      f"aggregate NMSE {e:.3g} (<= 1e-3)")
        else:
            check(torch.equal(eng_k.codec.a.cpu(), eng_c.codec.a),
                  f"[prng] {method}: A on the card differs from the CPU's")
            n_diff, lanes = wire_vs_cpu(f"[prng] {method}", k0, c0, dev)
            detail = (f"A ({M} x {N}) bit-identical; {n_diff} of {lanes} wire lanes differ "
                      f"(each within 1e-5 of a threshold)")
        print(f"[prng] (c) run_federated({method!r}, seed=0) round 0 on the card vs the CPU: "
              f"{detail}; launches {counts}")


def prng_times(dev, smi) -> None:
    """[prng] (d): device times of the draws at size, and a full-width
    ``init_params`` (wall and peak memory)."""
    import torch

    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as model_api

    timer = GpuTimer()
    n = PRNG_TIME_N
    key = prng.PRNGKey(1, device=dev)
    rows, m = PRNG_AWGN
    for name, fn, elems in (
            ("random_bits", lambda: prng.random_bits(key, (n,)), n),
            ("normal", lambda: prng.normal(key, (n,)), n),
            (f"normal {rows} x {m} (a cohort client's AWGN)",
             lambda: prng.normal(key, (rows, m)), rows * m)):
        ms = timer.direct(fn, reps=2, warmup=1)
        out_bytes = elems * (8 if name == "random_bits" else 4)
        print(f"[prng] (d) {name} of {elems} elements: {ms:.2f} ms (CUDA events), output "
              f"{out_bytes / ms / 1e6:.1f} GB/s | {smi}")
    cfg = get_config("qwen3-0.6b")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_api.init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    nbytes = sum(v.numel() * v.element_size() for v in _leaves(params))
    check(all(bool(torch.isfinite(v.float()).all()) for v in _leaves(params)),
          "[prng] init_params(qwen3-0.6b) on the card: a non-finite leaf")
    print(f"[prng] (d) init_params(qwen3-0.6b, 0, 'cuda') at full width: {wall:.2f} s wall, "
          f"peak {peak / 2**30:.2f} GiB above the start for a {nbytes / 2**30:.2f} GiB tree | "
          f"{smi}")
    del params
    torch.cuda.empty_cache()


def _leaves(tree):
    from repro_torch import tree as tree_util

    return [v for _, v in tree_util.leaves(tree)]


def phase_prng(dev, smi) -> None:
    """[prng] The reference's threefry draws on the card (PRNG_GOLDEN, card
    against CPU, the paper's round from a seed, times)."""
    t0 = time.perf_counter()
    prng_golden(dev)
    prng_card_vs_cpu(dev)
    prng_round(dev)
    prng_times(dev, smi)
    print(f"[prng] phase passed in {time.perf_counter() - t0:.1f} s")


# The reference's default config (``run_federated`` with no ``fed_cfg``):
# the XLA-algorithm route, exact-variance GAMP on the plain loop.


@contextlib.contextmanager
def captured_rounds():
    """Records each round's client-pass payload (``words`` or ``codes``,
    ``alpha``) and blocks, the engine, the decoded aggregate it applies
    (barrier or streamed), the PS pass's stats and channel mask, and QIHT's
    per-row decode where it runs (one dict per round) while runs go on."""
    from repro_torch.core import baselines
    from repro_torch.fed.engine import CohortEngine

    rounds = []
    client_pass, ps, apply = CohortEngine._client_pass, CohortEngine._ps, CohortEngine._apply
    qiht = baselines.qiht_reconstruct

    def cp(self, *args, **kwargs):
        out = client_pass(self, *args, **kwargs)
        rounds.append(dict(engine=self, words=out[0].get("words"), codes=out[0].get("codes"),
                           alpha=out[0].get("alpha"), blocks=out[1]))
        return out

    def psf(self, payload, blocks, rhos, real=None, draw=None):
        out = ps(self, payload, blocks, rhos, real, draw)
        rounds[-1].update(stats=out[1], rhos=rhos, mask=None if real is None else real.mask)
        return out

    def apply_f(self, t, jids, new_res, ghat):  # barrier and streamed rounds
        rounds[-1]["ghat"] = ghat
        return apply(self, t, jids, new_res, ghat)

    def qiht_f(*args, **kwargs):
        out = qiht(*args, **kwargs)
        rounds[-1]["qiht"] = out
        return out

    CohortEngine._client_pass, CohortEngine._ps, CohortEngine._apply = cp, psf, apply_f
    baselines.qiht_reconstruct = qiht_f
    try:
        yield rounds
    finally:
        CohortEngine._client_pass, CohortEngine._ps, CohortEngine._apply = client_pass, ps, apply
        baselines.qiht_reconstruct = qiht


def wire_vs_cpu(label, k0, c0, dev):
    """Round 0's wire lanes on the card against the same round on the CPU
    (``captured_rounds`` records; round 0 starts from zero residuals): a
    lane may differ only where its projection lies within 1e-5 of a
    threshold.  Returns (differing lanes, lanes)."""
    import torch

    from repro_torch.core.sensing import project_blocks
    from repro_torch.core.sparsify import block_sparsify

    codec = k0["engine"].codec

    def codes(r):
        return (codec.unpack(r["words"]) if r["words"] is not None else r["codes"]).reshape(-1, M)

    sparse, _ = block_sparsify(k0["blocks"].reshape(-1, N), codec.cfg.s)
    x, _ = project_blocks(sparse, codec.a.T)
    gap = torch.amin(torch.abs(x[..., None] - codec.codebook.thresholds_t(dev)), dim=-1)
    diff = codes(k0) != codes(c0).to(dev)
    n_diff = int(diff.sum())
    if n_diff:
        check(float(gap[diff].max()) < 1e-5, f"{label}: a wire lane differs from the CPU "
              "run's away from a threshold")
    return n_diff, diff.numel()


def phase_routes(dev):
    """[routes] This slice's paths at full width: the reference's default
    config (0 kernel launches; round 0 against the same round on the CPU),
    one EA round with the bisect sparsifier, the chunked EA decode on the
    kernel route (lloyd_max and vq, recon_chunk=64, against recon_chunk=0
    and against the plain versions), and early stop and the two-phase sweep
    on one EA round's payload.  Returns (the chunked runs' launch counts by
    KERNELS name, label -> (method, config, round walls) for [profile])."""
    import numpy as np
    import torch

    from repro_torch.core import recon_engine
    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.core.gamp import GampConfig, _qem_gamp_xla
    from repro_torch.core.reconstruction import estimate_and_aggregate_packed
    from repro_torch.paper.mlp import run_federated

    zero = dict(encode=0, qgamp=0, gamp=0, topk=0, staged=0)
    round_ms, launches = {}, {}
    default_cfg = FedQCSConfig(reduction_ratio=3, bits=Q, s_ratio=0.1, gamp_iters=ITERS)
    ea_round = None
    for method in ("fedqcs-ae", "fedqcs-ea"):
        label = f"{method} default config"
        with captured_rounds() as card:
            zero_counts()
            res = run_federated(method, steps=2, eval_every=1, device=dev)
            counts = read_counts()
        check(counts == zero, f"{label}: launches {counts}, want none")
        check(all(np.isfinite(res.nmses)) and max(res.nmses) < 1.0, f"{label} nmse {res.nmses}")
        with captured_rounds() as cpu:
            run_federated(method, steps=1, device="cpu")
        k0, c0 = card[0], cpu[0]
        codec = k0["engine"].codec
        check(not codec.cfg.use_kernels and codec.cfg.gamp_variance_mode == "exact",
              f"{label}: run_federated's default config is not the reference's")
        n_diff, lanes = wire_vs_cpu(label, k0, c0, dev)
        e = nmse(k0["ghat"], c0["ghat"].to(dev))
        check(e <= 1e-3, f"{label}: round 0 on the card vs the CPU: NMSE {e:.3g} > 1e-3")
        print(f"[routes] {label} (XLA route, exact variance): nmse "
              f"{[round(v, 6) for v in res.nmses]} round ms "
              f"{[round(v, 2) for v in res.round_ms]} launches {counts}; round 0 vs the same "
              f"round on the CPU: {n_diff} of {lanes} wire lanes differ (each within "
              f"1e-5 of a threshold), decoded gradient NMSE {e:.3g} (<= 1e-3)")
        round_ms[label] = (method, default_cfg, res.round_ms, {})
        if method == "fedqcs-ea":
            ea_round = k0

    bisect = dataclasses.replace(default_cfg, sparsifier="bisect")
    zero_counts()
    res = run_federated("fedqcs-ea", steps=1, device=dev, fed_cfg=bisect)
    counts = read_counts()
    check(counts == zero, f"bisect EA round: launches {counts}, want none")
    check(np.isfinite(res.nmses[0]) and res.nmses[0] < 1.0, f"bisect EA nmse {res.nmses}")
    print(f"[routes] fedqcs-ea default config, sparsifier=bisect: nmse {res.nmses[0]:.6f} round "
          f"ms {res.round_ms[0]:.2f} launches {counts}")

    rows = K * 10
    nch = -(-rows // CHUNK_ROWS)
    for codebook, kernel in (("lloyd_max", "qgamp"), ("vq", "gamp")):
        label = f"fedqcs-ea {codebook} recon_chunk={CHUNK_ROWS}"
        cfg = dataclasses.replace(fed_cfg(codebook), recon_chunk=CHUNK_ROWS)
        zero_counts()
        res = run_federated("fedqcs-ea", steps=2, eval_every=1, device=dev, fed_cfg=cfg)
        counts = read_counts()
        want = dict(zero, encode=2, **{kernel: 2 * ITERS * nch})
        check(counts == want, f"{label}: launches {counts}, want {want}")
        mono = run_federated("fedqcs-ea", steps=1, device=dev, fed_cfg=fed_cfg(codebook))
        chunked = run_federated("fedqcs-ea", steps=1, device=dev, fed_cfg=cfg)
        with plain_kernels():
            plain = run_federated("fedqcs-ea", steps=1, device=dev, fed_cfg=cfg)
        e_mono = nmse(chunked.last_ghat, mono.last_ghat)
        e_plain = nmse(chunked.last_ghat, plain.last_ghat)
        check(e_mono <= 1e-4, f"{label}: NMSE {e_mono:.3g} against recon_chunk=0 > 1e-4")
        check(e_plain <= 1e-3, f"{label}: NMSE {e_plain:.3g} against the plain versions > 1e-3")
        print(f"[routes] {label} (kernel route, scalar variance, {nch} chunks, the last with "
              f"{nch * CHUNK_ROWS - rows} dead rows): nmse {[round(v, 6) for v in res.nmses]} "
              f"round ms {[round(v, 2) for v in res.round_ms]} launches {counts}; round 0 vs "
              f"recon_chunk=0: NMSE {e_mono:.3g} (<= 1e-4); vs the plain versions on the card: "
              f"NMSE {e_plain:.3g} (<= 1e-3)")
        round_ms[label] = ("fedqcs-ea", cfg, res.round_ms, {})
        branch = "bqcs_encode_fused" + ("[vq]" if codebook == "vq" else "")
        step = f"{kernel}_step[{CHUNK_ROWS} rows]"
        launches[branch], launches[step] = counts["encode"], counts[kernel]

    # early stop and the two-phase sweep on the default EA round 0's payload
    codec = ea_round["engine"].codec
    words, alpha, rhos = ea_round["words"], ea_round["alpha"], ea_round["rhos"]
    exact = GampConfig(iters=ITERS, variance_mode="exact", tol=1e-3)
    es = dataclasses.replace(exact, early_stop=True)

    def decode(cfg):
        t0 = time.perf_counter()
        out = estimate_and_aggregate_packed(codec, words, alpha, rhos, cfg, with_info=True)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    decode(exact)  # warm-up
    (fixed, info_f), fixed_ms = decode(exact)
    (early, info), es_ms = decode(es)
    check(torch.equal(early, fixed) and torch.equal(info.iters, info_f.iters),
          "early stop must be bit-identical to the fixed trip count")
    print(f"[routes] early stop, default EA round 0's payload ({rows} rows, exact variance, "
          f"tol 1e-3): bit-identical to the fixed trip count; loop iterations run "
          f"{int(info.iters.max())} of {ITERS}, live iterations a row mean "
          f"{float(info.iters.float().mean()):.2f}, converged {int(info.converged.sum())} of "
          f"{rows}; decode wall {es_ms:.2f} ms (fixed trip count {fixed_ms:.2f} ms)")
    scalar = dataclasses.replace(exact, variance_mode="scalar")
    out, stats = recon_engine.ea_decode_two_phase(codec, words, alpha, rhos, scalar, packed=True)
    flat_c, flat_a = codec.unpack(words.reshape(rows, -1)), alpha.reshape(rows)
    ghat, conv, _ = _qem_gamp_xla(flat_c, flat_a, codec.a, codec.codebook, scalar)
    surv = torch.nonzero(~conv).flatten()
    check(surv.numel() == stats["phase2_rows"], "two-phase survivors")
    if surv.numel():
        refined, _, _ = _qem_gamp_xla(flat_c[surv], flat_a[surv], codec.a, codec.codebook,
                                      dataclasses.replace(exact, early_stop=False))
        ghat = ghat.index_copy(0, surv, refined)
    e = nmse(out, torch.einsum("k,kbn->bn", rhos, ghat.reshape(K, 10, N)))
    check(e <= 1e-6, f"two-phase vs its composition: NMSE {e:.3g} > 1e-6")
    print(f"[routes] two-phase sweep, the same payload (scalar pass, tol 1e-3): phase2_rows "
          f"{stats['phase2_rows']} of {stats['rows']}, phase-1 iterations mean "
          f"{stats['phase1_iters_mean']:.2f}; vs its composition NMSE {e:.3g} (<= 1e-6)")
    return launches, round_ms


# [baselines]: (method, route, kernel route?, launches per round).  Only the
# fused encoder launches, once a QIHT round on the kernel route; QIHT's
# decode, the dither codec, SignSGD and no compression run no kernel.
BASELINE_RUNS = (
    ("qcs-qiht", "kernel route", True, dict(encode=1)),
    ("qcs-qiht", "default config", False, {}),
    ("qcs-dither", "default config", False, {}),
    ("signsgd", "default config", False, {}),
    ("none", "default config", False, {}),
)
# [channels]: fedqcs-ae with lloyd_max on the kernel route over each noisy
# uplink (run_federated's channel arguments); 25 gamp_step launches a round.
CHANNEL_RUNS = (
    ("awgn 20 dB", dict(channel="awgn", snr_db=20.0)),
    ("rayleigh 20 dB", dict(channel="rayleigh", snr_db=20.0)),
    ("mimo_mac lmmse n_rx=8", dict(channel="mimo_mac", n_rx=8)),
    ("mimo_mac zf n_rx=32 csi_error=0.01",
     dict(channel="mimo_mac", combiner="zf", n_rx=32, csi_error=0.01)),
)
ROUNDS_NEW = 2  # rounds of each [baselines] and [channels] run


def qiht_replay(codes, alpha, codec, dev, iters: int = 50):
    """QIHT from the same codes on the card and on the CPU in lockstep
    (``baselines.qiht_step``), to the first iteration where the two take a
    different discrete branch: a code of the requantization Q(alpha A g),
    or an entry of the top-S.  Until then the iterates can differ only by
    rounding.  There it measures the difference of the branch's input
    (alpha A g, or the update before the threshold; relative to its max)
    and each flipped item's distance from its decision (the nearest
    codebook threshold, or its row's S-th magnitude) over the largest
    card-vs-CPU difference in its row (twice that for the top-S, whose
    threshold moves too): a ratio <= 1 is a near-tie that rounding
    decides.  Returns (iteration or None, branch, flipped items, relative
    difference, ratio)."""
    import torch

    from repro_torch.core.baselines import qiht_step

    s, m, cb = codec.cfg.s, codec.cfg.m, codec.codebook
    check(cb.dim == 1 and cb.dither is None, "qiht_replay reads a plain scalar codebook")
    taus = torch.as_tensor(cb.thresholds, dtype=torch.float32)

    def near(x, ref, flips, gap, factor):
        diff = torch.abs(x - ref)
        ratio = gap / torch.clamp(factor * diff.amax(dim=1, keepdim=True), min=1e-30)
        return (int(flips.sum()), float(diff.max() / torch.abs(ref).max()),
                float(ratio[flips].max()))

    sides = []
    for d in (dev, "cpu"):
        al = alpha.to(d)
        sides.append([torch.zeros((codes.shape[0], N), device=d), cb.decode(codes.to(d), m),
                      codec.a.to(d), torch.where(al > 0, al, torch.ones_like(al))[:, None]])
    for t in range(iters):
        xa, pre = [], []
        for side in sides:
            g, q_dq, a, safe = side
            xa.append((safe * (g @ a.T)).cpu())
            p, side[0] = qiht_step(g, q_dq, a, safe, cb, s)
            pre.append(p.cpu())
        flips = cb.encode(xa[0]) != cb.encode(xa[1])
        if flips.any():
            gap = torch.amin(torch.abs(xa[1][..., None] - taus), dim=-1)
            return (t, "requantization code") + near(xa[0], xa[1], flips, gap, 1.0)
        flips = (sides[0][0].cpu() != 0) != (sides[1][0] != 0)
        if flips.any():
            mag = torch.abs(pre[1])
            tau = torch.sort(mag, dim=1, descending=True).values[:, s - 1:s]
            return (t, "top-S entry") + near(pre[0], pre[1], flips, torch.abs(mag - tau), 2.0)
    return None, "none", 0, 0.0, 0.0


def phase_baselines(dev):
    """[baselines] The paper's baselines through ``run_federated`` at full
    width, launch counts set to 0 just before each run and read just after;
    round 0 of each against the same round on the CPU (the same A, weights
    and draws): QIHT's wire lanes differ only near a threshold, the decoded
    aggregate to NMSE <= 1e-3.  Returns (the fused encoder's launches,
    label -> (method, config, round walls, arguments) for [profile])."""
    import numpy as np
    import torch

    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.paper.mlp import run_federated

    default_cfg = FedQCSConfig(reduction_ratio=3, bits=Q, s_ratio=0.1, gamp_iters=ITERS)
    zero = dict(encode=0, qgamp=0, gamp=0, topk=0, staged=0)
    round_ms, encode = {}, 0
    for method, route, kernels, per_round in BASELINE_RUNS:
        label = f"{method} {route}"
        cfg = fed_cfg() if kernels else default_cfg
        with captured_rounds() as card:
            zero_counts()
            res = run_federated(method, steps=ROUNDS_NEW, eval_every=1, device=dev, fed_cfg=cfg)
            counts = read_counts()
        want = dict(zero, **{k: v * ROUNDS_NEW for k, v in per_round.items()})
        check(counts == want, f"{label}: launches {counts}, want {want}")
        encode += counts["encode"]
        check(all(np.isfinite(res.nmses)) and len(res.nmses) == (0 if method == "none"
                                                                  else ROUNDS_NEW),
              f"{label} nmse {res.nmses}")
        check(all(0.0 <= v <= 1.0 for v in res.accs), f"{label} accuracy {res.accs}")
        with captured_rounds() as cpu:
            run_federated(method, steps=1, device="cpu", fed_cfg=cfg)
        k0, c0 = card[0], cpu[0]
        wire = ""
        if method == "qcs-qiht":
            n_diff, lanes = wire_vs_cpu(label, k0, c0, dev)
            g_k, g_c = k0["qiht"], c0["qiht"].to(dev)
            flips = (g_k != 0) != (g_c != 0)
            n_flip = int(flips.sum())
            margin = (float(torch.abs(torch.where(flips, g_k - g_c, 0.0)).max()
                            / torch.abs(g_c).max()) if n_flip else 0.0)
            wire = (f"; {n_diff} of {lanes} wire lanes differ (each within 1e-5 of a "
                    f"threshold); QIHT support entries flipped {n_flip} of {flips.numel()} "
                    f"(largest flipped value {margin:.3g} of max|g|)")
        e = nmse(k0["ghat"], c0["ghat"].to(dev))
        print(f"[baselines] {label}: bits/entry {res.bits_per_entry} nmse "
              f"{[round(v, 6) for v in res.nmses]} accuracy {[round(v, 4) for v in res.accs]} "
              f"round ms {[round(v, 2) for v in res.round_ms]} launches {counts}; round 0 vs "
              f"the same round on the CPU: decoded aggregate NMSE {e:.3g} (<= 1e-3){wire}")
        if e > 1e-3 and method == "qcs-qiht":
            # QIHT's 50 hard thresholds amplify a near-tie at the S-th
            # magnitude into a different trajectory: the bound holds only
            # where no near-tie flips; a break must be such a flip
            codes = k0["codes"] if k0["codes"] is not None else k0["engine"].codec.unpack(
                k0["words"])
            t, branch, n_flip, rel, ratio = qiht_replay(
                codes.reshape(-1, codes.shape[-1]), k0["alpha"].reshape(-1),
                k0["engine"].codec, dev)
            print(f"[baselines] {label}: NMSE {e:.3g} breaks the bound; QIHT replayed in "
                  f"lockstep on the card and the CPU from the card's codes: the first different "
                  f"branch is at iteration {t}, {n_flip} {branch}(s), where the branch's inputs "
                  f"agree to {rel:.3g} of their max and each flipped item lies within "
                  f"{ratio:.3g} x its row's card-vs-CPU difference of its decision (a near-tie: "
                  f"<= 1)")
            check(t is not None and rel <= 1e-4 and ratio <= 1.0,
                  f"{label}: round 0 on the card vs the CPU: NMSE {e:.3g} > 1e-3, and the "
                  "divergence is not a near-tie flip")
        else:
            check(e <= 1e-3, f"{label}: round 0 on the card vs the CPU: NMSE {e:.3g} > 1e-3")
        round_ms[label] = (method, cfg, res.round_ms, {})
    return encode, round_ms


def phase_channels(dev):
    """[channels] fedqcs-ae over each noisy uplink (CHANNEL_RUNS) on the
    kernel route, launch counts per run; rayleigh's outages and the
    scheduler's un-stamp; round 0 against the same round with the plain
    versions swapped in (the same draws): NMSE <= 1e-3; each round's nmse
    stat within 1e-3 (relative) of the same run on the CPU, whose draws are
    the reference's (the reference's own run has nmse 3.856 at round 1 over
    mimo_mac lmmse n_rx=8 and 1.019 over zf n_rx=32: no bound below 1
    holds there); and the reference's ValueError for a code-domain method
    over awgn.  Returns (the launches by KERNELS name, label -> (method,
    config, round walls, arguments))."""
    import numpy as np
    import torch

    from repro_torch.paper.mlp import run_federated

    zero = dict(encode=0, qgamp=0, gamp=0, topk=0, staged=0)
    want = dict(zero, encode=ROUNDS_NEW, gamp=ROUNDS_NEW * ITERS)
    round_ms, launches = {}, {"bqcs_encode_fused": 0, "gamp_step": 0}
    for name, kw in CHANNEL_RUNS:
        label = f"fedqcs-ae lloyd_max {name}"
        with captured_rounds() as card:
            zero_counts()
            res = run_federated("fedqcs-ae", steps=ROUNDS_NEW, eval_every=1, device=dev,
                                fed_cfg=fed_cfg(), **kw)
            counts = read_counts()
        check(counts == want, f"{label}: launches {counts}, want {want}")
        launches["bqcs_encode_fused"] += counts["encode"]
        launches["gamp_step"] += counts["gamp"]
        cpu = run_federated("fedqcs-ae", steps=ROUNDS_NEW, device="cpu", fed_cfg=fed_cfg(), **kw)
        rel = max(abs(a - b) / b for a, b in zip(res.nmses, cpu.nmses))
        check(all(np.isfinite(res.nmses)) and rel <= 1e-3,
              f"{label} nmse {res.nmses} on the card, {cpu.nmses} on the CPU")
        stats = [{k: float(v) for k, v in r["stats"].items()} for r in card]
        check(all(v["nu_channel"] > 0 for v in stats), f"{label}: nu_channel {stats}")
        outages = ""
        if kw["channel"] == "rayleigh":
            masks = [r["mask"].cpu().numpy() for r in card]
            alive = np.array([[t if m[k] else -1 for k in range(K)] for t, m in enumerate(masks)])
            last = card[-1]["engine"].sched_state.last_round
            check(np.array_equal(last, alive.max(axis=0)),
                  f"{label}: last_round {last} is not each client's last live round")
            outages = f"; outages per round {[int((m == 0).sum()) for m in masks]} (un-stamped)"
        with plain_kernels():
            plain = run_federated("fedqcs-ae", steps=1, device=dev, fed_cfg=fed_cfg(), **kw)
        e = nmse(card[0]["ghat"], plain.last_ghat)
        print(f"[channels] {label}: nmse / nu_quant / nu_channel per round "
              + "; ".join(f"{v['nmse']:.6f} / {v['nu_quant']:.4g} / {v['nu_channel']:.4g}"
                          for v in stats)
              + f"; accuracy {[round(v, 4) for v in res.accs]} round ms "
              f"{[round(v, 2) for v in res.round_ms]} launches {counts}{outages}; round 0 vs "
              f"the plain versions on the card: NMSE {e:.3g} (<= 1e-3); nmse vs the same run "
              f"on the CPU {[round(v, 6) for v in cpu.nmses]}: largest relative gap {rel:.3g} "
              f"(<= 1e-3)")
        check(e <= 1e-3, f"{label}: kernel round vs plain round NMSE {e:.3g} > 1e-3")
        round_ms[label] = ("fedqcs-ae", fed_cfg(), res.round_ms, kw)
    for method in ("fedqcs-ea", "qcs-dither"):
        try:
            run_federated(method, steps=1, device=dev, fed_cfg=fed_cfg(), channel="awgn")
        except ValueError as err:
            check("exact codes" in str(err), f"{method} over awgn: {err}")
            print(f"[channels] {method} over awgn raises ValueError: {str(err)[:72]}...")
        else:
            raise RuntimeError(f"{method} over awgn ran; the reference raises ValueError")
    torch.cuda.synchronize()
    return launches, round_ms


# [knobs]: fedqcs-ae lloyd_max on the kernel route at full width with the
# round's remaining knobs: the AE decode in G groups (gamp_step at G x 10
# rows), the per-client loop oracle (the fused encoder at 10 rows, once per
# client) and examples/fed_snr_sweep_torch.py's scenario at K = 100.
KNOB_GROUPS = (3, 10)
SWEEP = dict(k_devices=100, partition="dirichlet", alpha=0.1, scheduler="uniform",
             sample_frac=0.3, dropout=0.25, channel="awgn", snr_db=10.0, server="fedavgm",
             chunk=10)


def phase_knobs(dev):
    """[knobs] The AE decode at G = 3 and G = 10 (25 gamp_step launches a
    round on G x 10 rows; round 0 against the plain versions on the card,
    NMSE <= 1e-3), ``impl="loop"`` against ``impl="vmap"`` from the same
    seed (30 encoder launches a round against 1; round 0's wire words and
    the parameters after 2 rounds bit-identical), and the SNR sweep's
    scenario (dirichlet alpha 0.1, uniform 30% of 100 clients, dropout 0.25,
    awgn 10 dB, fedavgm, chunk 10) with its chunked gradients held against
    one pass (reported).  Returns (the launches by KERNELS name, label ->
    (method, config, round walls, arguments) for [profile])."""
    import numpy as np
    import torch

    from repro_torch.paper.mlp import run_federated

    zero = dict(encode=0, qgamp=0, gamp=0, topk=0, staged=0)
    want = dict(zero, encode=ROUNDS_NEW, gamp=ROUNDS_NEW * ITERS)
    round_ms = {}
    launches = {"bqcs_encode_fused": 0, "gamp_step": 0, "bqcs_encode_fused[10 rows]": 0}
    for g in KNOB_GROUPS:
        label = f"fedqcs-ae lloyd_max G={g}"
        with captured_rounds() as card:
            zero_counts()
            res = run_federated("fedqcs-ae", steps=ROUNDS_NEW, eval_every=1, device=dev,
                                fed_cfg=fed_cfg(), groups=g)
            counts = read_counts()
        check(counts == want, f"{label}: launches {counts}, want {want}")
        check(all(np.isfinite(res.nmses)) and max(res.nmses) < 1.0, f"{label} nmse {res.nmses}")
        with plain_kernels():
            plain = run_federated("fedqcs-ae", steps=1, device=dev, fed_cfg=fed_cfg(), groups=g)
        e = nmse(card[0]["ghat"], plain.last_ghat)
        check(e <= 1e-3, f"{label}: kernel round vs plain round NMSE {e:.3g} > 1e-3")
        print(f"[knobs] {label} (gamp_step on {g * 10} rows): nmse "
              f"{[round(v, 6) for v in res.nmses]} accuracy {[round(v, 4) for v in res.accs]} "
              f"round ms {[round(v, 2) for v in res.round_ms]} launches {counts} "
              f"({counts['gamp'] // ROUNDS_NEW} gamp_step a round); round 0 vs the plain "
              f"versions on the card: NMSE {e:.3g} (<= 1e-3)")
        launches["bqcs_encode_fused"] += counts["encode"]
        launches[f"gamp_step[{g * 10} rows]"] = counts["gamp"]
        round_ms[label] = ("fedqcs-ae", fed_cfg(), res.round_ms, dict(groups=g))

    runs = {}
    for impl in ("vmap", "loop"):
        with captured_rounds() as rounds:
            zero_counts()
            res = run_federated("fedqcs-ae", steps=ROUNDS_NEW, eval_every=1, device=dev,
                                fed_cfg=fed_cfg(), impl=impl)
            counts = read_counts()
        per_round = K if impl == "loop" else 1
        want_impl = dict(want, encode=ROUNDS_NEW * per_round)
        check(counts == want_impl, f"impl={impl}: launches {counts}, want {want_impl}")
        runs[impl] = (rounds, res, counts)
    # the vmap run is [main]'s AE lloyd_max round; only the loop is new
    round_ms["fedqcs-ae lloyd_max impl=loop"] = ("fedqcs-ae", fed_cfg(), runs["loop"][1].round_ms,
                                                 dict(impl="loop"))
    (vm, res_v, counts_v), (lp, res_l, counts_l) = runs["vmap"], runs["loop"]
    check(torch.equal(vm[0]["words"], lp[0]["words"]),
          "round 0: the loop oracle's wire words differ from the batched encode's")
    params_v, params_l = vm[-1]["engine"].params, lp[-1]["engine"].params
    same = all(torch.equal(params_v[k], params_l[k]) for k in params_v)
    check(same and res_v.nmses == res_l.nmses,
          "impl=loop vs impl=vmap: parameters or nmse differ after 2 rounds")
    launches["bqcs_encode_fused"] += counts_v["encode"]
    launches["bqcs_encode_fused[10 rows]"] = counts_l["encode"]
    launches["gamp_step"] += counts_v["gamp"] + counts_l["gamp"]
    print(f"[knobs] fedqcs-ae lloyd_max impl=loop vs impl=vmap, same seed: round 0 wire words "
          f"bit-identical ({vm[0]['words'].numel()} words), parameters after {ROUNDS_NEW} rounds "
          f"bit-identical, nmse {[round(v, 6) for v in res_l.nmses]}; encoder launches "
          f"{counts_l['encode']} (loop, 10 rows each) vs {counts_v['encode']} (vmap, 300 "
          f"rows); round ms loop {[round(v, 2) for v in res_l.round_ms]} vs vmap "
          f"{[round(v, 2) for v in res_v.round_ms]}")

    label = "fedqcs-ae lloyd_max SNR-sweep scenario"
    with captured_rounds() as sw:
        zero_counts()
        res = run_federated("fedqcs-ae", steps=ROUNDS_NEW, eval_every=1, device=dev,
                            fed_cfg=fed_cfg(), **SWEEP)
        counts = read_counts()
    check(counts == want, f"{label}: launches {counts}, want {want}")
    stats = [{k: float(v) for k, v in r["stats"].items()} for r in sw]
    check(all(np.isfinite(list(v.values())).all() for v in stats) and len(res.nmses) == ROUNDS_NEW,
          f"{label}: stats {stats}")
    cohorts = [(r["rhos"].numel(), int((r["rhos"] > 0).sum())) for r in sw]
    check(all(c == 30 for c, _ in cohorts), f"{label}: cohorts {cohorts}, want 30")
    with captured_rounds() as one:
        run_federated("fedqcs-ae", steps=1, device=dev, fed_cfg=fed_cfg(),
                      **dict(SWEEP, chunk=0))
    diff = torch.abs(sw[0]["blocks"] - one[0]["blocks"])
    launches["bqcs_encode_fused"] += counts["encode"]
    launches["gamp_step"] += counts["gamp"]
    print(f"[knobs] {label} (K=100 dirichlet alpha=0.1, uniform 0.3, dropout 0.25, awgn 10 dB, "
          f"fedavgm, chunk=10): nmse / nu_quant / nu_channel per round "
          + "; ".join(f"{v['nmse']:.6f} / {v['nu_quant']:.4g} / {v['nu_channel']:.4g}"
                      for v in stats)
          + f"; cohort/participating {cohorts}; accuracy {[round(v, 4) for v in res.accs]} "
          f"round ms {[round(v, 2) for v in res.round_ms]} launches {counts}; round 0 gradients "
          f"chunk=10 vs one pass: {int((diff > 0).sum())} of {diff.numel()} entries differ, max "
          f"abs {float(diff.max()):.3g}")
    round_ms[label] = ("fedqcs-ae", fed_cfg(), res.round_ms, SWEEP)
    torch.cuda.synchronize()
    return launches, round_ms


# FedAdam's eps (run_federated's ServerOptConfig): its first step is
# lr * g / (|g| + eps), so on an entry whose aggregate g is O(eps) a 1e-9
# difference in g moves the step by ~1% of lr.  Parameters are held to 1e-5
# where the barrier aggregate was >= 100 eps in every round so far, and to
# the Adam step bound 2 lr a round on the rest (counted and printed).
ADAM_EPS, LR = 1e-8, 0.003


def _param_gaps(a, b, tiny):
    """(max gap where ``tiny`` is off, max gap where it is on, entries on)
    between engines ``a`` and ``b``; ``tiny`` maps each parameter to its
    mask of entries whose barrier aggregate was < 100 eps in some round."""
    import torch

    def gap(on: bool) -> float:
        d = torch.cat([(a.params[k] - b.params[k]).abs()[tiny[k] == on].reshape(-1)
                       for k in a.params])
        return float(d.max()) if d.numel() else 0.0

    return gap(False), gap(True), int(sum(int(torch.sum(m)) for m in tiny.values()))


def phase_stream(dev):
    """[stream] Streamed rounds (``StreamConfig(**STREAM)``) at full width on
    the kernel route, each round's launch counts set to 0 just before and
    read just after: (a) AE and (b) EA against the barrier round of an
    engine in the same state (decoded aggregate NMSE <= 1e-8, the reference's
    pin; parameters within 1e-5) and round 0 against the streamed round with
    the plain versions (NMSE <= 1e-3); (c) a blackout round (every client
    past the deadline): a zero update, every residual carrying its full
    gradient bit for bit, nobody stamped; (d) awgn 20 dB, 8-client batches
    against one 30-client batch (NMSE <= 1e-8: per-client noise); (e)
    mimo_mac lmmse, n_rx = 8 (finite nmse).  Returns (the launches by
    KERNELS name, label -> (method, config, round walls, arguments) for
    [profile])."""
    import numpy as np
    import torch

    from repro_torch.core.compression import blocks_to_tree
    from repro_torch.fed.stream import StreamConfig
    from repro_torch.paper.mlp import mlp_engine

    scfg = StreamConfig(**STREAM)
    zero = dict(encode=0, qgamp=0, gamp=0, topk=0, staged=0)
    launches = {"bqcs_encode_fused": 0, "gamp_step": 0, "qgamp_step[80 rows]": 0}
    round_ms = {}

    def streamed_round(eng, want, label):
        zero_counts()
        t0 = time.perf_counter()
        stats = eng.run_round()  # ends in a device sync (the float() of its stats)
        wall = 1e3 * (time.perf_counter() - t0)
        counts = read_counts()
        check(counts == dict(zero, **want), f"{label}: launches {counts}, want {want}")
        launches["bqcs_encode_fused"] += counts["encode"]
        launches["gamp_step"] += counts["gamp"]
        launches["qgamp_step[80 rows]"] += counts["qgamp"]
        return stats, wall, counts

    def report(label, stats, walls, counts):
        print(f"[stream] {label}: round wall ms {[round(v, 3) for v in walls]}, launches "
              f"{counts}, batches admitted {stats['batches_admitted']:g}, "
              f"peak_live_stats_bytes {stats['peak_live_stats_bytes']:g}, "
              f"buffer_peak_occupancy {stats['buffer_peak_occupancy']:g}, tree tiers "
              f"{stats['tree_tiers']:g}, nmse {stats['nmse']:.6f}, participating "
              f"{stats['participating']:g}")

    # (a), (b): streamed vs barrier from the same engine state
    for method in ("fedqcs-ae", "fedqcs-ea"):
        label = f"{method} lloyd_max streamed"
        want = dict(encode=1, gamp=ITERS) if method == "fedqcs-ae" else dict(
            encode=1, qgamp=STREAM_BATCHES * ITERS)
        barrier, _ = mlp_engine(method, fed_cfg=fed_cfg(), device=dev)
        streamed, _ = mlp_engine(method, fed_cfg=fed_cfg(), device=dev, stream=scfg)
        walls, errs, gaps = [], [], []
        tiny = {k: torch.zeros_like(v, dtype=torch.bool) for k, v in barrier.params.items()}
        for r in range(ROUNDS_NEW):
            barrier.run_round()
            stats, wall, counts = streamed_round(streamed, want, label)
            check(stats["batches_admitted"] == STREAM_BATCHES and stats["participating"] == K,
                  f"{label}: round {r} stats {stats}")
            errs.append(nmse(streamed.last_ghat, barrier.last_ghat))
            for k, g in blocks_to_tree(barrier.last_ghat, barrier.layout).items():
                tiny[k] |= g.abs() < 100 * ADAM_EPS
            gaps.append(_param_gaps(streamed, barrier, tiny))
            check(errs[-1] <= 1e-8, f"{label} round {r}: NMSE {errs[-1]:.3g} against the "
                  "barrier round breaks the 1e-8 pin")
            check(gaps[-1][0] <= 1e-5 and gaps[-1][1] <= 2 * LR * (r + 1),
                  f"{label} round {r}: parameters {gaps[-1]} from the barrier run's (atol "
                  "1e-5 where the aggregate was >= 100 eps, 2 lr a round elsewhere)")
            walls.append(wall)
            if r == 0:
                ghat0 = streamed.last_ghat.clone()
        with plain_kernels():
            plain, _ = mlp_engine(method, fed_cfg=fed_cfg(), device=dev, stream=scfg)
            plain.run_round()
        e_plain = nmse(ghat0, plain.last_ghat)
        check(e_plain <= 1e-3, f"{label}: round 0 vs the plain versions NMSE {e_plain:.3g}")
        report(label, stats, walls, counts)
        print(f"[stream] {label}: vs the barrier round from the same state, NMSE per round "
              f"{[float(f'{e:.3g}') for e in errs]} (<= 1e-8); max parameter gap per round where "
              f"the aggregate was >= 100 Adam eps {[float(f'{g[0]:.3g}') for g in gaps]} "
              f"(<= 1e-5), on the {gaps[-1][2]} entries where it was not "
              f"{[float(f'{g[1]:.3g}') for g in gaps]} (<= 2 lr a round); round 0 vs the plain "
              f"versions on the card NMSE {e_plain:.3g} (<= 1e-3)")
        round_ms[label] = (method, fed_cfg(), walls, dict(stream=scfg))

    # (c) blackout: nobody beats the deadline
    label = "fedqcs-ae blackout"
    black = StreamConfig(**dict(STREAM, deadline=8.0, straggler_prob=1.0,
                                straggler_mult=1e12))
    eng, _ = mlp_engine("fedqcs-ae", fed_cfg=fed_cfg(), device=dev, stream=black)
    params0 = {k: v.clone() for k, v in eng.params.items()}
    blocks = eng._grad_blocks(eng.data.cohort_batch(0, np.arange(K)))
    stats, wall, counts = streamed_round(eng, dict(encode=1), label)
    check(stats["participating"] == 0.0 and stats["arrived"] == 0.0, f"{label}: {stats}")
    check(all(torch.equal(eng.params[k], v) for k, v in params0.items()),
          f"{label}: the parameters moved")
    check(torch.equal(eng.residuals, blocks), f"{label}: a residual lost part of its gradient")
    check(not bool(eng.last_ghat.any()) and bool((eng.sched_state.last_round == -1).all()),
          f"{label}: a nonzero update or a stamped client")
    print(f"[stream] {label} (straggler_prob 1, mult 1e12): participating 0, arrived 0; "
          f"parameters unchanged, residuals == the round's gradients bit for bit, nobody "
          f"stamped; wall {wall:.3f} ms, launches {counts}")

    # (d) awgn 20 dB: the received noise is drawn per client, so the batching
    # does not change the observation
    out = {}
    for batch in (STREAM["batch_clients"], K):
        label = f"fedqcs-ae awgn 20 dB streamed, {batch}-client batches"
        eng, _ = mlp_engine("fedqcs-ae", fed_cfg=fed_cfg(), device=dev, channel="awgn",
                            snr_db=20.0, stream=StreamConfig(**dict(STREAM,
                                                                    batch_clients=batch)))
        stats, wall, counts = streamed_round(eng, dict(encode=1, gamp=ITERS), label)
        out[batch] = eng.last_ghat
        report(label, stats, [wall], counts)
    e = nmse(out[STREAM["batch_clients"]], out[K])
    check(e <= 1e-8, f"awgn streamed: batching changed the decode, NMSE {e:.3g} > 1e-8")
    print(f"[stream] fedqcs-ae awgn 20 dB: {STREAM['batch_clients']}-client batches vs one "
          f"{K}-client batch, NMSE {e:.3g} (<= 1e-8)")

    # (e) mimo_mac lmmse, one superimposed reception per admitted batch
    label = "fedqcs-ae mimo_mac lmmse n_rx=8 streamed"
    eng, _ = mlp_engine("fedqcs-ae", fed_cfg=fed_cfg(), device=dev, channel="mimo_mac", n_rx=8,
                        stream=scfg)
    walls = []
    for _ in range(ROUNDS_NEW):
        stats, wall, counts = streamed_round(eng, dict(encode=1, gamp=ITERS), label)
        check(np.isfinite(stats["nmse"]), f"{label}: nmse {stats['nmse']}")
        walls.append(wall)
    report(label, stats, walls, counts)
    torch.cuda.synchronize()
    return launches, round_ms


def bias_budget(name, shape):
    """[layout]'s per-segment budget: s_ratio 0.05 on the biases (s = 79),
    the config's 0.1 (S = 159) elsewhere."""
    return 0.05 if name.startswith("['b") else None


def phase_layout(dev):
    """[layout] The MLP's per-tensor layout (13 block rows a client) through
    ``run_federated`` at full width on the kernel route, each run's launch
    counts set to 0 just before and read just after, and round 0 of each
    against the same round with the plain versions (NMSE <= 1e-3): (a) EA
    and (b) AE one-pass rounds (the encoder at 390 rows; qgamp_step at 390,
    gamp_step at 13); (c) ``encode_stream`` EA (four encoder launches a
    round, 30, 30, 300 and 30 rows): round 0's wire and the residuals and
    parameters after 2 rounds bit-identical to (a); (d) per-segment budgets
    (s = 79 on the biases); (e) ``grad_accum=2`` with batch 2 a client;
    (f) ``api.reconstruct(emit=)`` on (a)'s round-0 payload: 4 segments,
    qgamp_step at 30 and 300 rows, within NMSE 1e-4 of the whole-grid
    decode; (g) streamed AE and EA rounds over the per-tensor layout (EA
    folds 8 clients x 13 rows = 104) against (a)/(b) (NMSE <= 1e-8); (h)
    the default route's (no kernel) streamed vs one-pass wire, differing
    lanes counted, each within 1e-5 of a threshold.  Returns (the launches
    by KERNELS name, label -> (method, config, round walls, arguments) for
    [profile])."""
    import numpy as np
    import torch

    from repro_torch.core import api
    from repro_torch.core.compression import BQCSCodec, CompressedGradient
    from repro_torch.core.layout import GradientLayout
    from repro_torch.core.sensing import project_blocks
    from repro_torch.core.sparsify import block_sparsify
    from repro_torch.fed.stream import StreamConfig
    from repro_torch.paper.mlp import init_mlp, run_federated

    zero = dict(encode=0, qgamp=0, gamp=0, topk=0, staged=0)
    names = ("bqcs_encode_fused", "bqcs_encode_fused[390 rows]", "bqcs_encode_fused[30 rows]",
             "qgamp_step", "qgamp_step[390 rows]", "qgamp_step[30 rows]",
             "qgamp_step[104 rows]", "gamp_step[13 rows]")
    launches = {k: 0 for k in names}
    round_ms, runs = {}, {}
    n_small = sum(r == 1 for r in LAYOUT_SEG_ROWS)  # 1-row segments: 30-row launches
    budgets = GradientLayout.per_tensor(init_mlp(0, device="cpu"), N, s_ratio=bias_budget)
    check(budgets.segment_s(S) == [BIAS_S, BIAS_S, S, S], f"budgets {budgets.segment_s(S)}")
    per_tensor = dict(layout="per_tensor")
    streamed = dict(layout="per_tensor", encode_stream=True)
    # label -> (method, run_federated arguments, launches a round by KERNELS name)
    plan = {
        "fedqcs-ea per_tensor": ("fedqcs-ea", per_tensor, {
            "bqcs_encode_fused[390 rows]": 1, "qgamp_step[390 rows]": ITERS}),
        "fedqcs-ae per_tensor": ("fedqcs-ae", per_tensor, {
            "bqcs_encode_fused[390 rows]": 1, "gamp_step[13 rows]": ITERS}),
        "fedqcs-ea per_tensor encode_stream": ("fedqcs-ea", streamed, {
            "bqcs_encode_fused[30 rows]": n_small, "bqcs_encode_fused": 1,
            "qgamp_step[390 rows]": ITERS}),
        "fedqcs-ea per-segment budgets": ("fedqcs-ea", dict(layout=budgets, encode_stream=True), {
            "bqcs_encode_fused[30 rows]": n_small, "bqcs_encode_fused": 1,
            "qgamp_step[390 rows]": ITERS}),
        "fedqcs-ea per_tensor grad_accum=2 batch 2": ("fedqcs-ea", dict(
            streamed, grad_accum=2, batch_per_device=2), {
            "bqcs_encode_fused[30 rows]": n_small, "bqcs_encode_fused": 1,
            "qgamp_step[390 rows]": ITERS}),
        "fedqcs-ae per_tensor streamed": ("fedqcs-ae", dict(
            per_tensor, stream=StreamConfig(**STREAM)), {
            "bqcs_encode_fused[390 rows]": 1, "gamp_step[13 rows]": ITERS}),
        "fedqcs-ea per_tensor streamed": ("fedqcs-ea", dict(
            per_tensor, stream=StreamConfig(**STREAM)), {
            "bqcs_encode_fused[390 rows]": 1, "qgamp_step[104 rows]": STREAM_BATCHES * ITERS}),
    }
    module = {"bqcs_encode_fused": "encode", "qgamp_step": "qgamp", "gamp_step": "gamp"}
    for label, (method, kw, per_round) in plan.items():
        want = dict(zero)
        for kname, n in per_round.items():
            want[module[kname.split("[")[0]]] += n * ROUNDS_NEW
        with captured_rounds() as rec:
            zero_counts()
            res = run_federated(method, steps=ROUNDS_NEW, eval_every=1, device=dev,
                                fed_cfg=fed_cfg(), **kw)
            counts = read_counts()
        check(counts == want, f"[layout] {label}: launches {counts}, want {want}")
        check(all(np.isfinite(res.nmses)) and max(res.nmses) < 1.0, f"{label} nmse {res.nmses}")
        eng = rec[-1]["engine"]
        check(eng.nb == 13 and tuple(rec[0]["ghat"].shape) == (13, N), f"{label}: nb {eng.nb}")
        with plain_kernels():
            plain = run_federated(method, steps=1, device=dev, fed_cfg=fed_cfg(), **kw)
        e = nmse(rec[0]["ghat"], plain.last_ghat)
        check(e <= 1e-3, f"[layout] {label}: kernel round vs plain round NMSE {e:.3g} > 1e-3")
        for kname, n in per_round.items():
            launches[kname] += n * ROUNDS_NEW
        runs[label] = (rec, res)
        round_ms[label] = (method, fed_cfg(), res.round_ms, kw)
        print(f"[layout] {label}: nmse {[round(v, 6) for v in res.nmses]} accuracy "
              f"{[round(v, 4) for v in res.accs]} round ms {[round(v, 2) for v in res.round_ms]} "
              f"launches {counts} ({per_round} a round); round 0 vs the plain versions on the "
              f"card: NMSE {e:.3g} (<= 1e-3)")

    # (c) the streamed encode against the one-pass encode from the same seed
    (one, res_1), (two, res_2) = (runs["fedqcs-ea per_tensor"],
                                  runs["fedqcs-ea per_tensor encode_stream"])
    e1, e2 = one[-1]["engine"], two[-1]["engine"]
    check(torch.equal(one[0]["words"], two[0]["words"])
          and torch.equal(one[0]["alpha"], two[0]["alpha"]),
          "[layout] round 0: the streamed encode's wire differs from the one-pass encode's")
    check(torch.equal(e1.residuals, e2.residuals)
          and all(torch.equal(e1.params[k], e2.params[k]) for k in e1.params)
          and res_1.nmses == res_2.nmses,
          "[layout] encode_stream vs one pass: residuals, parameters or nmse differ after "
          f"{ROUNDS_NEW} rounds")
    print(f"[layout] encode_stream vs one pass, same seed: round 0 wire bit-identical "
          f"({one[0]['words'].numel()} words), residuals and parameters after {ROUNDS_NEW} rounds "
          "bit-identical")
    # the bias rows hold 20 and 10 nonzeros, fewer than either budget keeps,
    # so s = 79 must leave round 0's wire as S = 159 left it
    bud = runs["fedqcs-ea per-segment budgets"][0][0]
    check(torch.equal(bud["words"], two[0]["words"]) and torch.equal(bud["alpha"],
                                                                      two[0]["alpha"]),
          "[layout] budgets: s = 79 on rows of <= 20 nonzeros changed the wire")
    print(f"[layout] per-segment budgets (s = {BIAS_S} on the bias rows, which hold 20 and 10 "
          f"nonzeros): round 0 wire bit-identical to the S = {S} streamed round's")

    # (f) the segment-local decode of (a)'s round-0 payload
    r0 = one[0]
    codec, layout = r0["engine"].codec, r0["engine"].layout
    pays = [CompressedGradient(r0["words"][k], r0["alpha"][k], layout.nbar, M, Q)
            for k in range(K)]
    ea = api.ReconSpec(mode="ea")
    whole = api.reconstruct(codec, pays, r0["rhos"], layout, recon=ea)
    fired = []
    zero_counts()
    seg_tree = api.reconstruct(codec, pays, r0["rhos"], layout, recon=ea,
                               emit=lambda seg, leaves: fired.append((seg.name, len(leaves))))
    counts = read_counts()
    check(counts == dict(zero, qgamp=len(LAYOUT_SEG_ROWS) * ITERS),
          f"[layout] emit decode launches {counts}")
    launches["qgamp_step[30 rows]"] += n_small * ITERS
    launches["qgamp_step"] += ITERS
    with plain_kernels():
        seg_plain = api.reconstruct(codec, pays, r0["rhos"], layout, recon=ea,
                                    emit=lambda seg, leaves: None)
    flat = lambda tr: torch.cat([tr[k].reshape(-1) for k in sorted(tr)])  # noqa: E731
    e_whole, e_plain = nmse(flat(seg_tree), flat(whole)), nmse(flat(seg_tree), flat(seg_plain))
    check(len(fired) == len(LAYOUT_SEG_ROWS) and e_whole <= 1e-4 and e_plain <= 1e-3,
          f"[layout] emit decode: fired {fired}, NMSE {e_whole:.3g} to the whole grid, "
          f"{e_plain:.3g} to the plain versions")

    def wall_ms(fn, reps: int = 3) -> float:  # host clock around synced calls
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    ms_whole = wall_ms(lambda: api.reconstruct(codec, pays, r0["rhos"], layout, recon=ea))
    ms_seg = wall_ms(lambda: api.reconstruct(codec, pays, r0["rhos"], layout, recon=ea,
                                             emit=lambda seg, leaves: None))
    print(f"[layout] api.reconstruct(emit=) on round 0's payload: fired {fired}; launches "
          f"{counts} (qgamp_step at 30, 30, 300 and 30 rows); NMSE {e_whole:.3g} to the "
          f"whole-grid decode (<= 1e-4), {e_plain:.3g} to the plain versions (<= 1e-3); wall "
          f"{ms_seg:.3f} ms against {ms_whole:.3f} ms for the whole grid (host clock, synced)")

    # (g) streamed rounds over the per-tensor layout against the barrier rounds
    for method, barrier in (("fedqcs-ae", "fedqcs-ae per_tensor"),
                            ("fedqcs-ea", "fedqcs-ea per_tensor")):
        e = nmse(runs[f"{method} per_tensor streamed"][0][0]["ghat"], runs[barrier][0][0]["ghat"])
        check(e <= 1e-8, f"[layout] {method} streamed vs barrier round 0: NMSE {e:.3g} > 1e-8")
        print(f"[layout] {method} per_tensor streamed vs the barrier round from the same seed: "
              f"round 0 NMSE {e:.3g} (<= 1e-8)")

    # (h) the default route's streamed vs one-pass wire on (a)'s round-0 gradients
    blocks = r0["blocks"].reshape(-1, N)
    xla = BQCSCodec(dataclasses.replace(fed_cfg(), block_size=N, use_kernels=False),
                    a=codec.a, device=dev)
    zeros = torch.zeros_like(blocks)
    one_pass = xla.compress_blocks_packed(blocks, zeros)[0].reshape(K, 13, -1)
    b3 = r0["blocks"]
    seg_words = torch.cat([xla.compress_blocks_packed(
        b3[:, seg.row_slice].reshape(-1, N), zeros[:K * seg.rows])[0].reshape(K, seg.rows, -1)
        for seg in layout.segments], dim=1)
    diff = xla.unpack(seg_words) != xla.unpack(one_pass)
    n_diff = int(diff.sum())
    if n_diff:
        sparse, _ = block_sparsify(blocks, S)
        x, _ = project_blocks(sparse, xla.a.T)
        gap = torch.amin(torch.abs(x[..., None] - xla.codebook.thresholds_t(dev)), dim=-1)
        check(float(gap.reshape(diff.shape)[diff].max()) < 1e-5,
              "[layout] default route: a streamed wire lane differs away from a threshold")
    print(f"[layout] default route (no kernel), streamed vs one-pass wire on round 0's "
          f"gradients: {n_diff} of {diff.numel()} code lanes differ (each within 1e-5 of a "
          "threshold)")
    torch.cuda.synchronize()
    return launches, round_ms


def phase_record(dev):
    """[record] ``run_federated(obs=JsonlRecorder(dir))``: 3 recorded rounds
    each of fedqcs-ae and fedqcs-ea (run directories in a temporary
    directory), each run's directory validated, its returned stats and
    decoded aggregate held equal to an unrecorded run from the same seed,
    and each round's ``phase_ms`` and ``round_ms`` printed (the recorded
    phases end in a device sync); then one more recorded run of each under
    ``torch.profiler`` with every phase a ``record_function`` range
    (``REPRO_TRACE_ANNOTATIONS``' switch, ``obs.trace.ANNOTATE``): each
    phase's device busy time beside its wall (``_phase_device_ms``); then a
    streamed AE engine run under an ``InMemoryRecorder``, held equal to its
    unrecorded run.  Launch counts set to 0 just before each recorded run
    and read just after.  Returns the launches by KERNELS name."""
    import tempfile

    import torch

    from repro_torch.fed.stream import StreamConfig
    from repro_torch.obs import InMemoryRecorder, JsonlRecorder
    from repro_torch.obs.reader import load_rounds, summarize, validate_dir
    from repro_torch.paper.mlp import mlp_engine, run_federated

    rounds = 3
    zero = dict(encode=0, qgamp=0, gamp=0, topk=0, staged=0)
    launches = {"bqcs_encode_fused": 0, "gamp_step": 0, "qgamp_step": 0}

    def show(label, events):
        for ev in events:
            phases = ", ".join(f"{k} {v:.3f}" for k, v in ev["phase_ms"].items())
            print(f"[record] {label} round {ev['round']}: phase_ms {{{phases}}} round_ms "
                  f"{ev['round_ms']:.3f} (nmse {ev['nmse']:.6f}, gamp_iters_mean "
                  f"{ev.get('gamp_iters_mean', float('nan')):g}, clip_saturation "
                  f"{ev['clip_saturation']:.4f})")

    with tempfile.TemporaryDirectory() as tmp:
        for method in ("fedqcs-ae", "fedqcs-ea"):
            run_dir = f"{tmp}/{method}"
            rec = JsonlRecorder(run_dir, config={"method": method, "rounds": rounds})
            zero_counts()
            res = run_federated(method, steps=rounds, eval_every=1, device=dev,
                                fed_cfg=fed_cfg(), obs=rec)
            counts = read_counts()
            rec.close()
            want = dict(zero, encode=rounds, **({"gamp": rounds * ITERS} if method == "fedqcs-ae"
                                                else {"qgamp": rounds * ITERS}))
            check(counts == want, f"[record] {method}: launches {counts}, want {want}")
            launches["bqcs_encode_fused"] += counts["encode"]
            launches["gamp_step"] += counts["gamp"]
            launches["qgamp_step"] += counts["qgamp"]
            problems = validate_dir(run_dir)
            check(problems == [], f"[record] {method}: {problems}")
            plain = run_federated(method, steps=rounds, eval_every=1, device=dev,
                                  fed_cfg=fed_cfg())
            check(res.nmses == plain.nmses and res.accs == plain.accs
                  and torch.equal(res.last_ghat, plain.last_ghat),
                  f"[record] {method}: recording changed the run ({res.nmses} vs {plain.nmses})")
            events = load_rounds(run_dir)
            check(len(events) == rounds, f"[record] {method}: {len(events)} round events")
            show(method, events)
            walls = [round(v, 3) for v in res.round_ms]
            print(f"[record] {method}: run directory valid, stats and decoded aggregate equal to "
                  f"the unrecorded run's; recorded round walls {walls} vs unrecorded "
                  f"{[round(v, 3) for v in plain.round_ms]}; launches {counts}")
            print("\n".join(f"[record] | {line}" for line in summarize(run_dir).splitlines()))

    # each recorded phase as a torch.profiler range (the spans' annotations):
    # the device time that ran inside each phase, beside its wall
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    for method in ("fedqcs-ae", "fedqcs-ea"):
        rec = InMemoryRecorder()
        trace.ANNOTATE = True
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run_federated(method, steps=rounds, device=dev, fed_cfg=fed_cfg(), obs=rec)
                torch.cuda.synchronize()
        finally:
            trace.ANNOTATE = False
        walls = [ev["phase_ms"] for ev in rec.events if ev["kind"] == "round"][1:]
        parts = []
        per_phase = _phase_device_ms(prof.events(), set(walls[0]))
        for name in walls[0]:
            busy, wall = per_phase[name], sum(w[name] for w in walls) / len(walls)
            if busy is None or len(busy) != rounds:
                parts.append(f"{name} wall {wall:.3f} ms, device busy not measured (the trace "
                             "pairs its host and device ranges otherwise)")
                continue
            parts.append(f"{name} wall {wall:.3f} ms, device busy "
                         f"{sum(busy[1:]) / len(busy[1:]):.4f} ms")
        print(f"[record] {method}, rounds 1-{rounds - 1} under torch.profiler with each phase a "
              f"range: " + "; ".join(parts))

    rec = InMemoryRecorder()
    label = "fedqcs-ae streamed"
    eng, _ = mlp_engine("fedqcs-ae", fed_cfg=fed_cfg(), device=dev,
                        stream=StreamConfig(**STREAM), obs=rec)
    ref, _ = mlp_engine("fedqcs-ae", fed_cfg=fed_cfg(), device=dev,
                        stream=StreamConfig(**STREAM))
    for _ in range(rounds):
        stats, stats_ref = eng.run_round(), ref.run_round()
        check({k: stats[k] for k in stats_ref} == stats_ref,
              f"[record] {label}: recording changed the round ({stats} vs {stats_ref})")
    check(torch.equal(eng.last_ghat, ref.last_ghat), f"[record] {label}: decode differs")
    show(label, [ev for ev in rec.events if ev["kind"] == "round"])
    return launches


ROUND_RANGE = "chip_smoke.round"


def _round_device_ms(method, cfg, dev, steps: int, run_kw: dict) -> list:
    """Device events (kernels, copies) of each round of one ``run_federated``
    run, from one ``torch.profiler`` trace: per round, name -> [count, ms].
    Each ``CohortEngine.run_round`` runs inside a ``record_function`` range
    and ends in a device sync (the float() of its stats), so the round's
    device work starts and ends inside it.  The trace gives the range on the
    host's clock and, as a device annotation, from its first to its last
    kernel on the device's clock; a device event belongs to the round whose
    window (the union of the two) holds its start, so no event is lost to a
    skew between the clocks, and the evaluation between rounds falls in no
    round, as in the round wall.  The trace starts at the first round, so
    the engine's set-up (data, A, parameters) is neither traced nor parsed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.fed.engine import CohortEngine
    from repro_torch.paper.mlp import run_federated

    run_round = CohortEngine.run_round
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def traced(self):
        if prof.profiler is None:
            torch.cuda.synchronize()
            prof.start()
        with record_function(ROUND_RANGE):
            return run_round(self)

    CohortEngine.run_round = traced
    try:
        run_federated(method, steps=steps, device=dev, fed_cfg=cfg, **run_kw)
        torch.cuda.synchronize()
    finally:
        CohortEngine.run_round = run_round
        if prof.profiler is not None:
            prof.stop()
    events = prof.events()
    host, device = ([(e.time_range.start, e.time_range.end) for e in events
                     if e.name == ROUND_RANGE and (e.device_type == DeviceType.CPU) == on_host]
                    for on_host in (True, False))
    spans = sorted(host)
    if len(device) == len(host):
        spans = [(min(h[0], d[0]), max(h[1], d[1])) for h, d in zip(spans, sorted(device))]
    rounds = [{} for _ in spans]
    for e in events:
        if e.device_type == DeviceType.CPU or e.name == ROUND_RANGE:
            continue
        for per, (lo, hi) in zip(rounds, spans):
            if lo <= e.time_range.start <= hi:
                c, ms = per.get(e.name, (0, 0.0))
                per[e.name] = [c + 1, ms + e.time_range.elapsed_us() / 1e3]
                break
    return rounds


def _phase_device_ms(events, names) -> dict:
    """Device ms per occurrence of each round phase in ``names`` (the
    engine's spans as ``record_function`` ranges, in start order), or None
    for a phase whose device annotations do not pair one to one with its
    host ranges.  A phase's window is its device annotation (the device
    clock, from its first to its last kernel): a recorded phase ends in a
    device sync, so its work does not spill into the next, and every
    device event counts in the one window that holds its start."""
    from torch.autograd import DeviceType

    host, dev = {n: 0 for n in names}, {n: [] for n in names}
    for e in events:
        if e.name in names:
            if e.device_type == DeviceType.CPU:
                host[e.name] += 1
            else:
                dev[e.name].append((e.time_range.start, e.time_range.end))
    busy = {n: [0.0] * len(dev[n]) for n in names}
    windows = sorted((lo, hi, n, i) for n in names for i, (lo, hi) in enumerate(sorted(dev[n])))
    for e in events:
        if e.device_type == DeviceType.CPU or e.name in names:
            continue
        for lo, hi, n, i in windows:
            if lo <= e.time_range.start <= hi:
                busy[n][i] += e.time_range.elapsed_us() / 1e3
                break
    return {n: busy[n] if len(dev[n]) == host[n] else None for n in names}


def phase_profile(round_ms, dev):
    """Device busy time of the steady rounds per configuration (``round_ms``:
    label -> (method, config, unprofiled round walls, run_federated's other
    arguments)), beside their
    unprofiled wall time: one traced ``run_federated`` of 3 rounds, each
    device event counted in its own round (``_round_device_ms``), and the
    mean over the rounds after the first."""
    for label, (method, cfg, ms, run_kw) in round_ms.items():
        if len(ms) < 2:
            continue
        rounds = _round_device_ms(method, cfg, dev, 3, run_kw)
        busy = [sum(t for _, t in per.values()) for per in rounds]
        wall = sum(ms[1:]) / (len(ms) - 1)
        if len(rounds) != 3 or min(busy) <= 0.0:
            print(f"[profile] {label}: the trace holds {len(rounds)} rounds with device busy "
                  f"ms {busy} (not measured)")
            continue
        steady = rounds[1:]
        mean = sum(busy[1:]) / len(steady)
        per_round = {}
        for per in steady:
            for k, (c, t) in per.items():
                pc, pt = per_round.get(k, (0.0, 0.0))
                per_round[k] = (pc + c / len(steady), pt + t / len(steady))
        top = sorted(per_round.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"[profile] {label}: device busy {mean:.4f} ms per round (rounds "
              f"{[round(v, 4) for v in busy]}) vs round wall {wall:.4f} ms, idle share "
              f"{1.0 - mean / wall:.3f}; per round: "
              + "; ".join(f"{k[:48]} x{c:g} {t:.4f} ms" for k, (c, t) in top))


def encoder_bound(k: dict, rows: int):
    """Each input read once and each output written once: blocks, residual,
    resid, the rows of A^T the kept entries touch, the dither, the words and
    alpha; FLOPs of the sparse product over the kept entries."""
    blocks, resid0, a_t, tab, s, m, q = k["args"]
    mp = a_t.shape[1]
    dither = k["kwargs"]["dither"]
    nbytes = (4 * (3 * rows * N + k["a_rows"] * mp) + 4 * rows * (k["words"] + 1)
              + 4 * tab.numel() + (0 if dither is None else 4 * dither.numel()))
    return bound_ms(nbytes, 2 * k["kept"] * m)


def gamp_step_bound(nb: int, L: int = 3):
    """The step's state in and out, A, y and nu_d; four products' FLOPs."""
    state = 4 * nb * (2 * N + M + 1 + 3 * L)
    return bound_ms(2 * state + 4 * M * N + 4 * nb * M + 4 * nb, 4 * nb * N * M)


def phase_times(dev, k_in):
    import torch

    from repro_torch.core.compression import unpack_codes
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_topk import block_topk
    from repro_torch.kernels.bqcs_encode import bqcs_encode
    from repro_torch.kernels.bqcs_encode_fused import BISECT_ITERS, bqcs_encode_fused
    from repro_torch.kernels.gamp_step import gamp_step
    from repro_torch.kernels.qgamp_step import qgamp_step

    timer = GpuTimer()
    rows = K * 10
    res = {}

    for name, key in (("bqcs_encode_fused", "encode"), ("bqcs_encode_fused[dither]",
                                                          "encode_dither"),
                      ("bqcs_encode_fused[vq]", "encode_vq"),
                      ("bqcs_encode_fused[10 rows]", "encode10"),
                      ("bqcs_encode_fused[390 rows]", "encode390"),
                      ("bqcs_encode_fused[30 rows]", "encode30")):
        k = k_in[key]
        blocks, resid0, a_t, tab, s, m, q = k["args"]
        kw = k["kwargs"]
        if tab.dim() == 2:
            plain = lambda: ref.bqcs_encode_fused_ref(  # noqa: E731
                blocks, resid0, a_t, None, s, q, centroids=tab, half_norms=kw["half_norms"])
        else:
            dith = None if kw["dither"] is None else kw["dither"][:m]
            plain = lambda: ref.bqcs_encode_fused_ref(  # noqa: E731
                blocks, resid0, a_t[:, :m], tab, s, q, dither=dith)
        b_ms, b_by = encoder_bound(k, blocks.shape[0])
        res[name] = dict(ms=timer(lambda: bqcs_encode_fused(*k["args"], **kw)),
                         ms_iters0=timer(lambda: bqcs_encode_fused(*k["args"], iters=0, **kw)),
                         plain_ms=timer(plain), bound_ms=b_ms, bound_by=b_by, library_ms=None)

    carry, s = k_in["topk"]["args"]

    def topk_library():
        idx = torch.topk(carry.abs(), s, dim=1).indices
        sparse = torch.zeros_like(carry).scatter_(1, idx, torch.gather(carry, 1, idx))
        return sparse, carry - sparse

    b_ms, b_by = bound_ms(4 * 3 * rows * N, 2 * BISECT_ITERS * rows * N)
    res["block_topk"] = dict(ms=timer(lambda: block_topk(carry, s)),
                             ms_iters0=timer(lambda: block_topk(carry, s, iters=0)),
                             plain_ms=timer(lambda: ref.block_topk_ref(carry, s)),
                             bound_ms=b_ms, bound_by=b_by, library_ms=timer(topk_library),
                             library="torch.topk + scatter")

    x, a_tt, taus = k_in["staged"]["args"]
    b_ms, b_by = bound_ms(4 * rows * N + 4 * N * M + rows * M + 4 * rows + 4 * taus.numel(),
                          2 * rows * N * M)
    res["bqcs_encode"] = dict(ms=timer(lambda: bqcs_encode(x, a_tt, taus)),
                              plain_ms=timer(lambda: ref.bqcs_encode_ref(x, a_tt, taus)),
                              bound_ms=b_ms, bound_by=b_by,
                              library_ms=timer(lambda: torch.matmul(x, a_tt)),
                              library="GEMM only")

    for name, key in (("qgamp_step", "qgamp"), ("qgamp_step[64 rows]", "qgamp64"),
                      ("qgamp_step[80 rows]", "qgamp80"), ("qgamp_step[390 rows]", "qgamp390"),
                      ("qgamp_step[30 rows]", "qgamp30"), ("qgamp_step[104 rows]", "qgamp104")):
        qa = k_in[key]["args"]
        ghat, nug, shat, theta, words, al, lo, hi, a, L, em, bits = qa
        nb_ = ghat.shape[0]
        state = 4 * nb_ * (2 * N + M + 1 + 3 * L)
        nbytes = 2 * state + 4 * M * N + 4 * words.numel() + 4 * nb_ + 8 * lo.numel()
        b_ms, b_by = bound_ms(nbytes, 4 * nb_ * N * M)
        g1, s1, a1 = k_in[key]["gemm"]
        res[name] = dict(
            ms=timer(lambda: qgamp_step(*qa)),
            plain_ms=timer(lambda: ref.qgamp_step_ref(ghat, nug, shat, theta,
                                                      unpack_codes(words, bits, M), al, lo, hi,
                                                      a, L, em)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=timer(lambda: (torch.matmul(g1, a1.T), torch.matmul(s1, a1))),
            library="GEMMs only",
        )

    for name, key in (("gamp_step", "gamp"), ("gamp_step[300 rows]", "gamp300"),
                      ("gamp_step[64 rows]", "gamp64"), ("gamp_step[30 rows]", "gamp30"),
                      ("gamp_step[100 rows]", "gamp100"), ("gamp_step[13 rows]", "gamp13")):
        ga = k_in[key]["args"]
        b_ms, b_by = gamp_step_bound(ga[0].shape[0])
        g2, s2, a2 = k_in[key]["gemm"]
        res[name] = dict(
            ms=timer(lambda: gamp_step(*ga)),
            plain_ms=timer(lambda: ref.gamp_step_ref(*ga)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=timer(lambda: (torch.matmul(g2, a2.T), torch.matmul(s2, a2))),
            library="GEMMs only",
        )
    # every cluster size of the staged encoder, then every (rows per tile,
    # blocks per cluster) of both step kernels, each first held against its plain version, then
    # timed; then the step kernels at the chooser's pick without the EM refresh
    from repro_torch.kernels import bqcs_encode as s_mod
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.kernels import qgamp_step as q_mod
    from repro_torch.kernels.gamp_step import CLUSTERS, ROWS

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pick = s_mod.launch_shape(rows, N, M, sms)
    for c in s_mod.CLUSTERS:
        rel, _, n_diff = staged_vs_plain(x, a_tt, taus, c)
        ms = timer(lambda: bqcs_encode(x, a_tt, taus, _cluster=c))
        blocks = -(-rows // s_mod.TILE_ROWS) * -(-M // s_mod.TILE_COLS) * c
        print(f"[tune] bqcs_encode {rows} rows, {s_mod.TILE_ROWS} rows per tile, cluster {c} "
              f"({blocks} blocks): {ms:.4f} ms, alpha max rel err {rel:.3g}, {n_diff} differing "
              f"code lanes" + (" (the chooser's pick)" if c == pick[1] else ""))
    for kind, key, mod in (("qgamp", "qgamp", q_mod), ("qgamp", "qgamp64", q_mod),
                           ("qgamp", "qgamp80", q_mod), ("qgamp", "qgamp390", q_mod),
                           ("qgamp", "qgamp30", q_mod), ("qgamp", "qgamp104", q_mod),
                           ("gamp", "gamp", g_mod), ("gamp", "gamp300", g_mod),
                           ("gamp", "gamp64", g_mod), ("gamp", "gamp30", g_mod),
                           ("gamp", "gamp100", g_mod), ("gamp", "gamp13", g_mod)):
        step = getattr(mod, f"{kind}_step")
        args = k_in[key]["args"]
        nb_ = args[0].shape[0]
        pick = mod.launch_shape(nb_, sms)
        for r in ROWS:
            for c in CLUSTERS:
                errs, _ = step_vs_plain(kind, args, dev, [(r, c)])
                ms = timer(lambda: step(*args, _rows=r, _cluster=c))
                print(f"[tune] {kind}_step {nb_} rows, {r} rows per tile, cluster {c} "
                      f"({-(-nb_ // r) * c} blocks): {ms:.4f} ms, max abs err {max(errs):.3g}"
                      + (" (the chooser's pick)" if (r, c) == pick else ""))
        # the em flag is the last argument of gamp_step's and next to last of
        # qgamp_step's (before bits)
        no_em = args[:-1] + (False,) if kind == "gamp" else args[:-2] + (False, args[-1])
        step_vs_plain(kind, no_em, dev, [pick])
        ms = timer(lambda: step(*no_em, _rows=pick[0], _cluster=pick[1]))
        print(f"[tune] {kind}_step {nb_} rows at the chooser's pick {pick} without the EM "
              f"refresh (em=False): {ms:.4f} ms")
    # the reference's default encode route (no kernel; for the record): the
    # stable-sort top-S, one GEMM, searchsorted, the wire packing
    from repro_torch.core import sensing, sparsify
    from repro_torch.core.compression import BQCSCodec

    blocks, resid0, a_t = k_in["encode"]["args"][:3]
    xla = BQCSCodec(dataclasses.replace(fed_cfg(), block_size=N, use_kernels=False),
                    a=a_t[:, :M].T, device=dev)
    sparse, _ = sparsify.block_sparsify(blocks + resid0, S)
    y, _ = sensing.project_blocks(sparse, xla.a.T)
    codes = xla.codebook.encode(y)
    parts = {
        "whole": lambda: xla.compress_blocks_packed(blocks, resid0),
        "sort top-S": lambda: sparsify.block_sparsify(blocks + resid0, S),
        "GEMM and scale": lambda: sensing.project_blocks(sparse, xla.a.T),
        "searchsorted": lambda: xla.codebook.encode(y),
        "pack": lambda: xla.pack(codes),
    }
    xla_ms = {k: timer(fn) for k, fn in parts.items()}
    print(f"[time] XLA-route encode {rows}x{N} -> {M} Q={Q} (the default route, no kernel): "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in xla_ms.items())
          + f" | fused encoder kernel {res['bqcs_encode_fused']['ms']:.4f} ms")
    for name, r in res.items():
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ({r['library']})")
        print(f"[time] {name}: kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | library {lib}")
    # at iters=0 the threshold stays at the row max: no bisection, and only
    # the max is kept, so the encoder projects ~1 row of A^T instead of ~159
    for name, r in res.items():
        if "ms_iters0" in r:
            print(f"[time] {name} at iters=0: kernel {r['ms_iters0']:.4f} ms (at "
                  f"iters={BISECT_ITERS}: {r['ms']:.4f} ms, difference "
                  f"{r['ms'] - r['ms_iters0']:.4f} ms)")
    return res


@contextlib.contextmanager
def kernels_from(csrc: Path):
    """Builds the kernel sources under ``csrc`` into a library of their own
    (``build.py``, keyed by their hash) and sends every wrapper's launches to
    it inside the block."""
    from repro_torch.kernels import build

    saved = build.CSRC, build._LOADED
    build.CSRC, build._LOADED = csrc, None
    try:
        yield build.library()
    finally:
        build.CSRC, build._LOADED = saved


def phase_against(dev, k_in, other: Path):
    """[against] The kernels this tree shares with the checkout at ``other``
    (the fused encoder's three branches, block_topk, qgamp_step at 300 rows,
    gamp_step at 10 and 300 rows, each step kernel at the chooser's pick and
    at cluster 1; not bqcs_encode, whose C interface may differ), run through
    this tree's wrappers on the same inputs with ``other``'s kernel library
    and with this one's.  Outputs must be bit-identical; times are taken in
    turns (other, this, this, other)."""
    import torch

    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.kernels import qgamp_step as q_mod
    from repro_torch.kernels.block_topk import block_topk
    from repro_torch.kernels.bqcs_encode_fused import bqcs_encode_fused

    csrc = other.resolve() / "src" / "repro_torch" / "csrc"
    check(csrc.is_dir(), f"no kernel sources under {csrc}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    calls = {name: functools.partial(bqcs_encode_fused, *k_in[key]["args"],
                                     **k_in[key]["kwargs"])
             for name, key in (("bqcs_encode_fused", "encode"),
                               ("bqcs_encode_fused[dither]", "encode_dither"),
                               ("bqcs_encode_fused[vq]", "encode_vq"))}
    calls["block_topk"] = functools.partial(block_topk, *k_in["topk"]["args"])
    for name, key, mod, step in (("qgamp_step", "qgamp", q_mod, q_mod.qgamp_step),
                                 ("gamp_step", "gamp", g_mod, g_mod.gamp_step),
                                 ("gamp_step[300 rows]", "gamp300", g_mod, g_mod.gamp_step)):
        args = k_in[key]["args"]
        rows, cluster = mod.launch_shape(args[0].shape[0], sms)
        for c in dict.fromkeys((cluster, 1)):
            calls[f"{name} {rows}x{c}"] = functools.partial(step, *args, _rows=rows, _cluster=c)
    timer = GpuTimer()
    with kernels_from(csrc) as lib:
        print(f"[against] {other}: {lib.path.parent.name}, nvcc build {lib.build_s:.1f} s")
        theirs = {name: fn() for name, fn in calls.items()}
        torch.cuda.synchronize()
    ms = {name: [] for name in calls}
    for turn in ("other", "this", "this", "other"):
        with kernels_from(csrc) if turn == "other" else contextlib.nullcontext():
            for name, fn in calls.items():
                ms[name].append(timer(fn))
    for name, fn in calls.items():
        ours = fn()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(ours, theirs[name]))
        check(same, f"{name}: outputs differ from {other}'s kernels")
        o1, t1, t2, o2 = ms[name]
        print(f"[against] {name}: bit-identical; ms other {o1:.4f}, this {t1:.4f}, this "
              f"{t2:.4f}, other {o2:.4f} (this / other {(t1 + t2) / (o1 + o2):.4f})")


def phase_levels(dev, k_in, levels):
    """[levels] The development sweep behind ``common.cuh``'s kLevels (levels
    per bisection pass): for each b, a copy of the kernel sources with
    kLevels = b is built into a library of its own; block_topk and the
    encoder's three branches are held against their plain versions (kept
    set and resid bit-identical, alpha to 1e-6 relative) and timed at
    iters=26 and iters=0."""
    import re
    import shutil

    import torch

    from repro_torch.kernels import build, ref
    from repro_torch.kernels.block_topk import block_topk
    from repro_torch.kernels.bqcs_encode_fused import BISECT_ITERS, bqcs_encode_fused

    timer = GpuTimer()
    carry, s = k_in["topk"]["args"]
    for b in levels:
        src = build.BUILD_ROOT / f"levels-{b}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        text, subs = re.subn(r"constexpr int kLevels = \d+;", f"constexpr int kLevels = {b};",
                             (src / "common.cuh").read_text())
        check(subs == 1, "common.cuh must define kLevels once")
        (src / "common.cuh").write_text(text)
        with kernels_from(src):
            ms = {}
            for it in (BISECT_ITERS, 0):
                sp, res = block_topk(carry, s, it)
                sp_p, res_p = ref.block_topk_ref(carry, s, it)
                torch.cuda.synchronize()
                check(torch.equal(sp, sp_p) and torch.equal(res, res_p),
                      f"kLevels={b} iters={it}: block_topk must be bit-identical")
                ms[f"block_topk iters={it}"] = timer(lambda: block_topk(carry, s, it))
                for key in ("encode", "encode_dither", "encode_vq"):
                    blocks, resid0, a_t, tab, s_, m, q = k_in[key]["args"]
                    kw = k_in[key]["kwargs"]
                    _, alpha, resid = bqcs_encode_fused(*k_in[key]["args"], it, **kw)
                    if tab.dim() == 2:
                        _, al_p, res_p = ref.bqcs_encode_fused_ref(
                            blocks, resid0, a_t, None, s_, q, it, centroids=tab,
                            half_norms=kw["half_norms"])
                    else:
                        dith = None if kw["dither"] is None else kw["dither"][:m]
                        _, al_p, res_p = ref.bqcs_encode_fused_ref(
                            blocks, resid0, a_t[:, :m], tab, s_, q, it, dither=dith)
                    torch.cuda.synchronize()
                    rel = float(torch.max(torch.abs(alpha - al_p)
                                          / torch.clamp(torch.abs(al_p), min=1e-30)))
                    check(torch.equal(resid, res_p) and rel <= 1e-6,
                          f"kLevels={b} iters={it} {key}: resid or alpha off")
                    ms[f"{key} iters={it}"] = timer(
                        lambda: bqcs_encode_fused(*k_in[key]["args"], it, **kw))
            print(f"[levels] kLevels={b}: " + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + " (checked against the plain versions)")


# [train]: the pod-level FedQCS train step (runtime/steps.py) on Qwen3-0.6B
# as published (configs/qwen3_0_6b.py): 2 pods, the launcher's batch 16 x
# seq 64 and FedQCS point (N = 255, R = 3 -> M = 85, Q = 3 -> W = 9 words,
# s_ratio 0.05 -> S = 12, 15 scalar-variance GAMP iterations), the kernel
# route.  (a) runs every layer; (b)-(d) keep every width and cut the depth
# to TRAIN_CUT_LAYERS (the embedding is most of a pod's rows either way).
TRAIN_ARCH, TRAIN_PODS, TRAIN_BATCH, TRAIN_SEQ = "qwen3-0.6b", 2, 16, 64
TRAIN_N, TRAIN_ITERS, TRAIN_CUT_LAYERS, SLICE_ROWS = 255, 15, 2, 65_536
TRAIN_RANGE = "chip_smoke.train_step"


def train_fed(**kw):
    from repro_torch.core.compression import FedQCSConfig

    return FedQCSConfig(block_size=TRAIN_N, reduction_ratio=3, bits=3, s_ratio=0.05,
                        gamp_iters=TRAIN_ITERS, gamp_variance_mode="scalar", use_kernels=True,
                        **kw)


def train_opt():
    """The launcher's optimizer at its default 100 steps."""
    from repro_torch.optim.adam import OptConfig

    return OptConfig(lr=3e-3, warmup_steps=20, decay_steps=100)


def train_state(cfg, fed, params, dev, pods: int = TRAIN_PODS, **kw):
    """The port's train state (``steps.init_train_state``) around a clone of
    ``params`` (drawn once for every mode)."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.runtime import steps

    return steps.init_train_state(cfg, train_opt(), fed, 0, n_pods=pods, device=dev,
                                  params=tree_util.tree_map(torch.clone, params), **kw)


def max_param_gap(a, b) -> float:
    import torch

    from repro_torch import tree as tree_util

    return max(float(torch.max(torch.abs(x.float() - tree_util.get(b, p).float())))
               for p, x in tree_util.leaves(a))


def pod_blocks(state, batch, cfg):
    """Each pod's gradient blocks on the train step's layout ((pods, nb, N)),
    as ``impl="auto"`` builds them."""
    from repro_torch.runtime import steps

    res = state["residual"]
    return steps.pod_blocks(state["params"], batch, cfg, res.shape[0], TRAIN_N, res.device)[1]


def traced_steps(fn, state, batches):
    """Runs the steps under one ``torch.profiler`` trace, each inside a
    ``record_function`` range ending in a device sync; returns (state, per
    step (loss, wall ms under the trace, device busy ms, launches, peak
    bytes, device event name -> [count, ms]))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    out = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            with record_function(TRAIN_RANGE):
                state, m = fn(state, batch)
                loss = float(m["loss"])
                torch.cuda.synchronize()
            out.append([loss, 1e3 * (time.perf_counter() - t0), None, read_counts(),
                        torch.cuda.max_memory_allocated(), {}])
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == TRAIN_RANGE and e.device_type == DeviceType.CPU)
    dspans = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == TRAIN_RANGE and e.device_type != DeviceType.CPU)
    if len(dspans) == len(spans):
        spans = [(min(h[0], d[0]), max(h[1], d[1])) for h, d in zip(spans, dspans)]
    busy = [0.0] * len(spans)
    per = [{} for _ in spans]
    for e in events:
        if e.device_type == DeviceType.CPU or e.name == TRAIN_RANGE:
            continue
        for i, (lo, hi) in enumerate(spans):
            if lo <= e.time_range.start <= hi:
                ms = e.time_range.elapsed_us() / 1e3
                busy[i] += ms
                c, t = per[i].get(e.name, (0, 0.0))
                per[i][e.name] = (c + 1, t + ms)
                break
    if len(spans) == len(out):
        for rec, b, p in zip(out, busy, per):
            rec[2], rec[5] = b, p
    return state, out


def step_vs_exact(kind: str, args, dev, strict: bool = True):
    """One GAMP step kernel at the chooser's pick and at cluster 1 against
    the plain step in fp32 and evaluated in float64 (the exact step), at the
    tests' tolerances (rtol 2e-4 / atol 1e-6 for gamp_step, 1e-3 / 1e-5 for
    qgamp_step).  ``strict``: every output of the kernel and of the plain
    fp32 step within tolerance of the exact step (at millions of outputs two
    fp32 evaluations, each summing in its own order, part past it on a few
    elements: PERF.md §6).  Otherwise only counted.  Returns (max abs
    err per output against the fp32 plain step, against the exact step,
    outputs past the tolerance: kernel vs exact, plain vs exact, kernel vs
    plain; the shapes run)."""
    import torch

    from repro_torch.core.compression import unpack_codes
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.kernels import qgamp_step as q_mod
    from repro_torch.kernels import ref

    d = lambda x: x.double() if x.is_floating_point() else x  # noqa: E731
    if kind == "qgamp":
        ghat, nug, shat, theta, obs, alpha, lo, hi, a, L, em, bits = args
        codes = unpack_codes(obs, bits, shat.shape[1])
        plain_args = (ghat, nug, shat, theta, codes, alpha, lo, hi, a, L, em)
        plain, mod, rtol, atol = ref.qgamp_step_ref, q_mod, 1e-3, 1e-5
    else:
        plain_args, plain, mod, rtol, atol = args, ref.gamp_step_ref, g_mod, 2e-4, 1e-6
    p32 = plain(*plain_args)
    exact = plain(*(d(x) if isinstance(x, torch.Tensor) else x for x in plain_args))
    names = ("ghat", "nu_g", "shat", "theta")

    def past(x, ref_):
        return int(torch.sum(torch.abs(x.double() - ref_.double())
                             > atol + rtol * torch.abs(ref_.double())))

    counts = [0, sum(past(p_, e_) for p_, e_ in zip(p32, exact)), 0]
    rows, cluster = mod.launch_shape(args[0].shape[0],
                                     torch.cuda.get_device_properties(dev).multi_processor_count)
    shapes = [(rows, cluster)] + ([(rows, 1)] if cluster > 1 else [])
    errs, exact_errs = [0.0] * 4, [0.0] * 4
    for r, c in shapes:
        got = getattr(mod, f"{kind}_step")(*args, _rows=r, _cluster=c)
        torch.cuda.synchronize()
        for i, (k_, p_, e_) in enumerate(zip(got, p32, exact)):
            errs[i] = max(errs[i], float(torch.max(torch.abs(k_ - p_))))
            exact_errs[i] = max(exact_errs[i], float(torch.max(torch.abs(k_.double() - e_))))
            counts[0] += past(k_, e_)
            counts[2] += past(k_, p_)
    if strict:
        check(counts[0] == 0 and counts[1] == 0,
              f"{kind}_step {args[0].shape[0]} rows at {shapes}: {counts[0]} kernel and "
              f"{counts[1]} plain fp32 outputs past rtol {rtol} / atol {atol} of the float64 "
              f"step ({names})")
    return errs, exact_errs, counts, shapes


def encoder_agrees(label, b0, r0, got, plain, a, tab, q: int, m: int):
    """The encoder's contract against its plain version on the same rows:
    resid bit-identical, alpha within 1e-6 relative, a differing code lane
    only where y lies within 1e-5 of a threshold, pad lanes 0.  Returns
    (alpha's max rel err, differing code lanes, lanes, kept entries)."""
    import torch

    from repro_torch.core.compression import unpack_codes

    words, alpha, res_k = got
    w_p, al_p, res_p = plain
    check(torch.equal(res_k, res_p), f"{label}: resid must be bit-identical")
    rel = float(torch.max(torch.abs(alpha - al_p) / torch.clamp(torch.abs(al_p), min=1e-30)))
    check(rel <= 1e-6, f"{label}: alpha rtol {rel:.3g} > 1e-6")
    diff = unpack_codes(words, q, m) != unpack_codes(w_p, q, m)
    n_diff = int(diff.sum())
    if n_diff:
        rows = torch.nonzero(diff.any(dim=1)).squeeze(1)  # only the rows that differ
        sparse = (b0[rows] + r0[rows]) - res_p[rows]
        gap = torch.amin(torch.abs(((sparse * al_p[rows, None]) @ a.T)[..., None] - tab), dim=-1)
        check(float(gap[diff[rows]].max()) < 1e-5, f"{label}: a differing code lane is not "
              "within 1e-5 of a threshold")
    full = unpack_codes(words, q, words.shape[1] * (32 // q))
    check(not bool(full[:, m:].any()), f"{label}: pad lanes must carry code 0")
    kept = int(((b0 + r0) != res_p).sum())
    return rel, n_diff, diff.numel(), kept


def step_agrees(label, got, plain, rtol: float, atol: float) -> float:
    """A step kernel's outputs against the plain fp32 step's on the same
    state: NMSE <= 1e-4 on each output (the drivers' contract; at millions
    of rows the two fp32 evaluations part past the tests' allclose on a few
    elements, counted here: PERF.md §6).  Returns the max abs error."""
    import torch

    names = ("ghat", "nu_g", "shat", "theta")
    errs = [nmse(k, p) for k, p in zip(got, plain)]
    past = [int(torch.sum(torch.abs(k - p) > atol + rtol * torch.abs(p)))
            for k, p in zip(got, plain)]
    worst = max(float(torch.max(torch.abs(k - p))) for k, p in zip(got, plain))
    print(f"{label}: NMSE to the plain fp32 step "
          + ", ".join(f"{n} {e:.3g}" for n, e in zip(names, errs))
          + f" (<= 1e-4); outputs past rtol {rtol} / atol {atol} "
          + ", ".join(f"{n} {c}" for n, c in zip(names, past))
          + f" of {sum(k.numel() for k in got):,}; max abs err {worst:.3g}")
    check(max(errs) <= 1e-4, f"{label}: NMSE {max(errs):.3g} > 1e-4")
    return worst


def train_kernel_slices(dev, fed, blocks, resid, a):
    """(c) each kernel on a SLICE_ROWS-row slice of a real step's blocks
    against its plain version: the encoder (resid bit-identical, alpha 1e-6
    relative, codes near a threshold, pad lanes 0); gamp_step and qgamp_step
    one step from the state 3 kernel iterations into their decodes (the
    tests' allclose contracts); and both 15-step drivers against the plain
    drivers (NMSE <= 1e-4).  Returns (name -> max abs err, timing inputs)."""
    import torch

    from repro_torch.core import bussgang
    from repro_torch.core.codebook import make_codebook
    from repro_torch.core.gamp import block_prior_energy, tau_tables
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bqcs_encode_fused import bqcs_encode_fused
    from repro_torch.kernels.gamp_step import gamp_step
    from repro_torch.kernels.qgamp_step import qgamp_step

    m, q, s = fed.m, fed.bits, fed.s
    cb = make_codebook(fed)
    a_t = ops.encoder_a_t(a, cb)
    tab = cb.thresholds_t(dev)
    # a slice from the middle of the grid (the MLP weights of the layers)
    lo_row = blocks.shape[1] // 2
    sl = slice(lo_row, lo_row + SLICE_ROWS)
    b0, r0 = blocks[0, sl].contiguous(), resid[0, sl].contiguous()
    words, alpha, res_k = bqcs_encode_fused(b0, r0, a_t, tab, s, m, q)
    plain = ref.bqcs_encode_fused_ref(b0, r0, a_t[:, :m], tab, s, q)
    torch.cuda.synchronize()
    rel, n_diff, lanes, kept = encoder_agrees("[train] encoder slice", b0, r0,
                                              (words, alpha, res_k), plain, a, tab, q, m)
    errs = {"encode255": float(torch.max(torch.abs(alpha - plain[1])))}
    print(f"[train] (c) encoder, {SLICE_ROWS} rows x N={TRAIN_N} of a real step's blocks, "
          f"M={m} Q={q} W={words.shape[1]} S={s}: resid bit-identical, alpha max rel err "
          f"{rel:.3g}, {n_diff} differing code lanes of {lanes} (each within 1e-5 of a "
          f"threshold), {kept} kept entries")
    # the AE decode of the two pods' slices; the EA decode of pod 0's words
    enc = [bqcs_encode_fused(blocks[p, sl].contiguous(), resid[p, sl].contiguous(), a_t, tab,
                             s, m, q) for p in range(blocks.shape[0])]
    wds = torch.stack([e[0] for e in enc])
    als = torch.stack([e[1] for e in enc])
    rhos = torch.full((blocks.shape[0],), 1.0 / blocks.shape[0], device=dev)
    y = bussgang.aggregate_packed(wds, als, rhos, cb, m)
    nu = bussgang.effective_noise_var(als, rhos, cb)
    energy = bussgang.signal_energy(als, rhos, m, TRAIN_N)
    gs = ops._init_state(energy, TRAIN_N, m, 3, 0.9)
    nud = nu[:, None].contiguous()
    # the AE step from the decode's first state (strict), and 3 iterations
    # in, where shat = (y - phat) / (nu_p + nu_d) divides fp32 rounding of
    # phat by variances of ~1e-9 (counted: even the plain fp32 step parts
    # from the exact one there)
    g0 = step_vs_exact("gamp", (*gs, y, nud, a, 3, True), dev)
    for _ in range(3):
        gs = gamp_step(*gs, y, nud, a)
    g3 = step_vs_exact("gamp", (*gs, y, nud, a, 3, True), dev, strict=False)
    lo, hi = tau_tables(tab)
    safe = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    qs = ops._init_state(block_prior_energy(alpha, m, TRAIN_N), TRAIN_N, m, 3, 0.9)
    for _ in range(3):
        qs = qgamp_step(*qs, words, safe[:, None].contiguous(), lo, hi, a, bits=q)
    q3 = step_vs_exact("qgamp", (*qs, words, safe[:, None].contiguous(), lo, hi, a, 3, True, q),
                       dev)
    errs["gamp255"], errs["qgamp255"] = max(g0[0]), max(q3[0])
    ae_k = ops.gamp_ae_run(y, nu, a, energy, iters=TRAIN_ITERS)
    ea_k = ops.qgamp_ea_run_packed(words, alpha, a, tab, bits=q, m=m, iters=TRAIN_ITERS)
    with plain_kernels():
        ae_p = ops.gamp_ae_run(y, nu, a, energy, iters=TRAIN_ITERS)
        ea_p = ops.qgamp_ea_run_packed(words, alpha, a, tab, bits=q, m=m, iters=TRAIN_ITERS)
    ae_nmse, ea_nmse = nmse(ae_k, ae_p), nmse(ea_k, ea_p)
    check(ae_nmse <= 1e-4 and ea_nmse <= 1e-4,
          f"[train] 15-step drivers on the slice: NMSE AE {ae_nmse:.3g}, EA {ea_nmse:.3g}")
    for label, (err, exact_err, counts, shapes) in (
            ("gamp_step, the AE decode's first step", g0),
            ("gamp_step, 3 iterations into the AE decode", g3),
            ("qgamp_step, 3 iterations into the EA decode", q3)):
        print(f"[train] (c) {label} ({SLICE_ROWS} rows) at {shapes}: outputs past the tolerance "
              f"of the float64 step: kernel {counts[0]}, plain fp32 {counts[1]} (of "
              f"{len(shapes)} x {SLICE_ROWS} x (2N+M+10)); kernel vs plain fp32 {counts[2]}; "
              f"max abs err vs float64 {[f'{e:.3g}' for e in exact_err]}, vs plain "
              f"{[f'{e:.3g}' for e in err]}")
    print(f"[train] (c) 15-step drivers vs plain on the slice: NMSE AE {ae_nmse:.3g}, EA "
          f"{ea_nmse:.3g}")
    return errs


def train_encode_time(dev, fed, b0, r0, a, timer, label: str = "[train] (c)",
                      grid: str = "pod 0's whole grid", plain_parts: int = 1):
    """[time] the encoder at the train step's shape on ``grid`` of a real
    step (pod 0's nb rows; [cohort]: the cohort's C x nb), beside its plain
    version (over ``plain_parts`` row slices in turn, then timed by
    ``GpuTimer.direct``: its launches fill the launch queue), and held to the
    encoder's contract against it on those rows.  Returns (the record, the
    words and alphas it encodes).  Bounds count each input read once and
    each output written once; the product's FLOPs count the entries this
    encode kept."""
    import torch

    from repro_torch.core.codebook import make_codebook
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bqcs_encode_fused import bqcs_encode_fused

    m, q, s, n = fed.m, fed.bits, fed.s, TRAIN_N
    cb = make_codebook(fed)
    a_t, tab = ops.encoder_a_t(a, cb), cb.thresholds_t(dev)
    rows = b0.shape[0]
    def plain_fn(b, r):
        return ref.bqcs_encode_fused_ref(b, r, a_t[:, :m], tab, s, q)

    words, alpha, new_res = bqcs_encode_fused(b0, r0, a_t, tab, s, m, q)
    plain = plain_in_parts(plain_fn, (b0, r0), plain_parts)
    torch.cuda.synchronize()
    rel, n_diff, lanes, kept = encoder_agrees(f"{label} encoder at {rows} rows", b0, r0,
                                              (words, alpha, new_res), plain, a, tab, q, m)
    err = float(torch.max(torch.abs(alpha - plain[1])))
    print(f"{label} encoder on {grid} ({rows:,} rows x N={n}) of a real step: "
          f"resid bit-identical, alpha max rel err {rel:.3g}, {n_diff} differing code lanes of "
          f"{lanes:,} (each within 1e-5 of a threshold), {kept:,} kept entries")
    del new_res, plain
    torch.cuda.empty_cache()
    a_rows = n  # every row of A^T is touched somewhere in a grid of millions of rows
    nbytes = (4 * (3 * rows * n + a_rows * a_t.shape[1]) + 4 * rows * (words.shape[1] + 1)
              + 4 * tab.numel())
    b_ms, b_by = bound_ms(nbytes, 2 * kept * m)
    rec = dict(ms=timer(lambda: bqcs_encode_fused(b0, r0, a_t, tab, s, m, q), reps=5),
               plain_ms=(timer(lambda: plain_fn(b0, r0), reps=3) if plain_parts == 1 else
                         timer.direct(lambda: [plain_fn(*sl) for sl in
                                               row_parts((b0, r0), plain_parts)])),
               bound_ms=b_ms, bound_by=b_by, library_ms=None, rows=rows, err=err)
    return rec, words, alpha


def row_parts(args, parts: int):
    """``args`` of a step (its leading operands (rows, ...)) as ``parts``
    slices of rows: each row's step is its own, so the plain step over the
    slices is the plain step over all rows, with 1/parts of its
    temporaries alive at a time."""
    rows = args[0].shape[0]
    size = -(-rows // parts)
    return [tuple(x[i:i + size] if x.dim() and x.shape[0] == rows else x for x in args)
            for i in range(0, rows, size)]


def plain_in_parts(fn, args, parts: int):
    import torch

    outs = [fn(*sl) for sl in row_parts(args, parts)]
    return outs[0] if len(outs) == 1 else tuple(torch.cat(o) for o in zip(*outs))


def gamp_step_time(dev, fed, words, alpha, rhos, a, timer, label: str, plain_parts: int = 1):
    """[time] gamp_step on the AE decode of the (C, nb, W) ``words`` and
    (C, nb) ``alpha`` Bussgang-combined with weights ``rhos`` (nb rows, N =
    TRAIN_N), 3 iterations into the decode, beside its plain version (over
    ``plain_parts`` row slices in turn) and the cuBLAS GEMMs of its two
    products, and held against the plain step there (:func:`step_agrees`).
    Returns the record."""
    import torch

    from repro_torch.core import bussgang
    from repro_torch.core.codebook import make_codebook
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gamp_step import gamp_step

    m, n, L = fed.m, TRAIN_N, 3
    cb = make_codebook(fed)
    rows = words.shape[1]
    y = bussgang.aggregate_packed(words, alpha, rhos, cb, m)
    nud = bussgang.effective_noise_var(alpha, rhos, cb)[:, None].contiguous()
    gs = ops._init_state(bussgang.signal_energy(alpha, rhos, m, n), n, m, L, 0.9)
    for _ in range(3):
        gs = gamp_step(*gs, y, nud, a)
    state = 4 * rows * (2 * n + m + 1 + 3 * L)
    b_ms, b_by = bound_ms(2 * state + 4 * m * n + 4 * rows * m + 4 * rows, 4 * rows * n * m)
    plain = plain_in_parts(ref.gamp_step_ref, (*gs, y, nud, a), plain_parts)  # the peak
    err = step_agrees(f"{label} gamp_step at {rows:,} rows, 3 iterations into the AE decode",
                      gamp_step(*gs, y, nud, a), plain, 2e-4, 1e-6)
    del plain
    torch.cuda.empty_cache()
    ghat, _, shat, _ = gs
    return dict(
        ms=timer(lambda: gamp_step(*gs, y, nud, a), reps=5),
        plain_ms=timer(lambda: [ref.gamp_step_ref(*sl) for sl in
                                row_parts((*gs, y, nud, a), plain_parts)], reps=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: (torch.matmul(ghat, a.T), torch.matmul(shat, a)), reps=5),
        library="GEMMs only", rows=rows, err=err)


def train_step_times(dev, fed, words, alpha, a, timer, label: str = "(c)",
                     plain_parts: int = 1):
    """[time] gamp_step and qgamp_step at the train step's shapes on pod 0's
    nb rows (3 iterations into their decodes of pod 0's words), each beside
    its plain version and the cuBLAS GEMMs of its two products, and held
    against the plain step there (:func:`step_agrees`); qgamp_step also at
    the EA decode's pods x nb rows, each half bit-identical to the nb-row
    launch (same tile shape, rows independent; the plain step's temporaries
    at that size do not fit beside the state).  ``plain_parts``: the plain
    steps run (and are timed) over that many row slices in turn, where
    their temporaries over all rows do not fit."""
    import torch

    from repro_torch.core.codebook import make_codebook
    from repro_torch.core.gamp import block_prior_energy, tau_tables
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.qgamp_step import qgamp_step

    m, q, n, L = fed.m, fed.bits, TRAIN_N, 3
    tab = make_codebook(fed).thresholds_t(dev)
    rows = words.shape[0]
    state = 4 * rows * (2 * n + m + 1 + 3 * L)
    # gamp_step: the AE observation of pod 0's codes alone (rho = 1)
    res = {f"gamp_step[N={n}]": gamp_step_time(
        dev, fed, words[None], alpha[None], torch.ones((1,), device=dev), a, timer,
        f"[train] {label}", plain_parts)}
    torch.cuda.empty_cache()
    lo, hi = tau_tables(tab)
    safe = torch.where(alpha > 0, alpha, torch.ones_like(alpha))[:, None].contiguous()
    qs = ops._init_state(block_prior_energy(alpha, m, n), n, m, L, 0.9)
    for _ in range(3):
        qs = qgamp_step(*qs, words, safe, lo, hi, a, bits=q)
    from repro_torch.core.compression import unpack_codes

    ref_codes = unpack_codes(words, q, m)
    nbytes = 2 * state + 4 * m * n + 4 * words.numel() + 4 * rows + 8 * lo.numel()
    b_ms, b_by = bound_ms(nbytes, 4 * rows * n * m)
    plain = plain_in_parts(ref.qgamp_step_ref, (*qs, ref_codes, safe, lo, hi, a), plain_parts)
    got = qgamp_step(*qs, words, safe, lo, hi, a, bits=q)
    err = step_agrees(f"[train] {label} qgamp_step at {rows:,} rows, 3 iterations into the EA "
                      "decode", got, plain, 1e-3, 1e-5)
    del plain
    torch.cuda.empty_cache()
    # the EA decode's whole batch: the two pods' problems, one launch
    qs2 = tuple(torch.cat([x, x]) for x in qs)
    words2, safe2 = torch.cat([words, words]), torch.cat([safe, safe])
    got2 = qgamp_step(*qs2, words2, safe2, lo, hi, a, bits=q)
    torch.cuda.synchronize()
    same = all(torch.equal(x2[:rows], x) and torch.equal(x2[rows:], x)
               for x2, x in zip(got2, got))
    check(same, f"[train] qgamp_step at {2 * rows} rows: each half must be bit-identical to "
          f"the {rows}-row launch")
    print(f"[train] {label} qgamp_step at {2 * rows:,} rows (the EA decode's pods x nb): "
          f"each half "
          f"bit-identical to the {rows:,}-row launch")
    del got, got2
    torch.cuda.empty_cache()
    ms2 = timer(lambda: qgamp_step(*qs2, words2, safe2, lo, hi, a, bits=q), reps=5)
    b2, by2 = bound_ms(2 * nbytes, 8 * rows * n * m)
    print(f"[time] qgamp_step[N={n}] at {2 * rows} rows (the EA decode's pods x nb): kernel "
          f"{ms2:.4f} ms | bound {b2:.4f} ms ({by2})")
    del qs2, words2, safe2
    torch.cuda.empty_cache()
    ghat, _, shat, _ = qs
    res[f"qgamp_step[N={n}]"] = dict(
        ms=timer(lambda: qgamp_step(*qs, words, safe, lo, hi, a, bits=q), reps=5),
        plain_ms=timer(lambda: [ref.qgamp_step_ref(*sl) for sl in
                                row_parts((*qs, ref_codes, safe, lo, hi, a), plain_parts)],
                       reps=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: (torch.matmul(ghat, a.T), torch.matmul(shat, a)), reps=5),
        library="GEMMs only", rows=rows, err=err)
    del qs, ghat, shat, ref_codes
    return res


def print_train_times(res: dict) -> None:
    for name, r in res.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ({r['library']})"
        print(f"[time] {name} at {r['rows']} rows: kernel {r['ms']:.4f} ms | plain "
              f"{r['plain_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | "
              f"library {lib}")


def traced_mode_steps(label, cfg, mode, params0, batches, dev, launches):
    """[train] (a)'s form, for ``mode`` ("ae" or "ea"): two ``impl="auto"``
    steps from ``params0`` in one ``torch.profiler`` trace (loss, wall,
    device busy, the launches checked and added to ``launches``, peak,
    the top device events), then one more untraced; the loss finite and
    the parameters moved.  Returns the state after the third step."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.runtime import steps

    want = dict(encode=TRAIN_PODS, gamp=TRAIN_ITERS if mode == "ae" else 0,
                qgamp=TRAIN_ITERS if mode == "ea" else 0)
    fed = train_fed(recon_mode=mode)
    fn = steps.make_train_step(cfg, train_opt(), fed, make_single_device_mesh(), device=dev)
    # no name holds the fresh state, so each step's input is freed as the
    # step replaces it (the peak is one step's, not two states')
    state, recs = traced_steps(fn, train_state(cfg, fed, params0, dev), batches[:2])
    for t, (loss, wall, busy, counts, peak, events) in enumerate(recs):
        got = {k: counts[k] for k in want}
        check(got == want, f"[train] {label} {mode} step {t}: launches {got}, want {want}")
        check(bool(np.isfinite(loss)), f"[train] {label} {mode} step {t}: loss {loss}")
        busy_s = "not measured" if busy is None else f"{busy:.3f} ms"
        print(f"[train] {label} {mode.upper()} step {t}: loss {loss:.6f}, wall {wall:.3f} ms "
              f"(under the trace), device busy {busy_s}, launches encoder "
              f"{counts['encode']}, gamp_step {counts['gamp']}, qgamp_step "
              f"{counts['qgamp']}, max_memory_allocated {peak / 2**30:.3f} GiB")
        top = sorted(events.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"[train] {label} {mode.upper()} step {t} device time by event: "
              + "; ".join(f"{k[:48]} x{c} {ms:.3f} ms" for k, (c, ms) in top))
        launches[f"bqcs_encode_fused[N={TRAIN_N}]"] += counts["encode"]
        launches[f"gamp_step[N={TRAIN_N}]"] += counts["gamp"]
        launches[f"qgamp_step[N={TRAIN_N}]"] += counts["qgamp"]
    moved = max_param_gap(state["params"], params0)
    check(moved > 0, f"[train] {label} {mode}: the parameters did not move")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state, m = fn(state, batches[2])
    loss = float(m["loss"])
    torch.cuda.synchronize()
    print(f"[train] {label} {mode.upper()} step 2 (no trace): loss {loss:.6f}, wall "
          f"{1e3 * (time.perf_counter() - t1):.3f} ms, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; parameters moved by up "
          f"to {moved:.3g} over steps 0-1")
    return state


def phase_train(dev):
    """[train] The pod-level FedQCS train step (``runtime/steps.py``) on
    Qwen3-0.6B (see TRAIN_*).  (a) Two full-width steps of ``impl="auto"``,
    AE and then EA, in one ``torch.profiler`` trace (each step a range
    ending in a device sync: loss, wall under the trace, device busy,
    launches per kernel, peak device memory), then one more step unprofiled
    (its wall); the loss finite and the parameters moved.  Then (c) each
    kernel on a slice of a real step's blocks, and on pod 0's whole grid
    beside its [time] at the step's shapes.  (b) At TRAIN_CUT_LAYERS layers: ``impl="shard_map"`` at world
    size 1 over NCCL (gather_codes AE and EA, psum_dequant AE) against
    ``impl="auto"`` at one pod, ``auto_sharded`` against ``auto``, and the
    baseline.  (c) At TRAIN_CUT_LAYERS layers, the decoded aggregate of a
    real step's blocks on the kernel route against the plain versions (AE
    and EA, NMSE <= 1e-3).  (d) A checkpoint saved on the card, restored
    and replayed 2 steps: identical parameters, moments and residuals.
    Returns (launches by KERNELS name, max abs errors, [time] records)."""
    import dataclasses as dc
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import TokenDataset
    from repro_torch.launch.mesh import make_debug_mesh, make_single_device_mesh
    from repro_torch.models import model as model_api
    from repro_torch.runtime import steps
    from repro_torch.runtime.collectives import fedqcs_vmapped_allreduce

    cfg = get_config(TRAIN_ARCH)
    ds = TokenDataset(cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
    batches = [ds.get_batch(t, device=dev) for t in range(3)]
    mesh = make_single_device_mesh()
    launches = {f"bqcs_encode_fused[N={TRAIN_N}]": 0, f"gamp_step[N={TRAIN_N}]": 0,
                f"qgamp_step[N={TRAIN_N}]": 0}
    t0 = time.perf_counter()
    params0 = model_api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(int(p.numel()) for _, p in tree_util.leaves(params0))
    rows = steps.block_rows(cfg, train_fed())
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat_policy}: {n_params:,} parameters "
          f"(param_count {cfg.param_count():,}), drawn in {time.perf_counter() - t0:.1f} s; "
          f"{TRAIN_PODS} pods x {rows:,} block rows of N={TRAIN_N} (M={train_fed().m}, "
          f"S={train_fed().s}, Q={train_fed().bits}); batch {TRAIN_BATCH} x seq {TRAIN_SEQ}")
    errs, times = {}, {}
    # (a) full width, AE then EA; then the kernels on the EA run's grid
    for mode in ("ae", "ea"):
        state = traced_mode_steps("(a)", cfg, mode, params0, batches, dev, launches)
        if mode == "ae":
            del state
            torch.cuda.empty_cache()
    fed = train_fed(recon_mode="ea")
    blocks = pod_blocks(state, batches[0], cfg)
    resid = state["residual"]
    del state
    codec_a = steps.BQCSCodec(fed, device=dev).a
    errs.update(train_kernel_slices(dev, fed, blocks, resid, codec_a))
    b0, r0 = blocks[0].clone(), resid[0].clone()  # pod 0's grid
    del blocks, resid
    torch.cuda.empty_cache()
    timer = GpuTimer()
    rec, words, alpha = train_encode_time(dev, fed, b0, r0, codec_a, timer)
    times[f"bqcs_encode_fused[N={TRAIN_N}]"] = rec
    del b0, r0
    torch.cuda.empty_cache()
    times.update(train_step_times(dev, fed, words, alpha, codec_a, timer))
    for key, name in (("encode255", "bqcs_encode_fused"), ("gamp255", "gamp_step"),
                      ("qgamp255", "qgamp_step")):
        errs[key] = max(errs[key], times[f"{name}[N={TRAIN_N}]"]["err"])
    print_train_times(times)
    del words, alpha
    torch.cuda.empty_cache()
    del params0
    torch.cuda.empty_cache()
    # (b)-(d) at the published widths, TRAIN_CUT_LAYERS layers
    cut = dc.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    p_cut = model_api.init_params(cut, seed=1, device=dev)
    ae, ea = train_fed(), train_fed(recon_mode="ea")

    def one(fn, state, label, want_counts):
        zero_counts()
        new, m = fn(state, batches[0])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        counts = read_counts()
        got = {k: counts[k] for k in want_counts}
        check(got == want_counts, f"[train] {label}: launches {got}, want {want_counts}")
        check(bool(np.isfinite(loss)) and max_param_gap(new["params"], state["params"]) > 0,
              f"[train] {label}: loss {loss} or parameters did not move")
        return new, loss

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            for label, fed in (("gather_codes AE", ae), ("gather_codes EA", ea),
                               ("psum_dequant AE", dc.replace(ae, wire_mode="psum_dequant"))):
                pod = steps.make_train_step(cut, train_opt(), fed, make_debug_mesh(1),
                                            impl="shard_map", device=dev)
                auto = steps.make_train_step(cut, train_opt(), fed, mesh, device=dev)
                start = train_state(cut, fed, p_cut, dev, pods=1)
                dec = dict(encode=1, gamp=0 if fed.recon_mode == "ea" else TRAIN_ITERS,
                           qgamp=TRAIN_ITERS if fed.recon_mode == "ea" else 0)
                got, l_pod = one(pod, start, f"shard_map {label}", dec)
                want_s, l_auto = one(auto, start, f"auto, 1 pod, {label}", dec)
                gap = max_param_gap(got["params"], want_s["params"])
                dres = float(torch.max(torch.abs(got["residual"] - want_s["residual"])))
                check(abs(l_pod - l_auto) <= 1e-5 and dres <= 1e-5 and gap <= 2 * 3e-3,
                      f"[train] shard_map {label} vs auto: loss {l_pod} vs {l_auto}, residual "
                      f"{dres:.3g}, parameters {gap:.3g}")
                print(f"[train] (b) shard_map (NCCL, world size 1) {label}: loss {l_pod:.6f} "
                      f"(auto at 1 pod {l_auto:.6f}), residual max gap {dres:.3g}, parameters "
                      f"max gap {gap:.3g} (<= 2 lr); launches {dec}")
                del got, want_s, start
        finally:
            dist.destroy_process_group()
    sharded = steps.make_train_step(cut, train_opt(), ae, mesh, impl="auto_sharded", device=dev)
    auto = steps.make_train_step(cut, train_opt(), ae, mesh, device=dev)
    start = train_state(cut, ae, p_cut, dev)
    start_sh = train_state(cut, ae, p_cut, dev, mesh=mesh, impl="auto_sharded")
    nb_local = steps.shard_block_geometry(cut, ae, mesh)[0]
    check(start_sh["residual"].shape == (TRAIN_PODS, nb_local, TRAIN_N),
          f"[train] auto_sharded residual {tuple(start_sh['residual'].shape)}, want "
          f"{(TRAIN_PODS, nb_local, TRAIN_N)}")
    dec = dict(encode=TRAIN_PODS, gamp=TRAIN_ITERS, qgamp=0)
    got, l_sh = one(sharded, start_sh, "auto_sharded AE", dec)
    want_s, l_auto = one(auto, start, "auto AE", dec)
    gap = max_param_gap(got["params"], want_s["params"])
    check(abs(l_sh - l_auto) <= 1e-5 and gap <= 2 * 3e-3,
          f"[train] auto_sharded vs auto: loss {l_sh} vs {l_auto}, parameters {gap:.3g}")
    print(f"[train] (b) auto_sharded AE ({nb_local:,} rows a pod, no 512 padding): loss "
          f"{l_sh:.6f} (auto {l_auto:.6f}), parameters max gap {gap:.3g}; launches {dec}")
    del got, want_s, start_sh
    base = steps.make_train_step(cut, train_opt(), None, mesh, device=dev)
    _, l_base = one(base, train_state(cut, None, p_cut, dev), "baseline",
                    dict(encode=0, gamp=0, qgamp=0))
    print(f"[train] (b) baseline (no FedQCS): loss {l_base:.6f}, no kernel launched")
    # (c) the decoded aggregate, kernel route vs plain versions
    blocks = pod_blocks(start, batches[0], cut)
    part = torch.ones((TRAIN_PODS,), device=dev)
    for label, fed in (("AE", ae), ("EA", ea)):
        codec = steps.BQCSCodec(fed, device=dev)
        g_k, r_k = fedqcs_vmapped_allreduce(blocks, start["residual"], codec, part)
        with plain_kernels():
            g_p, r_p = fedqcs_vmapped_allreduce(blocks, start["residual"], codec, part)
        torch.cuda.synchronize()
        e = nmse(g_k, g_p)
        check(e <= 1e-3 and torch.equal(r_k, r_p),
              f"[train] (c) {label} aggregate: NMSE {e:.3g} to the plain versions, residuals "
              f"bit-identical {torch.equal(r_k, r_p)}")
        print(f"[train] (c) {label} decoded aggregate of a real step's blocks ({TRAIN_PODS} x "
              f"{blocks.shape[1]:,} rows, {TRAIN_CUT_LAYERS} layers at full width): NMSE "
              f"{e:.3g} to the plain versions (<= 1e-3), residuals bit-identical")
        del g_k, r_k, g_p, r_p
    del blocks
    # (d) save, go on 2 steps; restore, replay the 2
    state = start
    for t in range(2):
        state, _ = auto(state, batches[t])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(tmp, keep=1)
        t1 = time.perf_counter()
        ckpt.save(2, state)
        ckpt.wait()
        save_s = time.perf_counter() - t1
        cont = state
        for t in range(2, 4):
            cont, _ = auto(cont, batches[t % 3])
        template = {k: v for k, v in state.items()}
        t1 = time.perf_counter()
        restored, step = ckpt.restore(template, device=dev)
        restore_s = time.perf_counter() - t1
    check(step == 2, f"[train] (d) restored step {step}")
    for t in range(2, 4):
        restored, _ = auto(restored, batches[t % 3])
    torch.cuda.synchronize()
    same = all(torch.equal(a_, tree_util.get(restored, p))
               for p, a_ in tree_util.leaves(cont) if not isinstance(a_, tuple))
    check(same, "[train] (d) the replay after restore must be bit-identical")
    print(f"[train] (d) checkpoint of the {TRAIN_CUT_LAYERS}-layer state saved in {save_s:.2f} "
          f"s, restored in {restore_s:.2f} s; 2 replayed steps bit-identical to the run that "
          f"went on (parameters, moments, residuals)")
    return launches, errs, times


# [train] (e): the same step on the SSM family, Mamba2-1.3B
# (configs/mamba2_1_3b.py: d_model 2048, d_inner 4096, 64 heads of 64,
# state 128, conv 4, chunks of 256, vocab 50,280, tied, bf16, remat
# "minimal") at every published width, its depth cut to TRAIN_SSM_LAYERS of
# 48: Qwen3-0.6B's EA step peaked at 42.5 GiB for 596M scalars (~71 bytes a
# scalar), so 48 layers (1.34B) would need ~89 GiB; 24 (0.72B, ~51 GiB) until
# [inpod] came, then 12 (0.41B), then 2 (0.15B) when [inpod] took the SSM and
# hybrid families (Mamba2-1.3B at 12 layers there, INPOD_SSM_LAYERS since it
# took the MoE, VLM and audio families too), so that the script keeps to its
# time limit.
# 2 pods, the launcher's batch 16 x seq 64 (the SSD pads it to one chunk of
# 256) and FedQCS point, weights drawn on the card (card_params, seed 0).
TRAIN_SSM_ARCH, TRAIN_SSM_LAYERS, PLAIN_CHUNK_ROWS = "mamba2-1.3b", 2, 1 << 18


def phase_train_ssm(dev):
    """[train] (e) The FedQCS train step on the SSM family at full width
    (see TRAIN_SSM_*), in the form of (a): two ``impl="auto"`` steps each of
    AE and EA in one ``torch.profiler`` trace (loss, wall, device busy,
    launches, peak), one more untraced, the loss finite and the parameters
    moved.  Then, on a real step's blocks (2 pods x 2,836,992 rows), the
    decoded aggregate and the residuals on the kernel route against the
    plain versions (AE and EA; the plain decode in chunks of
    PLAIN_CHUNK_ROWS rows, each row's solve being its own): NMSE <= 1e-3,
    residuals bit-identical; and [time] of the three kernels on pod 0's
    grid (the plain steps in two row halves: over all 2.8M rows at once
    their temporaries do not fit beside the state).  Returns (launches by
    KERNELS name, [time] records)."""
    import dataclasses as dc

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import TokenDataset
    from repro_torch.runtime import steps
    from repro_torch.runtime.collectives import fedqcs_vmapped_allreduce

    cfg = dc.replace(get_config(TRAIN_SSM_ARCH), n_layers=TRAIN_SSM_LAYERS)
    ds = TokenDataset(cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
    batches = [ds.get_batch(t, device=dev) for t in range(3)]
    launches = {f"bqcs_encode_fused[N={TRAIN_N}]": 0, f"gamp_step[N={TRAIN_N}]": 0,
                f"qgamp_step[N={TRAIN_N}]": 0}
    t0 = time.perf_counter()
    params0 = card_params(cfg, dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(int(p.numel()) for _, p in tree_util.leaves(params0))
    rows = steps.block_rows(cfg, train_fed())
    print(f"[train] (e) {cfg.name}: {cfg.n_layers} of {get_config(TRAIN_SSM_ARCH).n_layers} "
          f"layers, d_model {cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"remat {cfg.remat_policy}: {n_params:,} parameters, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; {TRAIN_PODS} pods x {rows:,} block rows of "
          f"N={TRAIN_N}; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}")
    for mode in ("ae", "ea"):
        state = traced_mode_steps("(e)", cfg, mode, params0, batches, dev, launches)
        if mode == "ae":
            del state
            torch.cuda.empty_cache()
    # the decoded aggregate of the EA run's next step's blocks, both modes
    blocks = pod_blocks(state, batches[0], cfg)
    resid = state["residual"]
    del state, params0
    torch.cuda.empty_cache()
    part = torch.ones((TRAIN_PODS,), device=dev)
    for label, fed in (("AE", train_fed()), ("EA", train_fed(recon_mode="ea"))):
        codec = steps.BQCSCodec(fed, device=dev)
        g_k, r_k = fedqcs_vmapped_allreduce(blocks, resid, codec, part)
        same = True
        g_p = torch.empty_like(g_k)
        with plain_kernels():
            for lo in range(0, rows, PLAIN_CHUNK_ROWS):
                sl = slice(lo, lo + PLAIN_CHUNK_ROWS)
                gp, rp = fedqcs_vmapped_allreduce(blocks[:, sl].contiguous(),
                                                  resid[:, sl].contiguous(), codec, part)
                g_p[sl] = gp
                same = same and torch.equal(rp, r_k[:, sl])
                del gp, rp
        torch.cuda.synchronize()
        e = nmse(g_k, g_p)
        check(e <= 1e-3 and same and float(torch.sum(g_p ** 2)) > 0,
              f"[train] (e) {label} aggregate: NMSE {e:.3g} to the plain versions, residuals "
              f"bit-identical {same}")
        print(f"[train] (e) {label} decoded aggregate of a real step's blocks ({TRAIN_PODS} x "
              f"{rows:,} rows, {cfg.n_layers} layers at full width): NMSE {e:.3g} to the plain "
              f"versions (<= 1e-3; the plain decode in chunks of {PLAIN_CHUNK_ROWS:,} rows), "
              "residuals bit-identical")
        del g_k, r_k, g_p
        torch.cuda.empty_cache()
    # [time] at this step's rows, on pod 0's grid
    fed = train_fed(recon_mode="ea")
    codec_a = steps.BQCSCodec(fed, device=dev).a
    b0, r0 = blocks[0].clone(), resid[0].clone()
    del blocks, resid
    torch.cuda.empty_cache()
    timer = GpuTimer()
    rec, words, alpha = train_encode_time(dev, fed, b0, r0, codec_a, timer, "[train] (e)")
    times = {f"bqcs_encode_fused[N={TRAIN_N}]": rec}
    del b0, r0
    torch.cuda.empty_cache()
    times.update(train_step_times(dev, fed, words, alpha, codec_a, timer, "(e)",
                                  plain_parts=2))
    print(f"[train] (e) [time] of the three kernels at {cfg.name}'s {rows:,} rows a pod:")
    print_train_times(times)
    del words, alpha
    torch.cuda.empty_cache()
    return launches, times


# [cohort]: the launcher's cohort mode (launch/train.py::make_fed_cohort:
# TokenClientData, the CohortEngine over the model's nested tree with each
# client's gradient taken one at a time, fedqcs-ae at [train]'s FedQCS point,
# FedAdam) on the kernel route.  (a) Qwen3-0.6B as published (28 layers,
# bf16, remat "minimal"), 8 clients of which half are sampled a round (C = 4
# clients of 2 x 64 tokens): each client's fp32 residual is 2.38 GB, so the
# launcher's default of 64 clients would need ~150 GB.  (b) The reference's
# three cohort archs at their smoke configs (4 clients of 2 x 16 tokens),
# and three more rounds on Qwen3-0.6B's (COHORT_SMOKE_EXTRA).  (c)
# examples/distributed_train_torch.py at its smoke config.
COHORT_ARGV = ["--arch", "qwen3-0.6b", "--fed-cohort", "--clients", "8", "--sample-frac",
               "0.5", "--client-batch", "2", "--seq", "64", "--steps", "2"]
COHORT_SMOKE_ARCHS = ("qwen3-0.6b", "mamba2-1.3b", "qwen3-moe-235b-a22b")
COHORT_SMOKE_ARGV = ["--smoke", "--fed-cohort", "--clients", "4", "--client-batch", "2",
                     "--seq", "16", "--steps", "1"]
COHORT_SMOKE_EXTRA = (["--stream", "2"], ["--snr-db", "10"], ["--server-opt", "fedavgm"])
COHORT_ENCODE = f"bqcs_encode_fused[N={TRAIN_N}, cohort]"
COHORT_GAMP = f"gamp_step[N={TRAIN_N}, cohort]"
# (b)'s interleaved smoke runs, (d)'s chunks and its encoder entry (one
# launch a layout segment)
COHORT_SMOKE_INTERLEAVE = (("qwen3-0.6b", ["--interleave", "2"]),
                           ("mamba2-1.3b", ["--interleave", "2"]),
                           ("zamba2-2.7b", ["--interleave", "1"]))
COHORT_INTERLEAVE = 4
COHORT_SEG_ENCODE = f"bqcs_encode_fused[N={TRAIN_N}, interleaved segments]"


def cohort_engine(argv, dev, draw=None):
    """The launcher's cohort engine (``make_fed_cohort``) for ``argv`` on
    ``dev``, on the kernel route, its parameters ``draw(cfg)`` (default:
    the launcher's, drawn on the CPU from seed 0): (engine, eval loss,
    config)."""
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.launch import train as tlaunch

    args = tlaunch.parse_args(argv + ["--device", str(dev)])
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    fed = dataclasses.replace(tlaunch.cohort_fed(args), use_kernels=True)
    engine, eval_loss, _ = tlaunch.make_fed_cohort(args, cfg, fed=fed,
                                                   params=None if draw is None else draw(cfg))
    return engine, eval_loss, cfg


@contextlib.contextmanager
def phase_walls():
    """Yields a dict that gets the wall ms of each cohort engine phase run
    inside (the client pass -- the gradients and the encode --, the PS
    pass, the apply), each phase ending in a device sync."""
    import torch

    from repro_torch.fed.engine import CohortEngine

    walls = {}
    saved = {name: getattr(CohortEngine, name) for name in ("_client_pass", "_ps", "_apply")}

    def timed(name, fn):
        def run(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            walls[name] = walls.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out
        return run

    for name, fn in saved.items():
        setattr(CohortEngine, name, timed(name.strip("_"), fn))
    try:
        yield walls
    finally:
        for name, fn in saved.items():
            setattr(CohortEngine, name, fn)


@contextlib.contextmanager
def client_pass_peak():
    """Yields a dict that gets, for the cohort engine's client pass run
    inside, the allocation at its start (the round's gather of residual
    rows already made), its peak above that start, and the peak before it
    (the round's peak is the larger of that and the peak after the pass:
    the peak counter is reset at the pass's start)."""
    import torch

    from repro_torch.fed.engine import CohortEngine

    rec = {}
    saved = CohortEngine._client_pass

    def run(self, *args, **kwargs):
        torch.cuda.synchronize()
        rec["before"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rec["start"] = torch.cuda.memory_allocated()
        out = saved(self, *args, **kwargs)
        torch.cuda.synchronize()
        rec["above_start"] = torch.cuda.max_memory_allocated() - rec["start"]
        return out

    CohortEngine._client_pass = run
    try:
        yield rec
    finally:
        CohortEngine._client_pass = saved


def cohort_plain_decode(engine, rec, label: str = "[cohort] (a)") -> float:
    """[cohort] (a), (d): a round's decoded aggregate (``rec``, a
    ``captured_rounds`` record) against the plain versions' decode of the
    same payload, PLAIN_CHUNK_ROWS rows at a time (each row's solve is its
    own): NMSE <= 1e-3.  Returns the NMSE."""
    import torch

    from repro_torch.core.reconstruction import aggregate_and_estimate

    g_k, codec = rec["ghat"], engine.codec
    g_p = torch.empty_like(g_k)
    with plain_kernels():
        for lo in range(0, engine.nb, PLAIN_CHUNK_ROWS):
            sl = slice(lo, lo + PLAIN_CHUNK_ROWS)
            g_p[sl] = aggregate_and_estimate(codec, codec.unpack(rec["words"][:, sl]),
                                             rec["alpha"][:, sl], rec["rhos"], gamp=engine.gamp)
    torch.cuda.synchronize()
    e = nmse(g_k, g_p)
    check(e <= 1e-3 and float(torch.sum(g_p ** 2)) > 0,
          f"{label} round 0's aggregate: NMSE {e:.3g} to the plain versions")
    return e


def cohort_full_width(dev, launches) -> tuple:
    """[cohort] (a): COHORT_ARGV's rounds on Qwen3-0.6B at full width, the
    launch counts set to 0 just before each round and read just after (1
    encoder launch over C x nb rows and 15 gamp_step launches over nb rows
    a round; added to ``launches``).  Round 0 untraced (its wall and each
    phase's, :func:`phase_walls`), round 1 in a ``torch.profiler`` trace
    (wall under the trace, device busy, idle share, the top device events);
    each round's peak, eval loss and wire bytes.  Round 0's decoded
    aggregate against the plain versions' (:func:`cohort_plain_decode`,
    before round 1, so its record is out of round 1's peak).  Then [time] of the encoder on round 1's C x nb
    rows (the residual rows after it) and of gamp_step on its AE decode.
    Returns (max abs errors, [time] records, round 0's client pass peak
    above its start in bytes)."""
    import gc

    import numpy as np
    import torch

    from repro_torch import tree as tree_util

    t0 = time.perf_counter()
    engine, eval_loss, cfg = cohort_engine(COHORT_ARGV, dev,
                                           draw=lambda cfg: card_params(cfg, dev, 0))
    torch.cuda.synchronize()
    fed, rounds_n = engine.fed_cfg, int(COHORT_ARGV[COHORT_ARGV.index("--steps") + 1])
    n_params = sum(int(p.numel()) for _, p in tree_util.leaves(engine.params))
    print(f"[cohort] (a) {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, remat "
          f"{cfg.remat_policy}: {n_params:,} parameters drawn on the card; "
          f"{engine.clients} clients x {engine.nb:,} block rows of N={engine.n} (M={fed.m}, "
          f"S={fed.s}, Q={fed.bits}); {' '.join(COHORT_ARGV)}; per-client gradient pass "
          f"{engine._per_client} (one client at a time); built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(engine._per_client and {p.dtype for _, p in tree_util.leaves(engine.params)}
          == {torch.bfloat16}, "[cohort] (a) the engine must keep the bf16 tree and take "
          "its clients one at a time")
    want = dict(encode=1, gamp=TRAIN_ITERS, qgamp=0)

    def one_round(_state, _batch):
        return None, {"loss": engine.run_round()["nmse"]}

    with captured_rounds() as rounds:
        for t in range(rounds_n):
            events = {}
            if t == 0:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                t1 = time.perf_counter()
                with phase_walls() as walls, client_pass_peak() as cpk:
                    nmse_t = one_round(None, None)[1]["loss"]
                wall, busy = 1e3 * (time.perf_counter() - t1), None
                counts = read_counts()
                peak = max(cpk["before"], torch.cuda.max_memory_allocated())
                print("[cohort] (a) round 0's phases (each ending in a device sync): "
                      + ", ".join(f"{k} {v:.1f} ms" for k, v in walls.items())
                      + f"; the one-pass client pass's peak {cpk['above_start'] / 2**30:.3f} GiB "
                      f"above its start ({cpk['start'] / 2**30:.3f} GiB)")
                rounds[0].pop("blocks")
                e = cohort_plain_decode(engine, rounds[0])
                print(f"[cohort] (a) round 0's decoded aggregate ({engine.nb:,} rows) against "
                      f"the plain versions' decode of the same payload (chunks of "
                      f"{PLAIN_CHUNK_ROWS:,} rows): NMSE {e:.3g} (<= 1e-3)")
                for key in ("words", "alpha", "ghat"):  # out of round 1's peak
                    rounds[0].pop(key)
            else:
                _, recs = traced_steps(one_round, None, [None])
                nmse_t, wall, busy, counts, peak, events = recs[0]
            got = {k: counts[k] for k in want}
            check(got == want, f"[cohort] (a) round {t}: launches {got}, want {want}")
            launches[COHORT_ENCODE] += counts["encode"]
            launches[COHORT_GAMP] += counts["gamp"]
            st = rounds[t]["stats"]
            loss = eval_loss(engine.params)
            cohort = int(rounds[t]["rhos"].numel())
            part = float(torch.sum(rounds[t]["rhos"] > 0))
            up = engine._wire_up_bytes(part)
            check(bool(np.isfinite(loss)) and np.isfinite(nmse_t),
                  f"[cohort] (a) round {t}: eval loss {loss}, nmse {nmse_t}")
            idle = "not measured" if busy is None else f"{max(0.0, 1 - busy / wall):.3f}"
            busy_s = "not measured" if busy is None else f"{busy:.3f} ms"
            print(f"[cohort] (a) round {t}: wall {wall:.3f} ms"
                  f"{' (under the trace)' if busy is not None else ' (no trace)'}, device busy "
                  f"{busy_s}, idle share {idle}, max_memory_allocated {peak / 2**30:.3f} GiB; "
                  f"launches encoder {counts['encode']} ({cohort} x {engine.nb:,} rows), "
                  f"gamp_step {counts['gamp']} ({engine.nb:,} rows); cohort {cohort}, "
                  f"participating {part:.0f}, nmse {nmse_t:.4f}, nu_quant "
                  f"{float(st['nu_quant']):.4g}; eval loss {loss:.6f}; wire up {up:,.0f} bytes, "
                  f"down {cohort * engine.nbar * 4.0:,.0f} bytes")
            if events:
                top = sorted(events.items(), key=lambda kv: -kv[1][1])[:8]
                print(f"[cohort] (a) round {t} device time by event: "
                      + "; ".join(f"{k[:48]} x{n} {ms:.3f} ms" for k, (n, ms) in top))
    # [time] at the cohort's shapes: round 1's blocks and its members' residual rows
    r1 = rounds[1]
    ids = np.nonzero(engine.sched_state.last_round == 1)[0]
    c = len(ids)
    blocks = r1.pop("blocks").reshape(c * engine.nb, engine.n)
    resid = engine.residuals[torch.as_tensor(ids, device=dev)].reshape(c * engine.nb, engine.n)
    rhos, a = r1["rhos"], engine.codec.a
    rounds.clear()
    del engine, r1
    gc.collect()  # the engine's gradient closures hold it in a reference cycle
    torch.cuda.empty_cache()
    timer = GpuTimer()
    rec, words, alpha = train_encode_time(dev, fed, blocks, resid, a, timer, "[cohort] (a)",
                                          f"the cohort's {c} x nb rows", plain_parts=8)
    del blocks, resid
    torch.cuda.empty_cache()
    times = {COHORT_ENCODE: rec}
    times[COHORT_GAMP] = gamp_step_time(
        dev, fed, words.reshape(c, -1, words.shape[1]), alpha.reshape(c, -1), rhos, a, timer,
        "[cohort] (a)", plain_parts=2)
    del words, alpha
    torch.cuda.empty_cache()
    print_train_times(times)
    return ({"encode_cohort": rec["err"], "gamp_cohort": times[COHORT_GAMP]["err"]}, times,
            cpk["above_start"])


def cohort_smoke_vs_cpu(dev, launches) -> None:
    """[cohort] (b): one round of each of COHORT_SMOKE_ARCHS' smoke configs
    (and of Qwen3-0.6B's with each of COHORT_SMOKE_EXTRA) on the card, its
    launches counted into ``launches``, against the same round on the CPU
    from the same parameters, A, batches and draws (each drawn on the CPU
    from its seed): the decoded aggregate to NMSE <= 1e-3, the parameters
    within 2 lr ([serve]'s smoke-config steps), the residuals to 1e-5 (the
    SSM family: beyond the two devices' gap in the gradient blocks they
    come from, as its [serve] train steps are held)."""
    import torch

    from repro_torch import tree as tree_util

    runs = ([(a, []) for a in COHORT_SMOKE_ARCHS] + [("qwen3-0.6b", x) for x in COHORT_SMOKE_EXTRA]
            + list(COHORT_SMOKE_INTERLEAVE))
    for arch, extra in runs:
        out = []
        for d in (dev, torch.device("cpu")):
            engine, _, cfg = cohort_engine(["--arch", arch] + COHORT_SMOKE_ARGV + extra, d)
            segs = {}
            if engine._grad_segments_fn is not None:  # keep the producer's blocks
                engine._grad_segments_fn = recording(engine._grad_segments_fn, segs)
            with captured_rounds() as rounds:
                zero_counts()
                stats = engine.run_round()
                if d.type == "cuda":
                    torch.cuda.synchronize()
                counts = read_counts()
            blocks = (rounds[0]["blocks"].cpu() if rounds[0]["blocks"] is not None
                      else torch.cat([segs[i] for i in range(len(segs))], dim=1))
            out.append((engine, stats, counts, blocks))
        (card, s_card, counts, b_card), (cpu, s_cpu, _, b_cpu) = out
        label = f"[cohort] (b) {arch} smoke{' ' + ' '.join(extra) if extra else ''}"
        interleaved = card._grad_segments_fn is not None
        want = dict(encode=len(card.layout.segments) if interleaved else 1, gamp=TRAIN_ITERS,
                    qgamp=0)
        got = {k: counts[k] for k in want}
        check(got == want, f"{label}: launches {got}, want {want}")
        launches[COHORT_SEG_ENCODE if interleaved else COHORT_ENCODE] += counts["encode"]
        launches[COHORT_GAMP] += counts["gamp"]
        e = nmse(card.last_ghat.cpu(), cpu.last_ghat)
        gap = max_param_gap(tree_util.tree_map(lambda v: v.cpu(), card.params), cpu.params)
        dres = torch.abs(card.residuals.cpu() - cpu.residuals)
        slack = torch.abs(b_card - b_cpu) if cfg.family in ("ssm", "hybrid") else 0.0
        check(e <= 1e-3 and gap <= 2 * 3e-3 and bool((dres <= 1e-5 + slack).all())
              and s_card["cohort"] == s_cpu["cohort"]
              and s_card["participating"] == s_cpu["participating"],
              f"{label}: aggregate NMSE {e:.3g}, parameters {gap:.3g}, residual "
              f"{float(dres.max()):.3g}, stats {s_card} vs {s_cpu}")
        print(f"{label}: {card.nb:,} rows a client; card vs CPU: aggregate NMSE {e:.3g} "
              f"(<= 1e-3), parameters max gap {gap:.3g} (<= 2 lr), residual max gap "
              f"{float(dres.max()):.3g}; nmse {s_card['nmse']:.5f} (CPU {s_cpu['nmse']:.5f}); "
              f"launches {got}")


def recording(hook, store: dict):
    """A ``grad_segments_fn`` that yields what ``hook`` yields and keeps a
    CPU copy of each segment's blocks in ``store`` (by segment index)."""
    def run(params, batch, layout):
        for idx, blocks in hook(params, batch, layout):
            store[idx] = blocks.cpu()
            yield idx, blocks
    return run


def one_pass_hook(prod, params):
    """The interleaved producer's one-pass oracle at ``params``: its
    ``grads_fn`` tree, then each segment sliced out of it in layout
    order."""
    def run(_params, batch, layout):
        tree = prod.grads_fn(params, batch)
        for seg in layout.segments:
            yield seg.index, layout.segment_blocks_batched(tree, seg.index)
    return run


def interleaved_wire_check(engine, rec, p0, batch, ids, label) -> str:
    """[cohort] (d): round 0's wire (``rec``, its ``captured_rounds``
    record, and the residual rows it left for ``ids``) against the
    streamed encode of the one-pass oracle (:func:`one_pass_hook` at the
    round's parameters ``p0``) from the same batch, weights and residual
    rows (zeros before round 0): 0 lanes, alphas and residuals differ."""
    import torch

    prod = engine._grad_segments_fn
    rhos = rec["rhos"]
    res0 = torch.zeros((len(ids), engine.nb, engine.n), device=engine.device)
    engine._grad_segments_fn = one_pass_hook(prod, p0)
    try:
        pay, _, res = engine._client_pass_streamed(batch, res0, rhos, rhos)
    finally:
        engine._grad_segments_fn = prod
    del res0  # written over in place
    torch.cuda.synchronize()
    jids = torch.as_tensor(ids, device=engine.device)
    lanes = int(torch.sum(pay["words"] != rec["words"]))
    alphas = int(torch.sum(pay["alpha"] != rec["alpha"]))
    resid = int(torch.sum(res != engine.residuals[jids]))
    check(lanes == alphas == resid == 0,
          f"{label} round 0's wire against the one-pass encode of grads_fn: {lanes} word "
          f"lanes, {alphas} alphas, {resid} residual entries differ")
    return (f"{lanes} of {pay['words'].numel():,} word lanes, {alphas} of "
            f"{pay['alpha'].numel():,} alphas and {resid} of {res.numel():,} residual entries "
            f"differ")


def interleaved_grads_check(engine, p0, batch, cfg, label):
    """[cohort] (d): the producer's ``grads_fn`` tree at round 0's
    parameters and batch against each client's ``steps.value_and_grad``
    (the default per-client path), bf16: each entry within 1e-2 of itself
    plus 1e-2 of its leaf's largest entry (grad_atol's scaling, at bf16's
    2^-8 rounding).  Returns (the tree, the worst deviation over the leaf's
    largest entry, the leaves compared)."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.runtime import steps

    tree = engine._grad_segments_fn.grads_fn(p0, batch)
    worst, n_leaves = 0.0, 0
    for i in range(next(iter(batch.values())).shape[0]):
        want = steps.value_and_grad(p0, {k: v[i] for k, v in batch.items()}, cfg)[1]
        for path, w in tree_util.leaves(want):
            g = tree_util.get(tree, path)[i]
            check(g.dtype == w.dtype and g.shape == w.shape, f"{label} grads_fn {path}: "
                  f"{g.dtype} {tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
            g, w = g.float(), w.float()
            scale = float(torch.max(torch.abs(w)))
            d = torch.abs(g - w)
            check(bool((d <= 1e-2 * torch.abs(w) + 1e-2 * scale).all()),
                  f"{label} grads_fn {path} client {i}: max deviation {float(d.max()):.3g} "
                  f"(leaf max {scale:.3g})")
            worst = max(worst, float(d.max()) / max(scale, 1e-30))
            n_leaves += 1
        del want
    return tree, worst, n_leaves


def cohort_interleaved(dev, launches, one_pass_peak: int) -> tuple:
    """[cohort] (d): (a)'s run with ``--interleave COHORT_INTERLEAVE``: the
    per-tensor layout split at the producer's layer chunks, each segment
    encoded as the backward pass makes it (one encoder launch a segment,
    then 15 gamp_step launches over nb rows a round; the counts set to 0
    just before each round and read just after, added to ``launches``),
    from (a)'s card-drawn parameters.  Round 0 untraced: its wall and each
    phase's, the client pass's peak above its start (beside the
    producer's ``peak_live_grad_bytes(C)`` and (a)'s ``one_pass_peak``),
    the round's peak; then the checks on round 0 (the wire against the
    one-pass oracle, ``grads_fn`` against the per-client gradients, the
    aggregate against the plain versions) and [time] of the encoder on the
    largest segment's C x rows (round 0's gradient of it and the residual
    rows round 0 left).  Round 1 under ``torch.profiler``.  Returns (max
    abs errors, [time] records)."""
    import gc

    import numpy as np
    import torch

    from repro_torch import tree as tree_util

    label = "[cohort] (d)"
    argv = COHORT_ARGV + ["--interleave", str(COHORT_INTERLEAVE)]
    t0 = time.perf_counter()
    engine, eval_loss, cfg = cohort_engine(argv, dev, draw=lambda cfg: card_params(cfg, dev, 0))
    torch.cuda.synchronize()
    prod, layout, fed = engine._grad_segments_fn, engine.layout, engine.fed_cfg
    c = int(round(float(COHORT_ARGV[COHORT_ARGV.index("--sample-frac") + 1]) * engine.clients))
    big = max(layout.segments, key=lambda seg: seg.rows)
    small = min(seg.rows for seg in layout.segments)
    bound = prod.peak_live_grad_bytes(c)
    print(f"{label} {cfg.name}: {' '.join(argv)}: {len(layout.segments)} segments over "
          f"{engine.nb:,} rows a client (largest {big.name} at {big.rows:,} rows, smallest "
          f"{small}), stages {prod.stage_names}; "
          f"peak_live_grad_bytes({c}) {bound / 2**30:.3f} GiB; built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(engine.cohort.encode_stream and prod.layout is layout
          and len(layout.segments) == 46 and not bool(engine.residuals.any()),
          f"{label} the engine must stream the encode over the producer's 46-segment layout "
          "from zero residuals")
    want = dict(encode=len(layout.segments), gamp=TRAIN_ITERS, qgamp=0)
    p0 = tree_util.tree_map(torch.clone, engine.params)

    def one_round(_state, _batch):
        return None, {"loss": engine.run_round()["nmse"]}

    errs, times = {}, {}
    with captured_rounds() as rounds:
        for t in range(2):
            events = {}
            if t == 0:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                t1 = time.perf_counter()
                with phase_walls() as walls, client_pass_peak() as cpk:
                    nmse_t = one_round(None, None)[1]["loss"]
                wall, busy = 1e3 * (time.perf_counter() - t1), None
                counts = read_counts()
                peak = max(cpk["before"], torch.cuda.max_memory_allocated())
                print(f"{label} round 0's phases (each ending in a device sync): "
                      + ", ".join(f"{k} {v:.1f} ms" for k, v in walls.items()))
                print(f"{label} round 0's client pass: peak {cpk['above_start'] / 2**30:.3f} GiB "
                      f"above its start ({cpk['start'] / 2**30:.3f} GiB: the engine's state and "
                      f"the round's residual gather); peak_live_grad_bytes({c}) "
                      f"{bound / 2**30:.3f} GiB; (a)'s one-pass client pass in this call "
                      f"{one_pass_peak / 2**30:.3f} GiB above its start")
                ids = np.nonzero(engine.sched_state.last_round == 0)[0]
                batch = engine.data.cohort_batch(0, ids)
                wire = interleaved_wire_check(engine, rounds[0], p0, batch, ids, label)
                print(f"{label} round 0's wire against the one-pass encode of the producer's "
                      f"grads_fn tree (same parameters, batch, weights and zero residual rows): "
                      f"{wire}")
                gc.collect()
                torch.cuda.empty_cache()
                tree, worst, n_leaves = interleaved_grads_check(engine, p0, batch, cfg, label)
                print(f"{label} grads_fn against each client's steps.value_and_grad (bf16, "
                      f"{n_leaves} leaves): worst deviation {worst:.3g} of the leaf's largest "
                      f"entry (<= 1e-2 + 1e-2 relative)")
                seg_blocks = layout.segment_blocks_batched(tree, big.index)
                del tree, p0
                gc.collect()
                torch.cuda.empty_cache()
                e = cohort_plain_decode(engine, rounds[0], label)
                print(f"{label} round 0's decoded aggregate ({engine.nb:,} rows) against the "
                      f"plain versions' decode of the same payload: NMSE {e:.3g} (<= 1e-3)")
                for key in ("words", "alpha", "ghat"):  # out of round 1's peak
                    rounds[0].pop(key)
                # [time] the encoder on the largest segment: round 0's gradient of it and
                # the residual rows round 0 left its clients
                jids = torch.as_tensor(ids, device=dev)
                resid = engine.residuals[:, big.row_slice][jids].reshape(-1, engine.n)
                rec, words, alpha = train_encode_time(
                    dev, fed, seg_blocks.reshape(-1, engine.n), resid, engine.codec.a,
                    GpuTimer(), label, f"the largest segment's {c} x {big.rows:,} rows",
                    plain_parts=2)
                times[COHORT_SEG_ENCODE], errs["encode_segment"] = rec, rec["err"]
                del seg_blocks, resid, words, alpha
                gc.collect()
                torch.cuda.empty_cache()
            else:
                _, recs = traced_steps(one_round, None, [None])
                nmse_t, wall, busy, counts, peak, events = recs[0]
            got = {k: counts[k] for k in want}
            check(got == want, f"{label} round {t}: launches {got}, want {want}")
            launches[COHORT_SEG_ENCODE] += counts["encode"]
            launches[COHORT_GAMP] += counts["gamp"]
            loss = eval_loss(engine.params)
            part = float(torch.sum(rounds[t]["rhos"] > 0))
            check(bool(np.isfinite(loss)) and np.isfinite(nmse_t),
                  f"{label} round {t}: eval loss {loss}, nmse {nmse_t}")
            idle = "not measured" if busy is None else f"{max(0.0, 1 - busy / wall):.3f}"
            busy_s = "not measured" if busy is None else f"{busy:.3f} ms"
            print(f"{label} round {t}: wall {wall:.3f} ms"
                  f"{' (under the trace)' if busy is not None else ' (no trace)'}, device busy "
                  f"{busy_s}, idle share {idle}, max_memory_allocated {peak / 2**30:.3f} GiB; "
                  f"launches encoder {counts['encode']} (one a segment, {c} x {small} to {c} x "
                  f"{big.rows:,} rows), gamp_step {counts['gamp']} ({engine.nb:,} rows); "
                  f"participating {part:.0f}, nmse {nmse_t:.4f}; eval loss {loss:.6f}")
            if events:
                top = sorted(events.items(), key=lambda kv: -kv[1][1])[:8]
                print(f"{label} round {t} device time by event: "
                      + "; ".join(f"{k[:48]} x{n} {ms:.3f} ms" for k, (n, ms) in top))
        rounds.clear()
    del engine
    gc.collect()  # the engine's gradient closures hold it in a reference cycle
    torch.cuda.empty_cache()
    print_train_times(times)
    return errs, times


@contextlib.contextmanager
def fd_stdout(path):
    """Standard output at the file-descriptor level into ``path`` (what
    spawned processes print too)."""
    import os

    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)


def cohort_example(dev) -> None:
    """[cohort] (c): ``examples/distributed_train_torch.py`` at its smoke
    config on the card (the reference's (2, 2, 2) world: eight ranks on the
    one card) for 12 steps with pod 1 down at steps 3-7, then a rerun that
    resumes after its step-10 checkpoint: the parameters, moments,
    residuals and step bit-identical to the uninterrupted run's."""
    import importlib.util
    import tempfile

    import torch

    from repro_torch import tree as tree_util

    spec = importlib.util.spec_from_file_location(
        "distributed_train_torch", ROOT / "examples" / "distributed_train_torch.py")
    example = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = example  # its ranks' function is pickled by this name
    spec.loader.exec_module(example)
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--steps", "12", "--inject-failure", "3", "--device", str(dev),
                "--ckpt-dir", tmp]
        logs = []
        t0 = time.perf_counter()
        for i in range(2):
            log = Path(tmp) / f"log{i}.txt"
            with fd_stdout(log):
                state = example.main(argv)
            logs.append((state, log.read_text()))
        wall = time.perf_counter() - t0
    (full, out), (again, out2) = logs
    down = [int(ln.split()[1]) for ln in out.splitlines() if "[pod1 DOWN]" in ln]
    same = all(torch.equal(leaf, tree_util.get(again[key], path))
               for key in ("params", "opt", "residual", "step")
               for path, leaf in tree_util.leaves(full[key]))
    check(down == [3, 4, 5, 6, 7] and "[restore] resumed after step 10" in out2 and same,
          f"[cohort] (c) the example: pod 1 down at {down}, restart bit-identical {same}")
    last = [ln for ln in out.splitlines() if ln.startswith("step")][-1]
    print(f"[cohort] (c) examples/distributed_train_torch.py on the card ((2, 2, 2): eight "
          f"ranks; 12 smoke steps, pod 1 "
          f"down at steps {down}; {last.strip()}): the rerun resumed after the step-10 "
          f"checkpoint, its state bit-identical to the uninterrupted run's ({wall:.1f} s both)")


def phase_cohort(dev):
    """[cohort] The launcher's cohort mode: (a) Qwen3-0.6B at full width,
    (d) the same with the interleaved producer, (b) the smoke configs on
    the card against the CPU, (c) the example's exact restart.  Returns (launches by KERNELS name, max abs errors,
    [time] records)."""
    launches = {COHORT_ENCODE: 0, COHORT_GAMP: 0, COHORT_SEG_ENCODE: 0}
    took = []
    t0 = time.perf_counter()
    errs, times, one_pass_peak = cohort_full_width(dev, launches)
    took.append(("(a)", time.perf_counter() - t0))
    d_errs, d_times = cohort_interleaved(dev, launches, one_pass_peak)
    took.append(("(d)", time.perf_counter() - t0 - sum(t for _, t in took)))
    errs.update(d_errs)
    times.update(d_times)
    cohort_smoke_vs_cpu(dev, launches)
    took.append(("(b)", time.perf_counter() - t0 - sum(t for _, t in took)))
    cohort_example(dev)
    took.append(("(c)", time.perf_counter() - t0 - sum(t for _, t in took)))
    print("[cohort] seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in took))
    return launches, errs, times


# [serve]: the serve steps (runtime/steps.py: make_prefill_step, then
# make_decode_step with donate=True) on six configurations at every
# published width, bf16 weights drawn on the card from seed 0: (label, arch,
# depth cut, batch, patch positions, text positions or, for the audio
# family, frames).  (a) Qwen3-MoE-235B-A22B at 2 of 94 layers; (b)
# DeepSeek-V3 at 1 dense + 1 MoE layer and its MTP block (MLA's latent
# cache); (c) Qwen2-VL-7B at full depth, a 512-patch prefix on a 16 x 32
# grid (t = 0, h, w) and text at its slot index on all three M-RoPE
# streams; (d) Mamba2-1.3B, all 48 layers (the SSD state cache); (e)
# Zamba2-2.7B, all 54 Mamba layers and the shared block after every 6; (f)
# Whisper-base, 6 + 6 layers, 1500 frames (init_cache's enc_len) a prompt.
# Each decodes SERVE_DECODE greedy tokens.
SERVE_RUNS = (
    ("a", "qwen3-moe-235b-a22b", dict(n_layers=2), 4, 0, 2048),
    ("b", "deepseek-v3-671b", dict(n_layers=2, first_dense_layers=1), 2, 0, 1024),
    ("c", "qwen2-vl-7b", {}, 2, 512, 1536),
    ("d", "mamba2-1.3b", {}, 4, 0, 2048),
    ("e", "zamba2-2.7b", {}, 2, 0, 2048),
    ("f", "whisper-base", {}, 4, 0, 1500),
)
SERVE_DECODE = 64
SERVE_FAMILIES = ("qwen3-moe-235b-a22b", "deepseek-v3-671b", "qwen2-vl-7b", "mamba2-1.3b",
                  "zamba2-2.7b", "whisper-base")


def serve_prompt(cfg, b: int, sv: int, st: int, dev, seed: int = 1) -> dict:
    """Uniform prompt tokens from a seeded card generator; a VLM prompt adds
    ``sv`` patch embeddings (normal(0, 0.02)) and its (3, B, sv + st)
    positions; an audio prompt is ``st`` frame embeddings (normal(0,
    0.02))."""
    import torch

    from repro_torch.models.common import dtype_of

    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "audio":
        return {"frames": (torch.randn((b, st, cfg.d_model), generator=gen, device=dev)
                           * 0.02).to(dtype_of(cfg))}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, st), generator=gen, device=dev)}
    if sv:
        i = torch.arange(sv, device=dev)
        text = torch.arange(sv, sv + st, device=dev)
        grid = torch.stack([torch.zeros_like(i), i // 32, i % 32])  # (t, h, w)
        pos = torch.cat([grid, text.expand(3, st)], dim=1)
        batch["patches"] = (torch.randn((b, sv, cfg.d_model), generator=gen, device=dev)
                            * 0.02).to(dtype_of(cfg))
        batch["positions"] = pos[:, None].expand(3, b, sv + st).contiguous()
    return batch


def first_decode_pos(cfg, s: int) -> int:
    """The position of the first decode step after a prefill of ``s``
    positions: Whisper's prefill already decoded its BOS token at 0."""
    return 1 if cfg.family == "audio" else s


# the trees whose leaves carry a leading layer axis, and the vector leaves
# that init_params fills with ones besides the norm scales
STACKS = ("layers", "layers_dense", "mamba_layers", "enc_layers", "dec_layers")
ONES = ("ln1", "ln2", "ln_x", "d_skip")


def init_rule(path, shape):
    """How ``init_params`` fills the leaf at ``path`` of ``shape``: "ones"
    (norm scales, the SSM's ``d_skip``), "zeros" (biases, the SSM's
    ``conv_b``, ``a_log`` and ``dt_bias``), or the std of a normal draw:
    0.02 for the embedding table and the SSM's conv taps (``dense_init``
    with no fan-in), else 1/sqrt(fan-in), the second-to-last axis."""
    if len(shape) - (path[0] in STACKS) < 2:
        return "ones" if "norm" in path[-1] or path[-1] in ONES else "zeros"
    if path == ("tok", "embed") or path[-1] == "conv_w":
        return 0.02
    return float(shape[-2]) ** -0.5


def check_init_rules(archs) -> None:
    """``init_rule`` against ``init_params`` for every leaf of each arch, on
    the CPU: the full-width tree (``device="meta"``) has the smoke config's
    paths and, leaf by leaf, the same kind of rule; the smoke config's
    CPU draw holds each rule (ones and zeros exactly, a normal draw's mean
    within 5 standard errors of 0 and its std within 10% of the rule's)."""
    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import model as model_api

    n_leaves = 0
    for arch in archs:
        full = tree_util.leaves(model_api.init_params(get_config(arch), device="meta"))
        small = tree_util.leaves(model_api.init_params(smoke_config(arch), seed=0,
                                                       device="cpu"))
        check([p for p, _ in full] == [p for p, _ in small],
              f"[serve] {arch}: the full-width tree's paths differ from the smoke config's")
        for (path, meta), (_, v) in zip(full, small):
            rule, kind = init_rule(path, v.shape), init_rule(path, meta.shape)
            check(isinstance(rule, str) == isinstance(kind, str) and (
                not isinstance(rule, str) or rule == kind),
                f"[serve] {arch} {path}: the rule at full width is {kind}, at smoke size {rule}")
            v = v.float()
            n_leaves += 1
            if rule == "ones" or rule == "zeros":
                want = 1.0 if rule == "ones" else 0.0
                check(bool((v == want).all()), f"[serve] {arch} {path}: init_params does not "
                      f"fill it with {rule}")
                continue
            mean, std = float(v.mean()), float(v.std())
            check(abs(mean) <= 5 * rule / v.numel() ** 0.5 and abs(std / rule - 1) <= 0.1,
                  f"[serve] {arch} {path} {tuple(v.shape)}: init_params' draw has mean "
                  f"{mean:.3g}, std {std:.4g}; the rule's std is {rule:.4g}")
    print(f"[serve] card_params' rule (init_rule) holds init_params' draw of every leaf of "
          f"{', '.join(archs)} at smoke size, {n_leaves} leaves, and the full-width trees have "
          f"the same paths and kinds of rule")


def card_params(cfg, dev, seed: int):
    """``cfg``'s tree drawn on the card from a seeded card generator, leaf by
    leaf over ``init_params(device="meta")``, each leaf by ``init_rule``
    (a full-width model in seconds; the CPU draw takes minutes)."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.models import model as model_api

    gen = torch.Generator(device=dev).manual_seed(seed)

    def fill(path, v):
        rule = init_rule(path, v.shape)
        if isinstance(rule, str):
            return (torch.ones if rule == "ones" else torch.zeros)(v.shape, dtype=v.dtype,
                                                                    device=dev)
        return (torch.randn(v.shape, generator=gen, device=dev) * rule).to(v.dtype)

    meta = model_api.init_params(cfg, device="meta")
    return tree_util.unflatten((path, fill(path, v)) for path, v in tree_util.leaves_in_order(meta))


@contextlib.contextmanager
def routed_pairs():
    """Wraps ``models/moe.py::dispatch``, which ``apply_moe`` calls once a MoE
    layer, and yields a list that gets one (kept pairs, distinct experts
    with a kept pair, dropped pairs) a call: the routing of the calls made
    inside, read from the model's own dispatch."""
    import torch

    from repro_torch.models import moe

    rec, inner = [], moe.dispatch

    def spy(topi, cap, n_experts):
        out = inner(topi, cap, n_experts)
        kept = out[3] < n_experts * cap
        rec.append((int(kept.sum()), int(torch.unique(out[1][kept]).numel()),
                    int((~kept).sum())))
        return out

    moe.dispatch = spy
    try:
        yield rec
    finally:
        moe.dispatch = inner


def traced_ms(fn, n: int):
    """(wall ms a call under the trace, device busy ms a call) of ``n``
    calls of ``fn``, each ending in a device sync, under one
    ``torch.profiler`` trace: busy is the summed time of the device events
    (one stream, so they do not overlap); None when the trace holds none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / n
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type != DeviceType.CPU) / 1e3
    return wall, (busy / n if busy else None)


def serve_bounds(params, cfg, b: int, s: int, routing) -> tuple:
    """The least time the card could take for this run's prefill of b x s
    tokens and for one decode step at b x 1 at position s (the step the
    trace replays), each (ms, "bytes" or "operations"): the larger of the
    bytes over 3.35 TB/s and the bf16 operations over 989 TFLOP/s.
    ``routing``: (prefill, decode), each the ``routed_pairs`` record of that
    call (one (kept pairs, distinct experts, dropped pairs) a MoE layer).
    Bytes: every weight the step runs read once -- of the expert stacks
    only the experts that got a kept pair; not the embedding table, of
    which it gathers a few rows, unless it is tied to the logits; not the
    MTP block, which serving does not run -- plus the cache written
    (prefill: s slots) or read (decode: slots 0..s).  Operations: 2 x each
    matrix's entries a token, an expert's a kept (token, expert) pair; the
    causal scores and their product with V (s (s + 1) / 2 query-key pairs
    a sequence and head in prefill, s + 1 in decode); the logits of the
    last position."""
    from repro_torch import tree as tree_util

    run = [(path, leaf) for path, leaf in tree_util.leaves(params) if path[0] != "mtp"
           and (path != ("tok", "embed") or cfg.tie_embeddings)]
    experts = [leaf for path, leaf in run if "experts" in path]
    dense = [(path, leaf) for path, leaf in run if "experts" not in path]
    # one expert of one layer: the stacks are (MoE layers, E, ...)
    n_exp = max(1, (cfg.n_layers - cfg.first_dense_layers) * cfg.n_experts) if experts else 1
    e_bytes = sum(v.numel() * v.element_size() for v in experts) / n_exp
    e_entries = sum(v.numel() for v in experts) / n_exp
    d_bytes = sum(v.numel() * v.element_size() for _, v in dense)
    width = (cfg.kv_lora_rank + cfg.qk_rope_head_dim if cfg.use_mla
             else 2 * cfg.n_kv_heads * cfg.head_dim)
    cache_bytes = cfg.n_layers * b * width * 2  # a slot of every layer, bf16
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim if cfg.use_mla else cfg.head_dim
    dv = cfg.v_head_dim if cfg.use_mla else cfg.head_dim

    def ops(tokens: int, pairs: int, qk: float) -> float:
        total = 2.0 * cfg.d_model * cfg.vocab_size * b  # the last position's logits
        for path, leaf in dense:
            stacked = path[0] in ("layers", "layers_dense")  # a leading L axis
            if leaf.dim() - stacked < 2 or path[0] == "tok":
                continue  # norms and biases; the logits are counted above
            total += 2.0 * leaf.numel() * tokens
        return (total + 2.0 * e_entries * pairs
                + cfg.n_layers * 2.0 * b * cfg.n_heads * qk * (dqk + dv))

    out = []
    for rec, slots, tokens, qk in ((routing[0], s, b * s, s * (s + 1) / 2),
                                   (routing[1], s + 1, b, s + 1)):
        kept, distinct = sum(r[0] for r in rec), sum(r[1] for r in rec)
        nbytes = d_bytes + distinct * e_bytes + cache_bytes * slots
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops(tokens, kept, qk) / BF16_FLOPS_PER_S
        out.append((1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"))
    return tuple(out)


def family_bounds(params, cfg, b: int, s: int, pos: int) -> tuple:
    """``serve_bounds`` for the SSM, hybrid and audio families: the prefill
    of b x s positions (Whisper: s frames, then its BOS step) and one
    decode step at ``pos``, each (ms, "bytes" or "operations").  Bytes:
    every weight the call runs read once (the tied embedding for the
    logits; Whisper's decode not its encoder nor the cross ``wk``/``wv``,
    whose K/V are cached), the cache written (prefill) or read and written
    (decode: the SSM states whole, the attention K/V at slots 0..pos, the
    cross K/V whole).  Operations: 2 x each weight matrix's entries a token
    (the shared block once a group; the conv taps count as a matrix),
    causal or full attention (2 x heads x (query, key) pairs x 2 head
    dims), the SSD scan in fp32 (the causal half of each chunk's
    C . B^T and its product with x, the chunk states, the inter-chunk
    recurrence and the states' output term; decode: the state's decay,
    update and read), the last position's logits; bf16 operations over
    989 TFLOP/s plus fp32 ones over 67."""
    from repro_torch import tree as tree_util

    leaves = tree_util.leaves(params)
    nbytes = lambda pred: sum(v.numel() * v.element_size() for p_, v in leaves if pred(p_))
    size = lambda v: v.numel() * v.element_size()

    def entries(pred) -> float:  # weight-matrix entries (not norms, biases, the table)
        return float(sum(v.numel() for p_, v in leaves if pred(p_) and p_[0] != "tok"
                         and v.dim() - (p_[0] in STACKS) >= 2))

    logits = 2.0 * cfg.d_model * cfg.vocab_size * b
    attn = lambda layers, pairs: layers * 2.0 * b * cfg.n_heads * pairs * 2 * cfg.head_dim
    kv_slot = 2 * b * cfg.n_kv_heads * cfg.head_dim * 2  # K and V of one slot, bf16
    out = {}
    if cfg.family == "audio":
        skip = lambda p_: p_[0] == "dec_layers" and p_[1] == "cross_attn" and p_[2] in ("wk",
                                                                                      "wv")
        dec_w = lambda p_: p_[0] in ("dec_layers", "final_norm", "tok") and not skip(p_)
        cross = cfg.n_layers * s * kv_slot
        pre_ops = (2.0 * entries(lambda p_: p_[0] == "enc_layers") * b * s
                   + attn(cfg.n_encoder_layers, s * s)
                   + 2.0 * entries(skip) * b * s
                   + 2.0 * entries(dec_w) * b + attn(cfg.n_layers, 1 + s) + logits)
        pre_bytes = (nbytes(lambda p_: True) + b * s * cfg.d_model * 2 + cross
                     + cfg.n_layers * kv_slot)
        dec_ops = 2.0 * entries(dec_w) * b + attn(cfg.n_layers, pos + 1 + s) + logits
        dec_bytes = nbytes(dec_w) + cross + cfg.n_layers * (pos + 2) * kv_slot
        out = ((pre_bytes, pre_ops, 0.0), (dec_bytes, dec_ops, 0.0))
    else:
        n_h, p_dim, n_st = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        lc = cfg.ssm_chunk
        c = -(-s // lc)
        stack = "layers" if cfg.family == "ssm" else "mamba_layers"
        in_stack = lambda p_: p_[0] == stack
        state = cfg.n_layers * b * (n_h * p_dim * n_st * 4
                                    + (cfg.ssm_conv_kernel - 1) * (cfg.d_inner + 2 * n_st) * 2)
        ssd = cfg.n_layers * 2.0 * b * (c * lc * (lc + 1) / 2 * (n_st + n_h * p_dim)
                                        + 2 * c * lc * n_h * p_dim * n_st
                                        + (c + 1) ** 2 * n_h * p_dim * n_st)
        ssd_dec = cfg.n_layers * 6.0 * b * n_h * p_dim * n_st
        pre_ops = 2.0 * entries(in_stack) * b * s + logits
        dec_ops = 2.0 * entries(in_stack) * b + logits
        pre_cache, dec_cache = state, 2 * state
        if cfg.family == "hybrid":
            groups = cfg.n_layers // cfg.attn_every
            shared = entries(lambda p_: p_[0] == "shared")
            pre_ops += groups * 2.0 * shared * b * s + attn(groups, s * (s + 1) / 2)
            dec_ops += groups * 2.0 * shared * b + attn(groups, pos + 1)
            pre_cache += groups * s * kv_slot
            dec_cache += groups * (pos + 2) * kv_slot
        w = nbytes(lambda p_: p_ != ("tok", "embed") or cfg.tie_embeddings)
        out = ((w + pre_cache, pre_ops, ssd), (w + dec_cache, dec_ops, ssd_dec))
    res = []
    for nb_, bf16_ops, f32_ops in out:
        t_bytes = nb_ / HBM_BYTES_PER_S
        t_ops = bf16_ops / BF16_FLOPS_PER_S + f32_ops / FP32_FLOPS_PER_S
        res.append((1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"))
    return tuple(res)


@contextlib.contextmanager
def mamba_decode_calls():
    """Wraps ``models/ssm.py::apply_mamba_decode``, which the SSM and hybrid
    decode steps call once a Mamba layer, in order, and yields a list that
    gets one (layer weights, the layer's input (B, 1, D), its old ``conv``
    and ``ssm`` state) a call, copied before the call."""
    from repro_torch.models import ssm

    rec, inner = [], ssm.apply_mamba_decode

    def spy(p, x, cfg, cache):
        rec.append((p, x.clone(), {k: v.clone() for k, v in cache.items()}))
        return inner(p, x, cfg, cache)

    ssm.apply_mamba_decode = spy
    try:
        yield rec
    finally:
        ssm.apply_mamba_decode = inner


def mamba_step_error(cfg, calls, conv, ssm_state) -> float:
    """Holds a decode step's new Mamba states -- ``conv`` and ``ssm_state``
    (L, B, ...) as the step left them in the donated cache -- against one
    plain recurrence step from each layer's recorded input and old state
    (``mamba_decode_calls``): the conv window shifted by the layer's new
    pre-conv x|B|C bit for bit; the SSD state decayed by exp(dt A) plus dt
    x B^T, computed here in fp32 from the layer's weights.  Returns the
    largest state error relative to the layer's largest state entry."""
    import torch
    import torch.nn.functional as F

    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    check(len(calls) == cfg.n_layers, f"{len(calls)} Mamba decode calls, want {cfg.n_layers}")
    worst = 0.0
    for i, (lp, x, old) in enumerate(calls):
        zx = x[:, 0] @ lp["in_proj"]
        window = torch.cat([old["conv"], zx[:, di:2 * di + 2 * n][:, None]], dim=1)
        check(torch.equal(conv[i], window[:, 1:]), f"Mamba layer {i}: the decode's conv "
              "window is not the old one shifted by the new input")
        taps = sum(window[:, k].float() * lp["conv_w"][k].float()
                   for k in range(window.shape[1]))
        xbc = F.silu(taps + lp["conv_b"].float())
        xs, bm = xbc[:, :di].reshape(-1, h, p), xbc[:, di:di + n]
        dt = F.softplus(zx[:, 2 * di + 2 * n:].float() + lp["dt_bias"])
        decay = torch.exp(-dt * torch.exp(lp["a_log"]))
        want = (old["ssm"] * decay[:, :, None, None]
                + (xs * dt[:, :, None])[..., None] * bm[:, None, None, :])
        err = float(torch.max(torch.abs(ssm_state[i] - want)) / torch.max(torch.abs(want)))
        worst = max(worst, err)
    return worst


def serve_one(label, arch, cut, b, sv, st, dev, smi) -> None:
    """One configuration of SERVE_RUNS: weights, prefill (a warm-up call
    that records the MoE routing, then the timed one), the cache grown to
    smax (``model.grow_cache``), SERVE_DECODE donated decode steps (each
    timed to its device sync; the first checked per cache kind: an
    attention cache changes slot ``pos`` and no other, bit for bit, the
    encoder's cross K/V not at all, the Mamba states by one plain
    recurrence step), a replay of the first step that records its routing,
    then the prefill and 8 replays under ``torch.profiler`` (device busy,
    idle share)."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.models import model as model_api
    from repro_torch.models.moe import capacity
    from repro_torch.runtime import steps

    cfg = dc.replace(get_config(arch), **cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = card_params(cfg, dev, seed=0)
    torch.cuda.synchronize()
    leaves = [v for _, v in tree_util.leaves(params)]
    n_params = sum(v.numel() for v in leaves)
    wbytes = sum(v.numel() * v.element_size() for v in leaves)
    depth = (f"{cfg.n_encoder_layers} + {cfg.n_layers}" if cfg.is_encoder_decoder
             else f"{cfg.n_layers} of {get_config(arch).n_layers}")
    print(f"[serve] ({label}) {cfg.name}: {depth} layers"
          + (f" ({cfg.first_dense_layers} dense)" if cfg.first_dense_layers else "")
          + (", MTP block" if cfg.mtp else "")
          + (f", the shared block after every {cfg.attn_every}" if cfg.attn_every else "")
          + (f", SSM state {cfg.ssm_state}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}"
             if cfg.family in ("ssm", "hybrid") else "")
          + f", d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {n_params:,} parameters, {wbytes:,} weight bytes "
          f"({wbytes / 2**30:.3f} GiB), drawn on the card in {time.perf_counter() - t0:.1f} s "
          f"| {smi}")
    mesh = make_single_device_mesh()
    prompt = serve_prompt(cfg, b, sv, st, dev)
    s = sv + st
    pos0 = first_decode_pos(cfg, s)
    smax = pos0 + SERVE_DECODE
    prefill = steps.make_prefill_step(cfg, mesh)
    walls = []

    def timed_prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(params, prompt)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        return out

    with routed_pairs() as rec:
        timed_prefill()
    routing = [rec]
    logits, pc = timed_prefill()
    check(logits.shape == (b, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"[serve] ({label}) prefill logits {tuple(logits.shape)} not finite or misshapen")
    for path, v in tree_util.leaves(pc):
        check(path[-1] not in model_api.SLOT_LEAVES or v.shape[2] == s,
              f"[serve] ({label}) prefill cache {path} {tuple(v.shape)}: want {s} slots")
        check(bool(torch.isfinite(v).all()), f"[serve] ({label}) prefill cache {path}")
    cache = model_api.grow_cache(pc, smax)
    del pc
    decode = steps.make_decode_step(cfg, mesh, donate=True)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    ms, toks, kinds = [], [tok], []
    for t in range(SERVE_DECODE):
        first = t == 0
        before = tree_util.tree_map(torch.clone, cache) if first else None
        with mamba_decode_calls() if first else contextlib.nullcontext([]) as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, lo, new = decode(params, cache, tok, pos0 + t)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        toks.append(tok)
        if first:
            for path, v in tree_util.leaves(new):
                check(v is tree_util.get(cache, path), f"[serve] ({label}) donate=True must "
                      f"write the caller's cache {path} in place")
                old = tree_util.get(before, path)
                if path[-1] in model_api.SLOT_LEAVES:
                    diff = (v != old).reshape(*v.shape[:3], -1).any(-1)
                    slots = torch.nonzero(diff.any(0).any(0)).flatten().tolist()
                    check(slots == [pos0], f"[serve] ({label}) the donated decode at pos "
                          f"{pos0} changed slots {slots[:8]} of {path}, want [{pos0}] only")
                elif path[-1] in ("cross_k", "cross_v"):
                    check(torch.equal(v, old), f"[serve] ({label}) the decode changed {path}")
            kinds = sorted({path[-1] for path, _ in tree_util.leaves(new)})
            if calls:
                mstate = new["mamba"] if cfg.family == "hybrid" else new
                err = mamba_step_error(cfg, calls, mstate["conv"], mstate["ssm"])
                check(err <= 2e-2, f"[serve] ({label}) the decode's SSD states are {err:.3g} "
                      "(relative) from one plain recurrence step")
                kinds.append(f"SSD states {err:.3g} from one plain recurrence step")
            del before, calls
        cache = new
    check(bool(torch.isfinite(lo).all()) and lo.shape == (b, 1, cfg.vocab_size),
          f"[serve] ({label}) decode logits")
    seq = torch.cat(toks, dim=1)
    check(int(seq.min()) >= 0 and int(seq.max()) < cfg.vocab_size, f"[serve] ({label}) tokens")
    med = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated()
    with routed_pairs() as rec:  # a replay of the first step (its slot rewritten)
        decode(params, cache, toks[0], pos0)
    routing.append(rec)
    # where the time goes: the prefill and 8 replays of the first decode
    # step (the same work) under torch.profiler
    pre_wall, pre_busy = traced_ms(lambda: prefill(params, prompt), 1)
    dec_wall, dec_busy = traced_ms(lambda: decode(params, cache, toks[0], pos0), 8)
    shares = [("not measured" if busy is None else f"device busy {busy:.3f} ms, idle share "
               f"{1 - busy / wall:.3f}") for wall, busy in ((pre_wall, pre_busy),
                                                            (dec_wall, dec_busy))]
    if cfg.family in ("ssm", "hybrid", "audio"):
        bounds_of = "family_bounds"
        (pre_bound, pre_by), (dec_bound, dec_by) = family_bounds(params, cfg, b, s, pos0)
    else:
        bounds_of = "serve_bounds, this run's routing"
        (pre_bound, pre_by), (dec_bound, dec_by) = serve_bounds(params, cfg, b, s, routing)
    what = (f"{s} frames, then its BOS step" if cfg.family == "audio" else
            f"{s} tokens" + (f" ({sv} patch + {st} text positions)" if sv else ""))
    print(f"[serve] ({label}) prefill {b} x {what}"
          + f": {walls[1]:.3f} ms (first call{', recording the routing' if cfg.is_moe else ''}, "
          f"{walls[0]:.3f} ms); decode {SERVE_DECODE} tokens a sequence from position {pos0}, "
          f"smax {smax}, donate=True: median "
          f"{med:.3f} ms a token (min {min(ms):.3f}, max {max(ms):.3f}), {b / med * 1e3:.1f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB | {smi}")
    print(f"[serve] ({label}) under torch.profiler: prefill wall {pre_wall:.3f} ms, "
          f"{shares[0]}; decode wall {dec_wall:.3f} ms a token, {shares[1]} | {smi}")
    print(f"[serve] ({label}) bound ({bounds_of}): prefill "
          f"{pre_bound:.3f} ms ({pre_by}), decode {dec_bound:.3f} ms a token ({dec_by}) | {smi}")
    print(f"[serve] ({label}) the donated first decode at pos {pos0}, cache leaves {kinds}: "
          f"each attention K/V leaf changed slot {pos0} and no other, bit for bit, cross K/V "
          f"none; greedy tokens of sequence 0: {seq[0, :12].tolist()}")
    if cfg.is_moe:
        for name, tokens, rec in (("prefill", b * s, routing[0]), ("decode", b, routing[1])):
            print(f"[serve] ({label}) MoE {name} ({tokens} tokens x top-"
                  f"{cfg.n_experts_per_tok} over {cfg.n_experts} experts, capacity "
                  f"{capacity(tokens, cfg)} slots an expert), per MoE layer: kept pairs "
                  f"{[r[0] for r in rec]}, dropped {[r[2] for r in rec]}, experts with a "
                  f"kept pair {[r[1] for r in rec]}")
    del params, cache, prompt, logits, lo
    torch.cuda.empty_cache()


def serve_mla_check(dev) -> None:
    """MLA's absorbed decode against its decompressed train attention (the
    reference's contract, rtol 2e-3 / atol 2e-4): one DeepSeek-V3 MLA layer
    at full width in fp32, 16 positions of 2 sequences decoded one at a
    time from an empty latent cache, every position held."""
    import dataclasses as dc

    import torch

    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.models import mla

    cfg = dc.replace(get_config("deepseek-v3-671b"), dtype="float32")
    lp = mla.init_mla(prng.PRNGKey(3, device=dev), cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    b, s = 2, 16
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev) * 0.1
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    with torch.inference_mode():
        train = mla.apply_mla_train(lp, x, pos, cfg)
        cache = {"ckv": torch.zeros((b, s, cfg.kv_lora_rank), device=dev),
                 "kr": torch.zeros((b, s, cfg.qk_rope_head_dim), device=dev)}
        outs = []
        for t in range(s):
            out, cache = mla.apply_mla_decode(lp, x[:, t:t + 1], pos[:, t:t + 1], cfg, cache, t)
            outs.append(out)
    dec = torch.cat(outs, dim=1)
    err = float(torch.max(torch.abs(dec - train)))
    ok = bool(torch.allclose(dec, train, rtol=2e-3, atol=2e-4))
    check(ok, f"[serve] MLA absorbed decode vs decompressed train attention: max abs err {err:.3g}")
    print(f"[serve] MLA (DeepSeek-V3 layer at full width, fp32: {cfg.n_heads} heads, ranks "
          f"{cfg.q_lora_rank}/{cfg.kv_lora_rank}, rope {cfg.qk_rope_head_dim}): the absorbed "
          f"decode of {s} positions x {b} sequences equals the decompressed train attention, "
          f"max abs err {err:.3g} (rtol 2e-3 / atol 2e-4)")
    del lp, cache, train, dec, outs
    torch.cuda.empty_cache()


def serve_mrope_check(dev) -> None:
    """Prefill's last logits against sequential decode (the reference's
    contract, rtol/atol 2e-2) on Qwen2-VL-7B at full width in fp32, 4
    layers, a text-only prompt (no patches; positions 0..S-1 on all three
    M-RoPE streams, which decode gives slot ``pos``)."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as model_api

    cfg = dc.replace(get_config("qwen2-vl-7b"), dtype="float32", n_layers=4)
    params = card_params(cfg, dev, seed=5)
    b, s = 2, 16
    gen = torch.Generator(device=dev).manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    batch = {"tokens": tokens, "patches": torch.zeros((b, 0, cfg.d_model), device=dev),
             "positions": torch.arange(s, device=dev).expand(3, b, s)}
    with torch.inference_mode():
        lp, _ = model_api.prefill(params, batch, cfg)
        cache = model_api.init_cache(cfg, b, s, device=dev)
        for t in range(s):
            ld, cache = model_api.decode_step(params, cache, tokens[:, t:t + 1], t, cfg,
                                              inplace=True)
    err = float(torch.max(torch.abs(lp - ld)))
    check(bool(torch.allclose(lp, ld, rtol=2e-2, atol=2e-2)),
          f"[serve] Qwen2-VL prefill vs sequential decode: max abs err {err:.3g}")
    print(f"[serve] M-RoPE + GQA cache (Qwen2-VL-7B at full width, 4 layers, fp32, sections "
          f"{cfg.mrope_sections}): prefill's last logits equal {s} sequential decode steps', "
          f"max abs err {err:.3g} (rtol/atol 2e-2)")
    del params, cache, lp, ld
    torch.cuda.empty_cache()


def serve_moe_check(dev) -> None:
    """One Qwen3-MoE layer at full width in fp32 on 64 tokens against a
    per-token loop: each kept (token, expert) pair adds w * expert(x), a
    pair past its expert's capacity (the first ``cap`` tokens of each
    expert, in token order, are kept) adds nothing; zeroed experts give
    exactly 0.  The tokens share a common direction, so some experts
    overflow."""
    import dataclasses as dc

    import torch
    import torch.nn.functional as F

    from repro_torch import prng
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe

    cfg = dc.replace(get_config("qwen3-moe-235b-a22b"), dtype="float32")
    p = moe.init_moe(prng.PRNGKey(7, device=dev), cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    t, k, e = 64, cfg.n_experts_per_tok, cfg.n_experts
    x = (torch.randn((1, t, cfg.d_model), generator=gen, device=dev) * 0.5
         + torch.randn((1, 1, cfg.d_model), generator=gen, device=dev))
    cap = moe.capacity(t, cfg)
    with torch.inference_mode():
        y = moe.apply_moe(p, x, cfg)[0]
        probs = torch.softmax(x[0] @ p["router"], dim=-1).cpu().tolist()
        want = torch.zeros_like(y)
        load = [0] * e
        kept = dropped = 0
        for i in range(t):
            top = sorted(range(e), key=lambda j: (-probs[i][j], j))[:k]
            norm = sum(probs[i][j] for j in top)
            for j in top:
                load[j] += 1
                if load[j] > cap:
                    dropped += 1
                    continue
                kept += 1
                ex = p["experts"]
                h = F.silu(x[0, i] @ ex["wg"][j]) * (x[0, i] @ ex["wi"][j])
                want[i] += (probs[i][j] / norm) * (h @ ex["wo"][j])
        zero = {"router": p["router"],
                "experts": {n: torch.zeros_like(v) for n, v in p["experts"].items()}}
        y0 = moe.apply_moe(zero, x, cfg)
    err = float(torch.max(torch.abs(y - want)))
    check(dropped > 0 and bool(torch.allclose(y, want, rtol=1e-4, atol=1e-5)),
          f"[serve] MoE dispatch vs the per-token loop: max abs err {err:.3g}, {dropped} dropped")
    check(bool((y0 == 0).all()), "[serve] zeroed experts must give exactly 0")
    print(f"[serve] MoE dispatch (Qwen3-MoE layer at full width, fp32, {t} tokens, capacity "
          f"{cap}): {kept} kept and {dropped} dropped pairs, equal to the per-token loop, max "
          f"abs err {err:.3g} (rtol 1e-4 / atol 1e-5); zeroed experts give exactly 0")
    del p, zero, x, y, want
    torch.cuda.empty_cache()


def grad_atol(cfg, want) -> float:
    """The card-vs-CPU gradient atol of a leaf: 1e-5, and for the SSM,
    hybrid and audio families 1e-5 x the leaf's largest entry where that
    exceeds 1.  Zamba2's smoke gradients reach ~40 (``conv_b``), and there
    fp32 rounding alone moves an entry by ~1e-6 of the leaf's scale: the
    reference's own fp32 gradient lies 8e-5 from its float64 one on that
    leaf (``tests/test_torch_families.py``)."""
    if cfg.family not in ("ssm", "hybrid", "audio"):
        return 1e-5
    return 1e-5 * max(1.0, float(want.abs().max()))


def serve_family_vs_cpu(arch, dev) -> None:
    """``arch``'s smoke config in fp32 on the card against the same model on
    the CPU: the loss (1e-5) and every gradient leaf (rtol 1e-4 / atol
    ``grad_atol``: an embedding row's gradient sums O(1) terms of each of
    its tokens that cancel to ~1e-3, and two summation orders part there by
    ~3e-6),
    prefill's logits and cache, and 8 decode steps fed the CPU's greedy
    tokens (logits each step and the final cache, rtol 1e-4 / atol
    1e-5)."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import model as model_api
    from repro_torch.runtime import steps

    cfg = smoke_config(arch)

    def run(device, feed=None):
        params = model_api.init_params(cfg, seed=3, device=device)
        gen = torch.Generator().manual_seed(4)
        b, s, sv = 2, 24, (6 if cfg.family == "vlm" else 0)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s - sv), generator=gen),
                 "labels": torch.randint(0, cfg.vocab_size, (b, s - sv), generator=gen)}
        if sv:
            batch["patches"] = torch.randn((b, sv, cfg.d_model), generator=gen) * 0.02
            batch["positions"] = torch.stack([torch.arange(s), torch.arange(s) // 2,
                                              torch.arange(s) % 3])[:, None].expand(3, b, s)
        if cfg.family == "audio":  # 20 frames; the prompt is the frames alone
            batch["frames"] = torch.randn((b, 20, cfg.d_model), generator=gen) * 0.02
        batch = {k: v.to(device) for k, v in batch.items()}
        loss, grads = steps.value_and_grad(params, batch, cfg)
        prompt = ({"frames": batch["frames"]} if cfg.family == "audio"
                  else {k: v for k, v in batch.items() if k != "labels"})
        logits, pc = steps.make_prefill_step(cfg, None)(params, prompt)
        s = first_decode_pos(cfg, s)
        cache = model_api.grow_cache(pc, s + 8)
        decode = steps.make_decode_step(cfg, None)
        tok, outs, toks = torch.argmax(logits[:, -1], -1)[:, None], [], []
        for t in range(8):
            tok = tok if feed is None else feed[t].to(device)
            toks.append(tok.cpu())
            tok, lo, cache = decode(params, cache, tok, s + t)
            outs.append(lo.cpu())
        cpu_ = lambda tree: tree_util.tree_map(lambda v: v.cpu(), tree)
        return (float(loss), cpu_(grads), logits.cpu(), cpu_(pc), outs, toks, cpu_(cache))

    cpu = run("cpu")
    card = run(dev, feed=cpu[5])
    gap = lambda a, b_: float(torch.max(torch.abs(a - b_)))
    close = lambda a, b_, rtol, atol: bool(torch.allclose(a, b_, rtol=rtol, atol=atol))
    check(abs(card[0] - cpu[0]) <= 1e-5, f"[serve] {arch} smoke: loss {card[0]} vs {cpu[0]}")
    g_err, bad = 0.0, []
    for path, g in tree_util.leaves(card[1]):
        want = tree_util.get(cpu[1], path)
        atol = grad_atol(cfg, want)
        if not close(g, want, 1e-4, atol):
            past = torch.abs(g - want) > atol + 1e-4 * torch.abs(want)
            i = int(torch.argmax((torch.abs(g - want) - 1e-4 * torch.abs(want)).flatten()))
            bad.append(f"{path}: {int(past.sum())} of {g.numel()} past, max abs err "
                       f"{gap(g, want):.3g}, worst {float(g.flatten()[i]):.6g} vs "
                       f"{float(want.flatten()[i]):.6g}, |want| max {float(want.abs().max()):.3g}")
        g_err = max(g_err, gap(g, want))
    check(not bad, f"[serve] {arch} smoke: gradients " + "; ".join(bad))
    f_err = gap(card[2], cpu[2])
    check(close(card[2], cpu[2], 1e-4, 1e-5), f"[serve] {arch} smoke: prefill logits")
    for idx in (3, 6):
        for path, v in tree_util.leaves(card[idx]):
            want = tree_util.get(cpu[idx], path)
            check(close(v, want, 1e-4, 1e-5), f"[serve] {arch} smoke: cache {path}")
            f_err = max(f_err, gap(v, want))
    for t, (a_, b_) in enumerate(zip(card[4], cpu[4])):
        check(close(a_, b_, 1e-4, 1e-5), f"[serve] {arch} smoke: decode step {t} logits")
        f_err = max(f_err, gap(a_, b_))
    print(f"[serve] {arch} smoke config (fp32) on the card vs the CPU: loss {card[0]:.6f} "
          f"(CPU {cpu[0]:.6f}), gradients max abs err {g_err:.3g} (rtol 1e-4 / grad_atol); "
          f"prefill logits and cache, 8 decode steps' logits and cache max abs err {f_err:.3g} "
          f"(rtol 1e-4 / atol 1e-5)")


def serve_family_train_steps(arch, dev) -> dict:
    """One ``impl="auto"`` FedQCS step (2 pods, [train]'s FedQCS point:
    N = 255, the kernel route) of ``arch``'s smoke config, AE and EA, with
    the launch counts set to 0 just before and read just after, held
    against the same step with the plain versions swapped in: the decoded
    aggregate the step applied (Adam's first moment, 0.1 x the clipped
    aggregate after a first step) to NMSE <= 1e-3, as [train] (c) holds it;
    the loss, the residual to 1e-5 and the parameters within 2 lr.
    Returns the launches."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.synthetic import TokenDataset
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.models import model as model_api
    from repro_torch.runtime import steps

    cfg = smoke_config(arch)
    batch = TokenDataset(cfg.vocab_size, batch=8, seq=16, seed=7).get_batch(0, device=dev)
    if cfg.family == "vlm":
        gen = torch.Generator().manual_seed(2)
        batch["patches"] = (torch.randn((8, 4, cfg.d_model), generator=gen) * 0.02).to(dev)
        batch["positions"] = torch.arange(20, device=dev).expand(3, 8, 20)
    if cfg.family == "audio":
        gen = torch.Generator().manual_seed(2)
        batch["frames"] = (torch.randn((8, 16, cfg.d_model), generator=gen) * 0.02).to(dev)
    params = model_api.init_params(cfg, seed=0, device=dev)
    total = {"encode": 0, "gamp": 0, "qgamp": 0}
    for mode in ("ae", "ea"):
        fed = train_fed(recon_mode=mode)
        fn = steps.make_train_step(cfg, train_opt(), fed, make_single_device_mesh(), device=dev)
        zero_counts()
        got, m = fn(train_state(cfg, fed, params, dev), batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        counts = read_counts()
        want = dict(encode=TRAIN_PODS, gamp=TRAIN_ITERS if mode == "ae" else 0,
                    qgamp=TRAIN_ITERS if mode == "ea" else 0)
        check({k: counts[k] for k in want} == want,
              f"[serve] {arch} {mode} train step launches {counts}, want {want}")
        with plain_kernels():
            plain, mp = fn(train_state(cfg, fed, params, dev), batch)
        moment = [torch.cat([v.flatten() for _, v in tree_util.leaves_in_order(st["opt"]["m"])])
                  for st in (got, plain)]
        agg = nmse(*moment)
        dres = float(torch.max(torch.abs(got["residual"] - plain["residual"])))
        gap = max_param_gap(got["params"], plain["params"])
        check(agg <= 1e-3 and float(torch.sum(moment[1] ** 2)) > 0,
              f"[serve] {arch} {mode} step: the applied aggregate is at NMSE {agg:.3g} to the "
              f"plain versions'")
        check(bool(np.isfinite(loss)) and abs(loss - float(mp["loss"])) <= 1e-5 and dres <= 1e-5
              and gap <= 2 * 3e-3, f"[serve] {arch} {mode} step vs the plain versions: loss "
              f"{loss} vs {float(mp['loss'])}, residual {dres:.3g}, parameters {gap:.3g}")
        print(f"[serve] {arch} smoke config, one impl=\"auto\" FedQCS {mode.upper()} step on the "
              f"kernel route ({got['residual'].shape[1]:,} rows a pod of N={TRAIN_N}): loss "
              f"{loss:.6f}, launches {want}; against the plain versions: the applied aggregate "
              f"(Adam's first moment) at NMSE {agg:.3g} (<= 1e-3), residual max gap {dres:.3g}, "
              f"parameters max gap {gap:.3g} (<= 2 lr)")
        for key in total:
            total[key] += counts[key]
    return total


def phase_serve(dev, smi) -> dict:
    """[serve] The serve path: ``card_params``' rule against ``init_params``
    (on the CPU); the MLA, M-RoPE/GQA-cache and MoE-dispatch checks at full
    width in fp32; the six families' smoke configs on the card against the
    CPU and their FedQCS train steps on the kernel route; then SERVE_RUNS
    (a)-(f) at full width, one after another.  Returns the train steps'
    launches by KERNELS name."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    check_init_rules(SERVE_FAMILIES)
    serve_mla_check(dev)
    serve_mrope_check(dev)
    serve_moe_check(dev)
    launches = {f"bqcs_encode_fused[N={TRAIN_N}]": 0, f"gamp_step[N={TRAIN_N}]": 0,
                f"qgamp_step[N={TRAIN_N}]": 0}
    for arch in SERVE_FAMILIES:
        serve_family_vs_cpu(arch, dev)
        counts = serve_family_train_steps(arch, dev)
        launches[f"bqcs_encode_fused[N={TRAIN_N}]"] += counts["encode"]
        launches[f"gamp_step[N={TRAIN_N}]"] += counts["gamp"]
        launches[f"qgamp_step[N={TRAIN_N}]"] += counts["qgamp"]
    gc.collect()
    torch.cuda.empty_cache()
    for run in SERVE_RUNS:
        serve_one(*run, dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# [inpod]: the FedQCS train step on the reference's (2, 2, 2) mesh
# (launch/mesh.py, models/sharding.py, runtime/steps.py's in-pod program):
# one process per device, eight gloo ranks sharing the one card
# (launch/spawn.py; NCCL refuses two ranks on one card, so the collectives
# run on host copies).  [train]'s batch, FedQCS point and optimizer:
#   * Qwen3-0.6B at full width, depth cut to INPOD_LAYERS (auto) and
#     INPOD_SHARDED_LAYERS (auto_sharded, whose rank rows hold the MLP's
#     wi/wg whole: the reference's rules replicate them): eight ranks at 28
#     layers pass the card's 80 GB (auto_sharded ran out of memory at 14
#     layers, with 6.1 GiB a rank allocated); 14 and 8 until the SSM and
#     hybrid families came, then 4 and 2 (the script's time limit);
#   * the other families' models (inpod_family_runs): Mamba2-1.3B at
#     INPOD_SSM_LAYERS of 48 layers (12 until the script passed its 1200 s
#     limit with the MoE, VLM and audio families beside it) and Zamba2-2.7B at 6 of 54 (one group and its shared
#     block) at full width, Whisper-base at full width and depth (6 + 6
#     layers; 1,500 frames beside the 64 text tokens); the MoE family
#     (Qwen3-MoE-235B-A22B; DeepSeek-V3 with MLA and MTP) and the VLM
#     (Qwen2-VL-7B) at their smoke configs (fp32), which check the program
#     and measure nothing: at full width eight ranks of one card cannot
#     hold them (``--inpod-wide`` tries Qwen2-VL-7B at one layer).
# Eight ranks time-slicing one card say that the program runs on the
# device, not how fast it would run on eight.
INPOD_MESH, INPOD_LAYERS, INPOD_SHARDED_LAYERS, INPOD_SSM_LAYERS = (2, 2, 2), 4, 2, 4
INPOD_LOSS_TOL = 1e-3  # relative: bf16 products and sums in another order
# the world's bf16 gradient rows against one process's, in units of one
# process's own bf16 rows' NMSE to its fp32 rows (two independent bf16
# errors: 2 expected)
INPOD_BF16_FLOORS = 4.0
# an fp32 model's: the same products summed in another order
INPOD_FP32_ROWS = 1e-8
INPOD_ENCODE = f"bqcs_encode_fused[N={TRAIN_N}, a rank's rows]"
INPOD_GAMP = f"gamp_step[N={TRAIN_N}, a rank's rows]"
INPOD_QGAMP = f"qgamp_step[N={TRAIN_N}, a rank's rows]"
INPOD_FRAMES = 1500  # Whisper's 30 s window ([serve] (f)'s)
INPOD_WIDE = ("qwen2-vl-7b", 1)  # --inpod-wide's model: (arch, layers) at full width
# [inpod]'s serve runs (the in-pod make_prefill_step / make_decode_step):
# Qwen3-0.6B at full width and depth, bf16, seed 0's weights: a prompt of
# B x S (two rows a rank over (pod, data)), a cache of S + ROOM slots
# (1056 a model rank), STEPS greedy decode steps teacher-forced with one
# process's tokens; then the smoke configs, fp32: B x S_SMOKE into
# SMAX_SMOKE slots, STEPS_SMOKE steps from slot S_SMOKE (model rank 0's
# slots, then rank 1's first and later ones)
INPOD_SERVE_ARCH, INPOD_SERVE_B, INPOD_SERVE_S, INPOD_SERVE_ROOM, INPOD_SERVE_STEPS = (
    "qwen3-0.6b", 8, 2048, 64, 32)
INPOD_SERVE_SMOKE = ("qwen3-0.6b", "qwen3-moe-235b-a22b", "deepseek-v3-671b", "qwen2-vl-7b")
INPOD_SERVE_S_SMOKE, INPOD_SERVE_SMAX_SMOKE, INPOD_SERVE_STEPS_SMOKE = 6, 16, 5
INPOD_SERVE_FP32_TOL = 1e-4  # max abs: an fp32 model's products summed in another order


def inpod_family_runs():
    """[inpod]'s runs of the other families: (full width, smoke width),
    each a tuple of (label, config, steps), a step (recon mode, Adam
    moment dtype).  A full-width run's kernels are timed at its rank rows
    and carry the JSON's entries; a smoke-width run checks the program."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config, smoke_config

    def cut(arch, layers):
        return dc.replace(get_config(arch), n_layers=layers)

    ae = (("ae", "float32"),)
    full = (("Mamba2-1.3B", cut("mamba2-1.3b", INPOD_SSM_LAYERS), ae + (("ea", "int8"),)),
            ("Zamba2-2.7B", cut("zamba2-2.7b", 6), ae),
            ("Whisper-base", cut("whisper-base", 6), ae + (("ea", "float32"),)))
    smoke = tuple((label, smoke_config(arch), ae) for label, arch in (
        ("Qwen3-MoE smoke", "qwen3-moe-235b-a22b"), ("DeepSeek-V3 smoke", "deepseek-v3-671b"),
        ("Qwen2-VL smoke", "qwen2-vl-7b")))
    return full, smoke


def inpod_label(name: str, mode: str, state_dtype: str) -> str:
    """A family run's label: the model, ``auto``, the mode, int8 moments."""
    return f"{name} auto {mode.upper()}" + (" int8" if state_dtype == "int8" else "")


def inpod_kernel(kind: str, model: str = "") -> str:
    """The JSON name of ``kind`` (encode, gamp, qgamp) at a rank's rows of
    ``model`` ("": Qwen3-0.6B's rows, the names without a model)."""
    if not model:
        return {"encode": INPOD_ENCODE, "gamp": INPOD_GAMP, "qgamp": INPOD_QGAMP}[kind]
    base = {"encode": "bqcs_encode_fused", "gamp": "gamp_step", "qgamp": "qgamp_step"}[kind]
    return f"{base}[N={TRAIN_N}, a {model} rank's rows]"


def inpod_batch(cfg, dev):
    """[train]'s batch (16 x 64 token ids, seed 0's first) for ``cfg`` on
    ``dev``, with :func:`serve_prompt`'s inputs of the audio and VLM
    families: Whisper's INPOD_FRAMES frame embeddings beside its 64 text
    tokens; the VLM's first quarter of the sequence as patch embeddings,
    with their M-RoPE streams, before 48 text tokens."""
    from repro_torch.data.synthetic import TokenDataset

    batch = TokenDataset(cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0).get_batch(
        0, device=dev)
    if cfg.family == "audio":
        batch.update(serve_prompt(cfg, TRAIN_BATCH, 0, INPOD_FRAMES, dev))
    if cfg.family == "vlm":
        sv = TRAIN_SEQ // 4
        batch = {k: v[:, sv:] for k, v in batch.items()}
        extra = serve_prompt(cfg, TRAIN_BATCH, sv, TRAIN_SEQ - sv, dev)
        batch.update(patches=extra["patches"], positions=extra["positions"])
    return batch


def inpod_int8_check(state, cfg, opt, fed, mesh, rank, dev):
    """Adam on this rank's shards of ``state`` (its int8 moments after a
    step) against Adam on the whole leaves, leaf by leaf on rank 0, the
    same gradient (the parameters, a stand-in) and clip: every rank's
    QLeafs and parameters gathered must be the whole update's, bit for bit
    (a gathered leaf is its ranks' shards side by side).  Returns (leaves
    checked, the paths that differ) on rank 0."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.models.sharding import gather_leaf
    from repro_torch.optim import adam
    from repro_torch.runtime import steps

    _, specs = steps.state_specs(cfg, opt, fed, mesh)
    one = torch.ones((), device=dev)
    step = int(state["step"])
    got_p, got_o = adam.update(opt, state["params"], state["opt"], state["params"], step,
                               norm_sq=lambda _: one, shards=steps.opt_shards(cfg, mesh))
    checked, differ = 0, []
    for path, _ in tree_util.leaves(state["params"]):
        pspec, ospec = tree_util.get(specs["params"], path), tree_util.get(specs["opt"]["m"], path)
        whole = lambda tree, spec: gather_leaf(tree_util.get(tree, path), spec, mesh)  # noqa
        p, m, v = (whole(state["params"], pspec), whole(state["opt"]["m"], ospec),
                   whole(state["opt"]["v"], ospec))
        mine = (whole(got_p, pspec), whole(got_o["m"], ospec), whole(got_o["v"], ospec))
        if rank == 0:
            wp, wo = adam.update(opt, {"x": p}, {"m": {"x": m}, "v": {"x": v}}, {"x": p}, step,
                                 norm_sq=lambda _: one)
            want = (wp["x"], wo["m"]["x"], wo["v"]["x"])
            checked += 1
            if not (torch.equal(want[0], mine[0]) and all(
                    torch.equal(a, b) for w, g in zip(want[1:], mine[1:]) for a, b in zip(w, g))):
                differ.append(path)
            del wp, wo, want
        del p, m, v, mine
        torch.cuda.empty_cache()
    return checked, differ


def inpod_rank(rank, world, dev, spec):
    """One rank of [inpod]'s world: ``spec`` names the runs ((label, config,
    impl, mode, state dtype)) and the one-process aggregates' files.
    Returns, per run: loss, rank 0's step wall (after a barrier, ending in a
    device sync), launches, peak device memory, and the sums behind the
    NMSEs; the int8 run, its shards' check."""
    import dataclasses as dc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import collectives, steps

    mesh = make_debug_mesh(*INPOD_MESH)
    c = mesh.coords()
    captured = {}
    pod_allreduce = steps.fedqcs_pod_allreduce

    def capture(*args, **kw):
        ghat, res = pod_allreduce(*args, **kw)
        captured["ghat"], captured["blocks"] = ghat, args[0]
        return ghat, res

    def one_rank_at_a_time(fn):  # for the plain versions' temporaries
        def run(*args, **kw):
            out = None
            for r in range(world):
                if r == rank:
                    out = fn(*args, **kw)
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                dist.barrier()
            return out
        return run

    def device_used():  # every process's memory on the card
        free, total = torch.cuda.mem_get_info(dev)
        return total - free

    reconstruct = collectives._reconstruct
    steps.fedqcs_pod_allreduce = capture
    dist.barrier()
    out = {"coords": c, "card_used_after_init": device_used()}
    for label, cfg, impl, mode, state_dtype in spec["runs"]:
        batch = inpod_batch(cfg, dev)
        fed = train_fed(recon_mode=mode)
        opt = dc.replace(train_opt(), state_dtype=state_dtype)
        state = steps.init_train_state(cfg, opt, fed, 0, mesh=mesh, impl=impl, device=dev)
        fn = steps.make_train_step(cfg, opt, fed, mesh, impl=impl, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        dist.barrier()
        t0 = time.perf_counter()
        new, m = fn(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        rec = {"loss": loss, "wall_ms": wall, "launches": read_counts(),
               "peak": torch.cuda.max_memory_allocated(dev),
               "reserved": torch.cuda.max_memory_reserved(dev), "card_used": device_used(),
               "rows": int(state["residual"].shape[1])}
        ghat, blocks = captured.pop("ghat"), captured.pop("blocks")
        rec["ghat_sum"] = float(ghat.double().sum())
        if state_dtype == "int8":
            del state
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            rec["int8"] = inpod_int8_check(new, cfg, opt, fed, mesh, rank, dev)
            rec["int8_s"] = time.perf_counter() - t1
        del new
        if label in spec["reference"]:  # the one-process step's rows
            files = spec["reference"][label]
            lo, n_rows = (c["data"] * INPOD_MESH[2] + c["model"]) * ghat.shape[0], ghat.shape[0]

            def rows(path, *lead):
                arr = np.load(path, mmap_mode="r")[lead + (slice(lo, lo + n_rows),)]
                return torch.from_numpy(np.array(arr)).to(dev)

            def sums(got, want):
                return float(torch.sum((got - want) ** 2)), float(torch.sum(want * want))

            ref_blocks, ref_ghat = rows(files["blocks"], c["pod"]), rows(files["ghat"])
            rec["blocks"] = sums(blocks, ref_blocks)  # the pod's gradient on these rows
            rec["step"] = sums(ghat, ref_ghat)  # this step's aggregate
            # the step's exchange and decode of the one-process step's rows
            wire = "gather_codes" if mode == "ea" else "psum_dequant"
            codec = steps.BQCSCodec(dc.replace(fed, wire_mode=wire), device=dev)
            same, _ = pod_allreduce(ref_blocks, torch.zeros_like(ref_blocks), codec,
                                    group=mesh.group("pod"),
                                    participating=torch.ones((), device=dev))
            rec["err"], rec["energy"] = sums(same, ref_ghat)
            del ref_blocks, ref_ghat, same, codec
        if label in spec["plain"]:  # the same program with the plain versions
            from repro_torch.kernels import ops

            collectives._reconstruct = one_rank_at_a_time(reconstruct)
            try:
                with plain_kernels():
                    ops._encode = one_rank_at_a_time(ops._encode)
                    new, _ = fn(state, batch)
            finally:
                collectives._reconstruct = reconstruct
            plain = captured.pop("ghat")
            rec["err"] = float(torch.sum((ghat - plain) ** 2))
            rec["energy"] = float(torch.sum(plain * plain))
            del new, plain
        out[label] = rec
        state = None
        del fn, ghat, blocks, batch
        torch.cuda.empty_cache()
    steps.fedqcs_pod_allreduce = pod_allreduce
    out["serve"] = inpod_serve_rank(rank, mesh, dev, spec["serve"])
    return out


def inpod_serve_prompt(cfg, b: int, s: int, dev) -> dict:
    """[inpod]'s serve prompt of ``s`` positions (:func:`serve_prompt`,
    the same draw in every process; the VLM: 2 patch embeddings first)."""
    sv = 2 if cfg.family == "vlm" else 0
    return serve_prompt(cfg, b, sv, s - sv, dev)


def inpod_serve_run(cfg, params, prompt, smax, mesh, dev, tokens=None, n=0, timed=False):
    """The serve steps of ``cfg`` on ``mesh`` (None: one process): the
    prefill into ``smax`` slots, then one donated decode step a row of
    ``tokens`` (teacher-forced) at the positions after the prompt -- or,
    with ``tokens`` None, ``n`` greedy steps (one process).  Returns (the
    greedy tokens -- of the prefill, then of each step (n + 1, B, 1);
    teacher-forced, of each step (steps, B, 1), in-pod the rank's rows
    --, prefill logits, each step's
    logits, the cache after the last step, the prefill's wall ms, each
    step's ms); ``timed``: each call between a barrier (in-pod) and a
    device sync."""
    import torch
    import torch.distributed as dist

    from repro_torch.models.sharding import greedy_tokens
    from repro_torch.runtime import steps

    def sync():
        torch.cuda.synchronize(dev)
        if timed and mesh is not None:
            dist.barrier()

    prefill = steps.make_prefill_step(cfg, mesh)
    decode = steps.make_decode_step(cfg, mesh, donate=True)
    s = prompt["tokens"].shape[1] + (prompt["patches"].shape[1] if "patches" in prompt else 0)
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt, smax)
    torch.cuda.synchronize(dev)
    pre_ms = 1e3 * (time.perf_counter() - t0)
    toks = [greedy_tokens(logits[:, -1])[:, None]] if tokens is None else []
    outs, ms = [], []
    for t in range(n if tokens is None else len(tokens)):
        sync()
        t0 = time.perf_counter()
        nxt, lo, cache = decode(params, cache, toks[-1] if tokens is None else tokens[t], s + t)
        torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        outs.append(lo)
        toks.append(nxt)
    return torch.stack(toks), logits, torch.stack(outs), cache, pre_ms, ms


def inpod_serve_rank(rank, mesh, dev, spec):
    """[inpod]'s serve runs on this rank (see INPOD_SERVE_*): the full-width
    model, then each smoke config, from the files of one process's runs:
    each run's sums behind the NMSEs (the rank's logits and cache shard
    against its shards of one process's), its next tokens, rank 0's walls,
    the rank's peak."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import model as model_api
    from repro_torch.models.sharding import local_shard, shard_cache
    from repro_torch.optim.adam import OptConfig
    from repro_torch.runtime import steps

    c = mesh.coords()

    def shards(cfg, params):
        _, specs = steps.state_specs(cfg, OptConfig(), None, mesh)
        return steps.shard_state(params, specs["params"], mesh)

    def compare(cfg, got, files):
        """(err, energy, max abs) of the rank's outputs against its shards
        of one process's: prefill logits, decode logits, final cache."""
        ref = torch.load(files, mmap=True, weights_only=True)
        logits, dec, cache = got
        pre, dspec = (steps.serve_specs(cfg, mesh, kind)["logits"] for kind in ("prefill",
                                                                                "decode"))
        out = {}
        pairs = {"prefill": (logits, local_shard(ref["prefill"], pre, mesh.shape, c)),
                 "decode": (dec, local_shard(ref["decode"], (None,) + dspec, mesh.shape, c)),
                 "cache": (torch.cat([v.reshape(-1) for v in cache.values()]),
                           torch.cat([v.reshape(-1) for v in shard_cache(
                               {k: ref[k] for k in cache}, mesh).values()]))}
        for key, (g, w) in pairs.items():
            g, w = g.float(), w.to(dev).float()
            out[key] = (float(torch.sum((g - w) ** 2)), float(torch.sum(w * w)),
                        float(torch.max(torch.abs(g - w))))
        return out

    torch.cuda.empty_cache()
    res = {}
    t0 = time.perf_counter()
    cfg = get_config(INPOD_SERVE_ARCH)
    whole = torch.load(spec["params"], mmap=True, weights_only=True)  # one process's
    params = tree_util.tree_map(lambda v: v.to(dev), shards(cfg, whole))
    del whole
    prompt = inpod_serve_prompt(cfg, INPOD_SERVE_B, INPOD_SERVE_S, dev)
    tokens = torch.load(spec["tokens"], weights_only=True).to(dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    got = inpod_serve_run(cfg, params, prompt, INPOD_SERVE_S + INPOD_SERVE_ROOM, mesh, dev,
                          tokens=tokens[:-1], timed=True)
    free, total = torch.cuda.mem_get_info(dev)
    rec = {"peak": torch.cuda.max_memory_allocated(dev), "card_used": total - free,
           "pre_ms": got[4], "ms": got[5], "next": got[0].cpu(),
           "shape": tuple(got[3]["k"].shape)}
    del params, prompt
    t2 = time.perf_counter()
    rec.update(compare(cfg, got[1:4], spec["full"]))
    rec["seconds"] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
    res["full"] = rec
    del got
    torch.cuda.empty_cache()
    for arch in INPOD_SERVE_SMOKE:
        cfg = smoke_config(arch)
        params = shards(cfg, model_api.init_params(cfg, seed=0, device=dev))
        prompt = inpod_serve_prompt(cfg, INPOD_SERVE_B, INPOD_SERVE_S_SMOKE, dev)
        tokens = torch.load(spec[arch + " tokens"], weights_only=True).to(dev)
        got = inpod_serve_run(cfg, params, prompt, INPOD_SERVE_SMAX_SMOKE, mesh, dev,
                              tokens=tokens[:-1])
        res[arch] = dict(compare(cfg, got[1:4], spec[arch]), next=got[0].cpu())
        del params, got
    dist.barrier()
    return res


def inpod_serve_report(ranks, serve, smi) -> None:
    """[inpod]'s serve checks and lines: the world's logits and cache shards
    against one process's (the full-width model: NMSE within its floors;
    the smoke configs: max abs within INPOD_SERVE_FP32_TOL), its greedy
    tokens (every ``model`` and pod rank alike; a token that differs from
    one process's must be a near tie there), rank 0's walls, each rank's
    peak and the card's memory in use."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(dict(zip(("pod", "data", "model"), INPOD_MESH)))
    data = INPOD_MESH[1]

    def world_tokens(key):
        """The world's next tokens (steps, B): each data index's rows, the
        same on every rank that shares it."""
        rows = {}
        for r, out in enumerate(ranks):
            d = mesh.coords(r)["data"]
            got = out["serve"][key]["next"][..., 0]
            check(d not in rows or torch.equal(rows[d], got),
                  f"[inpod] serve {key}: rank {r}'s tokens differ from another rank of its rows")
            rows[d] = got
        return torch.cat([rows[d] for d in range(data)], dim=1)

    def agreement(key, want, logits, tol):
        """The share of the world's tokens equal to one process's; a token
        that differs must be a near tie in one process's logits: its
        margin over the world's pick within ``tol`` (per step and row)."""
        got = world_tokens(key)
        want = want[1:, :, 0]
        for t, b in torch.nonzero(got != want).tolist():
            margin = float(logits[t, b, want[t, b]] - logits[t, b, got[t, b]])
            limit = float(tol[t, b]) if torch.is_tensor(tol) else tol
            check(margin <= limit, f"[inpod] serve {key}: step {t} row {b} took token "
                  f"{int(got[t, b])} where one process took {int(want[t, b])}, margin "
                  f"{margin:.4g} > {limit:.4g}: not a near tie")
        return float((got == want).float().mean())

    def sums(key, part):
        err = sum(out["serve"][key][part][0] for out in ranks)
        energy = sum(out["serve"][key][part][1] for out in ranks)
        return err / max(energy, 1e-30), max(out["serve"][key][part][2] for out in ranks)

    recs = [out["serve"]["full"] for out in ranks]
    floors = serve["floors"]
    rate = agreement("full", serve["tokens"], serve["decode"], serve["tie_tol"])
    parts = {part: sums("full", part) for part in ("prefill", "decode", "cache")}
    for part, (e, _) in parts.items():
        check(e <= floors[part], f"[inpod] serve {INPOD_SERVE_ARCH}: {part} NMSE {e:.4g} "
              f"against one process, past its floor {floors[part]:.4g}")
    one_pre, one_ms = serve["one_ms"]
    peaks = [rec["peak"] / 2**30 for rec in recs]
    init_s, run_s, compare_s = recs[0]["seconds"]
    ms = recs[0]["ms"]
    print(f"[inpod] serve {INPOD_SERVE_ARCH} (full width, {INPOD_SERVE_B} x {INPOD_SERVE_S} "
          f"prompt, bf16, seed 0's weights; cache shard {recs[0]['shape']} a rank of "
          f"{INPOD_SERVE_S + INPOD_SERVE_ROOM} slots; {INPOD_SERVE_STEPS} donated decode steps "
          f"teacher-forced with one process's tokens) on the (2, 2, 2) world: prefill wall "
          f"{recs[0]['pre_ms']:.1f} ms (rank 0; one process {one_pre:.1f}); decode median "
          f"{float(np.median(ms)):.1f} ms a token (min {min(ms):.1f}, max {max(ms):.1f}; one "
          f"process {float(np.median(one_ms)):.3f}); max_memory_allocated a rank GiB "
          f"{[round(v, 3) for v in peaks]}, sum {sum(peaks):.3f}; the card in use "
          f"{max(rec['card_used'] for rec in recs) / 2**30:.3f} GiB; rank 0's seconds: "
          f"shards {init_s:.1f}, prefill and decode {run_s:.1f}, checks {compare_s:.1f} | {smi}")
    print(f"[inpod] serve {INPOD_SERVE_ARCH} against one process: NMSE "
          + ", ".join(f"{part} {e:.4g} (floor {floors[part]:.4g}, max abs {m:.4g})"
                      for part, (e, m) in parts.items())
          + f" (floors: {INPOD_BF16_FLOORS:g} x one process's own bf16-to-fp32 NMSE); greedy "
          f"tokens equal to one process's: {rate:.4f} of {INPOD_SERVE_STEPS} x "
          f"{INPOD_SERVE_B} (a differing one a near tie)")
    for arch in INPOD_SERVE_SMOKE:
        rate = agreement(arch, serve[arch]["tokens"], serve[arch]["decode"],
                         INPOD_SERVE_FP32_TOL)
        worst = {part: sums(arch, part)[1] for part in ("prefill", "decode", "cache")}
        check(max(worst.values()) <= INPOD_SERVE_FP32_TOL,
              f"[inpod] serve {arch} smoke: max abs {worst} against one process")
        print(f"[inpod] serve {arch} smoke (fp32, {INPOD_SERVE_B} x {INPOD_SERVE_S_SMOKE} into "
              f"{INPOD_SERVE_SMAX_SMOKE} slots, {INPOD_SERVE_STEPS_SMOKE} steps from slot "
              f"{INPOD_SERVE_S_SMOKE}: model rank 0's, then rank 1's): max abs against one "
              f"process " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
              + f" (<= {INPOD_SERVE_FP32_TOL:g}); greedy tokens equal: {rate:.4f}")


def inpod_serve_references(dev, out_dir) -> dict:
    """One process's serve runs on the card, written to ``out_dir`` for the
    ranks (their prompts are the same draws): the full-width model in
    bf16 -- its greedy tokens, prefill and decode logits and final cache
    -- and, teacher-forced with the same tokens, its fp32 cast, whose gaps
    make the world's floors (INPOD_BF16_FLOORS x one process's own
    bf16-to-fp32 NMSE, per output); each smoke config in fp32.  Returns
    the files, the floors, and the logits the tie rule reads."""
    import dataclasses as dc

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.models import model as model_api

    out = {"files": {}}
    cfg = get_config(INPOD_SERVE_ARCH)
    smax = INPOD_SERVE_S + INPOD_SERVE_ROOM
    params = model_api.init_params(cfg, seed=0, device=dev)
    prompt = inpod_serve_prompt(cfg, INPOD_SERVE_B, INPOD_SERVE_S, dev)
    toks, logits, dec, cache, pre_ms, ms = inpod_serve_run(cfg, params, prompt, smax, None,
                                                           dev, n=INPOD_SERVE_STEPS)
    files = out["files"]
    files["params"] = str(out_dir / "serve_params.pt")  # the ranks cut their shards from it
    torch.save(tree_util.tree_map(lambda p: p.cpu(), params), files["params"])
    files["tokens"] = str(out_dir / "serve_tokens.pt")
    torch.save(toks.cpu(), files["tokens"])
    files["full"] = str(out_dir / "serve_full.pt")
    torch.save({"prefill": logits.cpu(), "decode": dec.cpu(),
                **{k: v.cpu() for k, v in cache.items()}}, files["full"])
    del cache
    torch.cuda.empty_cache()
    cfg32 = dc.replace(cfg, dtype="float32")
    params32 = tree_util.tree_map(lambda p: p.float(), params)
    del params
    _, logits32, dec32, cache32, _, _ = inpod_serve_run(cfg32, params32, prompt, smax, None,
                                                        dev, tokens=toks[:-1])
    del params32
    bf = torch.load(files["full"], mmap=True, weights_only=True)
    cache_bf = torch.cat([bf[k].reshape(-1) for k in cache32])
    out["floors"] = {
        "prefill": INPOD_BF16_FLOORS * nmse(logits.float(), logits32),
        "decode": INPOD_BF16_FLOORS * nmse(dec.float(), dec32),
        "cache": INPOD_BF16_FLOORS * nmse(cache_bf.to(dev).float(), torch.cat(
            [v.reshape(-1) for v in cache32.values()]))}
    # the tie rule: a step's row whose top two differ by less than the
    # floor's scale there (INPOD_BF16_FLOORS x one process's largest
    # bf16-to-fp32 gap on the row) may go either way
    out["decode"] = dec[:, :, -1].float().cpu()
    out["tie_tol"] = (INPOD_BF16_FLOORS * torch.amax(torch.abs(dec.float() - dec32),
                                                     dim=-1)[:, :, 0]).cpu()
    out["tokens"] = toks.cpu()
    out["one_ms"] = (pre_ms, ms)
    del cache32, logits32, dec32, cache_bf, bf, dec, logits
    torch.cuda.empty_cache()
    for arch in INPOD_SERVE_SMOKE:
        cfg = smoke_config(arch)
        params = model_api.init_params(cfg, seed=0, device=dev)
        prompt = inpod_serve_prompt(cfg, INPOD_SERVE_B, INPOD_SERVE_S_SMOKE, dev)
        toks, logits, dec, cache, _, _ = inpod_serve_run(
            cfg, params, prompt, INPOD_SERVE_SMAX_SMOKE, None, dev, n=INPOD_SERVE_STEPS_SMOKE)
        files[arch + " tokens"] = str(out_dir / f"serve_tokens_{arch}.pt")
        files[arch] = str(out_dir / f"serve_{arch}.pt")
        torch.save(toks.cpu(), files[arch + " tokens"])
        torch.save({"prefill": logits.cpu(), "decode": dec.cpu(),
                    **{k: v.cpu() for k, v in cache.items()}}, files[arch])
        out[arch] = {"decode": dec[:, :, -1].float().cpu(), "tokens": toks.cpu()}
        del params, cache, logits, dec
    torch.cuda.empty_cache()
    return out


def phase_inpod(dev, smi):
    """[inpod] (see INPOD_*): first, alone on the card, [time] of the
    encoder and both step kernels at a rank's rows of Qwen3-0.6B's
    full-depth mesh (rank (0, 0, 0)'s: the first quarter of pod 0's grid of
    a real step); then the one-process references: the ``impl="auto"``
    two-pod step's losses and decoded aggregates (AE, EA) at INPOD_LAYERS
    layers from seed 0's parameters and batch 0, written to
    ``build/inpod/`` for the ranks, and the loss at INPOD_SHARDED_LAYERS
    layers; the same for :func:`inpod_family_runs`' models and steps,
    with [time] of the kernels at a full-width model's rank (0, 0, 0)'s
    rows.  Then the eight ranks: one ``auto_sharded`` AE step (against the
    same program with the plain versions, their encode and decode one rank
    at a time), one ``auto`` AE and one ``auto`` EA step (against the
    one-process aggregate: the same global blocking), and each family
    run's steps (an int8 one's QLeafs held to the whole leaves'
    quantization, bit for bit).  Each step: rank 0's wall, each rank's
    launches (1 encoder, 15 step kernel) and peak memory, the card's
    memory in use, the loss against the one-process loss.  Returns
    (launches by KERNELS name, max abs errors, [time] records)."""
    import dataclasses as dc
    import gc
    import os

    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.spawn import run_world
    from repro_torch.models import model as model_api
    from repro_torch.runtime import steps
    from repro_torch.runtime.collectives import fedqcs_vmapped_allreduce

    t_phase = time.perf_counter()
    full = get_config(TRAIN_ARCH)
    pods, data, model = INPOD_MESH

    def pod_grid(cfg, fp32=False):
        """The one-process step's loss and pod grids of ``cfg`` (``fp32``:
        seed 0's bf16 weights cast up, computed in fp32)."""
        batch = inpod_batch(cfg, dev)
        params = model_api.init_params(cfg, seed=0, device=dev)
        if fp32:
            cfg = dc.replace(cfg, dtype="float32")
            params = tree_util.tree_map(lambda p: p.float(), params)
        losses, blocks, _ = steps.pod_blocks(params, batch, cfg, pods, TRAIN_N, dev)
        return float(torch.stack(losses).mean()), blocks

    timer = GpuTimer()
    times, errs = {}, {}

    def time_rank_rows(blocks, model_name, kinds):
        """[time] of ``kinds`` at rank (0, 0, 0)'s rows of ``blocks``."""
        rows = blocks.shape[1] // (data * model)
        b0 = blocks[0, :rows].clone()
        fed = train_fed(recon_mode="ea")
        codec_a = steps.BQCSCodec(fed, device=dev).a
        r0 = torch.zeros_like(b0)
        grid = f"{model_name or 'Qwen3-0.6B'} rank (0, 0, 0)'s rows"
        rec, words, alpha = train_encode_time(dev, fed, b0, r0, codec_a, timer, "[inpod]",
                                              grid=grid)
        got = {inpod_kernel("encode", model_name): rec}
        del b0, r0
        torch.cuda.empty_cache()
        if "qgamp" in kinds:
            st = train_step_times(dev, fed, words, alpha, codec_a, timer, f"a {grid}")
            got[inpod_kernel("gamp", model_name)] = st[f"gamp_step[N={TRAIN_N}]"]
            got[inpod_kernel("qgamp", model_name)] = st[f"qgamp_step[N={TRAIN_N}]"]
        else:
            got[inpod_kernel("gamp", model_name)] = gamp_step_time(
                dev, fed, words[None], alpha[None], torch.ones((1,), device=dev), codec_a,
                timer, f"[inpod] {grid}")
        times.update(got)
        for name, r in got.items():
            errs[KERNELS[name][2]] = r["err"]
        print_train_times(got)
        torch.cuda.empty_cache()

    # [time] at a rank's rows of the full-depth mesh, alone on the card
    blocks = pod_grid(full)[1]
    time_rank_rows(blocks, "", ("encode", "gamp", "qgamp"))
    del blocks
    torch.cuda.empty_cache()
    # the one-process references at the world's depths
    out_dir = ROOT / "build" / "inpod"
    out_dir.mkdir(parents=True, exist_ok=True)
    part = torch.ones((pods,), device=dev)
    want_loss, limits, files = {}, {}, {}

    def references(tag, cfg, labels):
        """``labels``' one-process loss, limit on the world's gradient rows
        and aggregate files, from ``cfg``'s pod grids; returns the grids.
        The limit: INPOD_BF16_FLOORS x one process's own bf16 rows' NMSE to
        its fp32 rows (a bf16 model), INPOD_FP32_ROWS (an fp32 one)."""
        loss, blocks = pod_grid(cfg)
        if cfg.dtype == "float32":
            limit = INPOD_FP32_ROWS
        else:
            limit = INPOD_BF16_FLOORS * nmse(blocks, pod_grid(cfg, fp32=True)[1])
        torch.cuda.empty_cache()
        np.save(out_dir / f"blocks_{tag}.npy", blocks.cpu().numpy())
        for label, mode in labels:
            codec = steps.BQCSCodec(train_fed(recon_mode=mode), device=dev)
            ghat = fedqcs_vmapped_allreduce(blocks, torch.zeros_like(blocks), codec, part)[0]
            files[label] = {"blocks": str(out_dir / f"blocks_{tag}.npy"),
                            "ghat": str(out_dir / f"ghat_{tag}_{mode}.npy")}
            np.save(files[label]["ghat"], ghat.cpu().numpy())
            want_loss[label], limits[label] = loss, limit
            del ghat
            torch.cuda.empty_cache()
        return blocks

    cut = dc.replace(full, n_layers=INPOD_SHARDED_LAYERS)
    qwen = dc.replace(full, n_layers=INPOD_LAYERS)
    references("qwen", qwen, (("auto AE", "ae"), ("auto EA", "ea")))
    torch.cuda.empty_cache()
    runs = [("auto_sharded AE", cut, "auto_sharded", "ae", "float32"),
            ("auto AE", qwen, "auto", "ae", "float32"),
            ("auto EA", qwen, "auto", "ea", "float32")]
    # each run's model in the JSON's entries (None: a smoke-width run, in none)
    models = {"auto_sharded AE": "", "auto AE": "", "auto EA": ""}
    full_width, smoke_width = inpod_family_runs()
    for timed, group in ((True, full_width), (False, smoke_width)):
        for name, cfg, modes in group:
            labels = [(inpod_label(name, mode, dt), mode) for mode, dt in modes]
            runs += [(label, cfg, "auto", mode, dt)
                     for (label, _), (mode, dt) in zip(labels, modes)]
            blocks = references(name, cfg, labels)
            if timed:
                time_rank_rows(blocks, name, ("encode", "gamp") + (
                    ("qgamp",) if any(mode == "ea" for mode, _ in modes) else ()))
            models.update((label, name if timed else None) for label, _ in labels)
            del blocks
            torch.cuda.empty_cache()
    params = model_api.init_params(cut, seed=0, device=dev)
    batch = inpod_batch(full, dev)
    with torch.no_grad():
        want_loss["auto_sharded AE"] = float(torch.stack([
            model_api.train_loss(params, steps._pod_batch(batch, pods, p), cut)
            for p in range(pods)]).mean())
    del params, batch
    serve = inpod_serve_references(dev, out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    held = torch.cuda.memory_reserved(dev) / 2**30
    print(f"[inpod] before the world: this process holds {held:.3f} GiB reserved; the card "
          f"has {(total - free) / 2**30:.3f} of {total / 2**30:.3f} GiB in use")
    t_ref = time.perf_counter() - t_phase
    # the eight ranks
    world = pods * data * model
    t0 = time.perf_counter()
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # the ranks' allocators
    try:
        ranks = run_world(inpod_rank, world, args=({"runs": runs, "reference": files,
                                                    "plain": ("auto_sharded AE",),
                                                    "serve": serve["files"]},),
                          device="cuda")
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    t_world = time.perf_counter() - t0
    print(f"[inpod] the card in use after the ranks' start: "
          f"{ranks[0]['card_used_after_init'] / 2**30:.3f} GiB (eight contexts and this "
          f"process)")
    for f in {f for pair in files.values() for f in pair.values()} | set(
            serve["files"].values()):
        Path(f).unlink()
    inpod_serve_report(ranks, serve, smi)
    launches = {name: 0 for name in times}
    for label, cfg, impl, mode, state_dtype in runs:
        recs = [r[label] for r in ranks]
        step_kernel = "qgamp" if mode == "ea" else "gamp"
        want = dict(encode=1, gamp=0, qgamp=0, topk=0, staged=0)
        want[step_kernel] = TRAIN_ITERS
        for r, rec in enumerate(recs):
            check(rec["launches"] == want,
                  f"[inpod] {label} rank {r}: launches {rec['launches']}, want {want}")
        if models[label] is not None:
            launches[inpod_kernel("encode", models[label])] += sum(
                rec["launches"]["encode"] for rec in recs)
            launches[inpod_kernel(step_kernel, models[label])] += sum(
                rec["launches"][step_kernel] for rec in recs)
        losses = {rec["loss"] for rec in recs}
        check(len(losses) == 1, f"[inpod] {label}: the ranks' losses differ: {sorted(losses)}")
        loss = recs[0]["loss"]
        gap = abs(loss - want_loss[label])
        check(bool(np.isfinite(loss)) and gap <= INPOD_LOSS_TOL * abs(want_loss[label]),
              f"[inpod] {label}: loss {loss} vs one process {want_loss[label]}")
        half = world // pods
        check(all(recs[r]["ghat_sum"] == recs[r + half]["ghat_sum"] for r in range(half)),
              f"[inpod] {label}: the two pods' decoded rows differ")

        def nmse_of(key):
            err = sum(rec[key][0] if key else rec["err"] for rec in recs)
            energy = sum(rec[key][1] if key else rec["energy"] for rec in recs)
            return err / max(energy, 1e-30)

        e = nmse_of(None)
        sharded = impl == "auto_sharded"
        limit = limits.get(label)
        eb, es = (None, None) if sharded else (nmse_of("blocks"), nmse_of("step"))
        against = ("the same 8-rank program with the plain versions" if sharded else
                   f"one process's aggregate, from one process's rows (the world's own "
                   f"gradient rows: NMSE {eb:.3g} to one process's, <= {limit:.3g}: "
                   + (f"{INPOD_FP32_ROWS:g}, an fp32 model" if cfg.dtype == "float32" else
                      f"{INPOD_BF16_FLOORS:g} x one process's bf16 rows' NMSE to its fp32 "
                      f"rows") + f"; the world's aggregate {es:.3g} to one process's: top-S "
                   f"picks that part at the gradient's rounding)")
        peaks = [rec["peak"] / 2**30 for rec in recs]
        print(f"[inpod] {label} ({cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.dtype}, {state_dtype} moments, "
              f"{recs[0]['rows']:,} block rows a rank): loss "
              f"{loss:.6f} (one process {want_loss[label]:.6f}, gap {gap:.3g} <= "
              f"{INPOD_LOSS_TOL:g} relative); aggregate NMSE {e:.3g} against {against} "
              f"(<= 1e-3); rank 0's step wall {recs[0]['wall_ms']:.1f} ms (8 ranks on one "
              f"card); launches a rank {want}; max_memory_allocated a rank GiB "
              f"{[round(v, 3) for v in peaks]}, sum {sum(peaks):.3f}; max reserved sum "
              f"{sum(rec['reserved'] for rec in recs) / 2**30:.3f} GiB; the card in use after "
              f"the step {max(rec['card_used'] for rec in recs) / 2**30:.3f} GiB")
        check(e <= 1e-3, f"[inpod] {label}: aggregate NMSE {e:.3g} against {against}")
        check(sharded or eb <= limit,
              f"[inpod] {label}: the pod's gradient rows NMSE {eb} against one process, "
              f"past {limit}")
        if state_dtype == "int8":
            checked, differ = recs[0]["int8"]
            n_leaves = len(tree_util.leaves(model_api.init_params(cfg, device="meta")))
            check(checked == n_leaves and not differ,
                  f"[inpod] {label}: {len(differ)} of {checked} leaves' QLeafs or parameters "
                  f"differ from the whole leaves' Adam update: {differ}")
            print(f"[inpod] {label}: every rank's int8 QLeafs (codes and the whole leaf's "
                  f"256-entry block scales) and parameters after one more Adam update on its "
                  f"shards are the shards of the update on the gathered whole leaves, bit for "
                  f"bit ({checked} leaves; {recs[0]['int8_s']:.1f} s)")
    print(f"[inpod] seconds: one-process references and [time] {t_ref:.1f}, the world "
          f"(spawn, init, steps) {t_world:.1f}")
    return launches, errs, times


def inpod_wide_rank(rank, world, dev, cfg, state_dtype):
    """One rank of [inpod-wide]: one ``auto`` AE step of ``cfg`` from seed
    0's state with ``state_dtype`` Adam moments: the loss, rank 0's wall,
    this rank's peak and the card's memory in use.  Out of device memory,
    the rank raises with its peak then and the card's use (the world
    stops)."""
    import dataclasses as dc

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import steps

    mesh = make_debug_mesh(*INPOD_MESH)
    fed, opt = train_fed(recon_mode="ae"), dc.replace(train_opt(), state_dtype=state_dtype)

    def card_used():
        free, total = torch.cuda.mem_get_info(dev)
        return (total - free) / 2**30

    try:
        batch = inpod_batch(cfg, dev)
        state = steps.init_train_state(cfg, opt, fed, 0, mesh=mesh, impl="auto", device=dev)
        fn = steps.make_train_step(cfg, opt, fed, mesh, impl="auto", device=dev)
        torch.cuda.synchronize()
        after_init = torch.cuda.max_memory_allocated(dev) / 2**30
        dist.barrier()
        t0 = time.perf_counter()
        _, m = fn(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as err:
        raise RuntimeError(
            f"INPOD-WIDE rank {rank} ran out of device memory: its peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB allocated, the card "
            f"{card_used():.3f} GiB in use; {str(err).splitlines()[0]}") from None
    return {"loss": loss, "wall_ms": 1e3 * (time.perf_counter() - t0),
            "peak": torch.cuda.max_memory_allocated(dev) / 2**30, "after_init": after_init,
            "card_used": card_used(), "rows": int(state["residual"].shape[1])}


def phase_inpod_wide(dev):
    """[inpod-wide]: INPOD_WIDE's model at full width on the eight ranks of
    [inpod]'s world, one ``auto`` AE step with int8 Adam moments, then
    with fp32 ones: each rank's peak, or the rank that ran out of device
    memory with its peak then.  Stops at the first that does not fit."""
    import dataclasses as dc
    import math

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.spawn import run_world
    from repro_torch.models.sharding import spec_axes
    from repro_torch.runtime import steps

    arch, layers = INPOD_WIDE
    cfg = dc.replace(get_config(arch), n_layers=layers)
    mesh = make_debug_mesh(*INPOD_MESH)  # outside a world: its shape only
    held = sum(leaf.numel() // math.prod(mesh.shape[a] for e in spec for a in spec_axes(e))
               for _, spec, leaf in steps._check_inpod(cfg, None, mesh))
    head = (f"[inpod-wide] {cfg.name} at full width, {layers} of {get_config(arch).n_layers} "
            f"layers, {held:,} parameters held a rank")
    for state_dtype in ("int8", "float32"):
        t0 = time.perf_counter()
        try:
            ranks = run_world(inpod_wide_rank, math.prod(INPOD_MESH), args=(cfg, state_dtype),
                              device="cuda")
        except RuntimeError as err:
            why = [line for line in str(err).splitlines()
                   if line.startswith("RuntimeError: INPOD-WIDE")]
            if not why:
                raise
            print(f"{head}, {state_dtype} moments: does not fit eight ranks on one card: "
                  f"{why[0].split(': ', 1)[1]} ({time.perf_counter() - t0:.1f} s)")
            return
        peaks = [r["peak"] for r in ranks]
        check(len({r["loss"] for r in ranks}) == 1 and math.isfinite(ranks[0]["loss"]),
              f"[inpod-wide] the ranks' losses: {[r['loss'] for r in ranks]}")
        print(f"{head}, {state_dtype} moments: {ranks[0]['rows']:,} block rows a rank; loss "
              f"{ranks[0]['loss']:.6f}; rank 0's step wall {ranks[0]['wall_ms']:.1f} ms; "
              f"max_memory_allocated a rank GiB {[round(v, 3) for v in peaks]} (after init "
              f"{ranks[0]['after_init']:.3f}), sum {sum(peaks):.3f}; the card in use after "
              f"the step {max(r['card_used'] for r in ranks):.3f} GiB "
              f"({time.perf_counter() - t0:.1f} s)")


# JSON name -> (source, the Pallas site it replaces, phase_kernels key)
KERNELS = {
    "bqcs_encode_fused": ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194", "encode"),
    "bqcs_encode_fused[dither]": ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194",
                                  "encode_dither"),
    "bqcs_encode_fused[vq]": ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194", "encode_vq"),
    "block_topk": ("block_topk.cu", "block_topk.py:64", "topk"),
    "bqcs_encode": ("bqcs_encode.cu", "bqcs_encode.py:67", "staged"),
    "qgamp_step": ("qgamp_step.cu", "qgamp_step.py:180", "qgamp"),
    "gamp_step": ("gamp_step.cu", "gamp_step.py:108", "gamp"),
    "gamp_step[300 rows]": ("gamp_step.cu", "gamp_step.py:108", "gamp300"),
    "qgamp_step[64 rows]": ("qgamp_step.cu", "qgamp_step.py:180", "qgamp64"),
    "gamp_step[64 rows]": ("gamp_step.cu", "gamp_step.py:108", "gamp64"),
    "bqcs_encode_fused[10 rows]": ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194",
                                   "encode10"),
    "gamp_step[30 rows]": ("gamp_step.cu", "gamp_step.py:108", "gamp30"),
    "gamp_step[100 rows]": ("gamp_step.cu", "gamp_step.py:108", "gamp100"),
    "qgamp_step[80 rows]": ("qgamp_step.cu", "qgamp_step.py:180", "qgamp80"),
    "bqcs_encode_fused[390 rows]": ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194",
                                    "encode390"),
    "bqcs_encode_fused[30 rows]": ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194",
                                   "encode30"),
    "qgamp_step[390 rows]": ("qgamp_step.cu", "qgamp_step.py:180", "qgamp390"),
    "qgamp_step[30 rows]": ("qgamp_step.cu", "qgamp_step.py:180", "qgamp30"),
    "qgamp_step[104 rows]": ("qgamp_step.cu", "qgamp_step.py:180", "qgamp104"),
    "gamp_step[13 rows]": ("gamp_step.cu", "gamp_step.py:108", "gamp13"),
    f"bqcs_encode_fused[N={TRAIN_N}]": ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194",
                                         "encode255"),
    f"gamp_step[N={TRAIN_N}]": ("gamp_step.cu", "gamp_step.py:108", "gamp255"),
    f"qgamp_step[N={TRAIN_N}]": ("qgamp_step.cu", "qgamp_step.py:180", "qgamp255"),
    COHORT_ENCODE: ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194", "encode_cohort"),
    COHORT_GAMP: ("gamp_step.cu", "gamp_step.py:108", "gamp_cohort"),
    COHORT_SEG_ENCODE: ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194", "encode_segment"),
    INPOD_ENCODE: ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194", "encode_rank"),
    INPOD_GAMP: ("gamp_step.cu", "gamp_step.py:108", "gamp_rank"),
    INPOD_QGAMP: ("qgamp_step.cu", "qgamp_step.py:180", "qgamp_rank"),
    inpod_kernel("encode", "Mamba2-1.3B"): ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194",
                                            "encode_rank_mamba2"),
    inpod_kernel("gamp", "Mamba2-1.3B"): ("gamp_step.cu", "gamp_step.py:108",
                                          "gamp_rank_mamba2"),
    inpod_kernel("qgamp", "Mamba2-1.3B"): ("qgamp_step.cu", "qgamp_step.py:180",
                                           "qgamp_rank_mamba2"),
    inpod_kernel("encode", "Zamba2-2.7B"): ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194",
                                            "encode_rank_zamba2"),
    inpod_kernel("gamp", "Zamba2-2.7B"): ("gamp_step.cu", "gamp_step.py:108",
                                          "gamp_rank_zamba2"),
    inpod_kernel("encode", "Whisper-base"): ("bqcs_encode_fused.cu", "bqcs_encode_fused.py:194",
                                             "encode_rank_whisper"),
    inpod_kernel("gamp", "Whisper-base"): ("gamp_step.cu", "gamp_step.py:108",
                                           "gamp_rank_whisper"),
    inpod_kernel("qgamp", "Whisper-base"): ("qgamp_step.cu", "qgamp_step.py:180",
                                            "qgamp_rank_whisper"),
}


def main_path_launches(per_run: dict, staged: dict) -> dict:
    """The JSON's launch counts per entry, from the runs that drive each:
    the encoder's branches by codebook, gamp_step by decode width (10 AE
    rows, 300 vq EA rows), the staged kernels from the staged path."""
    out = {name: 0 for name in KERNELS}
    branch = {"lloyd_max": "bqcs_encode_fused", "dithered_uniform": "bqcs_encode_fused[dither]",
              "vq": "bqcs_encode_fused[vq]"}
    for (method, codebook, _), counts in per_run.items():
        out[branch[codebook]] += counts["encode"]
        out["qgamp_step"] += counts["qgamp"]
        out["gamp_step" if method == "fedqcs-ae" else "gamp_step[300 rows]"] += counts["gamp"]
    out.update(staged)
    return out


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--levels", help="comma-separated kLevels values: build, check and "
                        "time the top-S bisection at each, after the [kernels] phase, and stop")
    parser.add_argument("--against", type=Path, help="another checkout of the repository: hold "
                        "the kernels both trees share bit for bit and time them in turns, after "
                        "the [kernels] phase, and stop")
    parser.add_argument("--inpod", action="store_true", help="run the build and the [inpod] "
                        "phase alone, and stop")
    parser.add_argument("--inpod-wide", action="store_true", help="try INPOD_WIDE's model at "
                        "full width on [inpod]'s eight ranks (its peak, or where it runs out of "
                        "device memory), and stop")
    args = parser.parse_args()
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
    if args.inpod_wide:
        phase_inpod_wide(dev)
        print(f"[done] [inpod-wide] in {time.perf_counter() - t0:.1f} s")
        return 0
    if args.inpod:
        phase_inpod(dev, smi)
        print(f"[done] the [inpod] phase passed in {time.perf_counter() - t0:.1f} s")
        return 0
    k_in = phase_kernels(dev)
    if args.levels:
        phase_levels(dev, k_in, [int(v) for v in args.levels.split(",")])
        print(f"[done] the kLevels sweep passed in {time.perf_counter() - t0:.1f} s")
        return 0
    if args.against:
        phase_against(dev, k_in, args.against)
        print(f"[done] the comparison with {args.against} passed in "
              f"{time.perf_counter() - t0:.1f} s")
        return 0
    took = {}

    def timed(label, fn, *a):
        t1 = time.perf_counter()
        out = fn(*a)
        took[label] = time.perf_counter() - t1
        return out

    staged = timed("staged", phase_staged, dev)
    per_run, round_ms = timed("main", phase_main_path, dev)
    timed("prng", phase_prng, dev, smi)
    routes_launches, routes_ms = timed("routes", phase_routes, dev)
    round_ms.update(routes_ms)
    qiht_encode, baseline_ms = timed("baselines", phase_baselines, dev)
    round_ms.update(baseline_ms)
    channel_launches, channel_ms = timed("channels", phase_channels, dev)
    round_ms.update(channel_ms)
    knob_launches, knob_ms = timed("knobs", phase_knobs, dev)
    round_ms.update(knob_ms)
    stream_launches, stream_ms = timed("stream", phase_stream, dev)
    round_ms.update(stream_ms)
    layout_launches, layout_ms = timed("layout", phase_layout, dev)
    round_ms.update(layout_ms)
    record_launches = timed("record", phase_record, dev)
    timed("profile", phase_profile, round_ms, dev)
    train_launches, train_errs, train_times_ = timed("train", phase_train, dev)
    ssm_launches, _ = timed("train (e)", phase_train_ssm, dev)
    cohort_launches, cohort_errs, cohort_times = timed("cohort", phase_cohort, dev)
    serve_launches = timed("serve", phase_serve, dev, smi)
    torch.cuda.empty_cache()
    inpod_launches, inpod_errs, inpod_times = timed("inpod", phase_inpod, dev, smi)
    k_in.update({k: {"max_abs_err": v}
                 for k, v in {**train_errs, **cohort_errs, **inpod_errs}.items()})
    times = timed("time", phase_times, dev, k_in)
    times.update(train_times_)
    times.update(cohort_times)
    times.update(inpod_times)
    print("[done] seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in took.items()))
    for label, (_, _, ms, _) in round_ms.items():
        steady = sum(ms[1:]) / (len(ms) - 1) if len(ms) > 1 else float("nan")
        print(f"[round] {label}: wall ms per round {[round(v, 3) for v in ms]}, "
              f"mean of rounds 1..{len(ms) - 1}: {steady:.3f}")
    launches = main_path_launches(per_run, staged)
    launches["bqcs_encode_fused"] += qiht_encode
    for kname, n in (list(routes_launches.items()) + list(channel_launches.items())
                     + list(knob_launches.items()) + list(stream_launches.items())
                     + list(layout_launches.items()) + list(record_launches.items())
                     + list(train_launches.items()) + list(ssm_launches.items())
                     + list(cohort_launches.items()) + list(serve_launches.items())
                     + list(inpod_launches.items())):
        launches[kname] += n
    kernels = []
    for kname, (source, replaces, key) in KERNELS.items():
        tm = times[kname]
        check(launches[kname] > 0, f"{kname} was not launched on its path")
        kernels.append({
            "name": kname, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": launches[kname],
            "max_abs_err": k_in[key]["max_abs_err"], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
        })
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
