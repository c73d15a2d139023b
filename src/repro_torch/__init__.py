"""repro_torch — the PyTorch/CUDA port of the FedQCS system in ``repro``.

Mirrors ``repro``'s layout module for module (``core/``, ``kernels/``,
``fed/``, ``obs/``, ``optim/``, ``data/``, ``paper/``, ``configs/``,
``models/``, ``runtime/``, ``launch/``, ``checkpoint/``) and keeps its public
names, so every ported module has exactly one reference module.  The port imports
``torch``, numpy and the standard library only; it never imports ``jax`` or
anything of ``repro``.

The port covers one barrier round of the paper's Sec. VI experiment: the
``lloyd_max``, ``dithered_uniform`` and ``vq`` codebooks; the reference's
default XLA-algorithm route (``use_kernels=False``: exact or bisecting
top-S, one GEMM, the codebook's encode, the wire packing) and the kernel
route (the fused BQCS encoder; the staged one, ``block_sparsify`` ->
``bqcs_encode`` -> ``pack_codes``; the AE ``gamp_step`` and packed EA
``qgamp_step`` GAMP steps); the reference's GAMP loop as plain PyTorch
(exact or scalar variance, damping, early freeze and early stop); the
chunked and two-phase EA engine (``core/recon_engine.py``) and the
``core/api.py`` facade; all six methods of the paper's comparison
(``fedqcs-ae``, ``fedqcs-ea`` and the baselines of ``core/baselines.py``:
``qcs-qiht``, ``qcs-dither``, ``signsgd``, ``none``); the uplinks of
``fed/channel.py`` (``ideal``, and for ``fedqcs-ae`` the noisy ``awgn``,
``rayleigh`` and ``mimo_mac`` with LMMSE or zero-forcing combining); the
``iid``, ``shard``, ``dirichlet`` and ``paper`` partitions, the ``full``,
``uniform`` and ``async`` schedulers, the FedAvg, FedAvgM and FedAdam
servers (Adam or SGD, fp32 or blockwise-int8 states), the AE decode in G
groups, the chunked client pass and the per-client loop oracle; the
streaming PS (``core/aggregator.py``, ``fed/stream.py``, the engine's
``stream=`` rounds), the run telemetry (``obs/``: recorders, spans, the
``python -m repro_torch.obs`` reader, the engine's round events) and the
per-tensor block layouts (``core/layout.py``) with the segment-streamed
client encode and the segment-local EA decode; the model zoo's six
families (dense GQA, MoE, MLA with multi-token prediction, the Qwen2-VL
backbone with M-RoPE over patch prefixes, Mamba2's SSD, Zamba2's hybrid
with a shared attention block, Whisper's encoder-decoder: ``models/``)
with the pod-level FedQCS train step (``runtime/steps.py``,
``python -m repro_torch.launch.train``) and the serve steps (KV, MLA
latent, SSM state and cross-attention caches, prefill, decode:
``make_prefill_step``, ``make_decode_step``,
``examples/serve_lm_torch.py``), and the launcher's cohort mode over the
model zoo with its backward-interleaved client pass
(``models/segment_tap.py``).  The five
kernels are CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use
(``kernels/build.py``).  Routes outside the slices raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.

Every random draw -- the sensing matrix, QCS-Dither's signs, rows and
dither, the initial parameters, the synthetic and cohort batches and the
channel draws -- comes from ``prng``, the port's bit-for-bit counterpart
of the reference's ``jax.random`` (threefry2x32), along the reference's own
key tree: a seed gives the reference's draws.

Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels.  There is no fallback from one to
the other.
"""

import torch

ROADMAP_OUT_OF_SLICE = "ROADMAP.md queue 1"


def not_in_slice(what: str, item: str) -> NotImplementedError:
    """The error every route outside the ported slice raises."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet ({ROADMAP_OUT_OF_SLICE}, {item})"
    )


def entry_device(device) -> torch.device:
    """Resolves an entry point's ``device`` argument.

    A CUDA device with no card raises (there is no fallback to the CPU).
    Matrix products run in IEEE fp32: TF32 keeps ~3 decimal digits and would
    flip codes at the quantizer thresholds, so both TF32 switches go off.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain versions)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


from repro_torch import prng  # noqa: E402  (imports torch and numpy only)
