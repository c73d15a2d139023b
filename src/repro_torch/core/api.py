"""One-call FedQCS API over gradient dicts, port of ``repro.core.api``:

    codec = api.make_codec(FedQCSConfig(...), device="cuda")
    state = api.init_state(codec, grads_template)
    payload, spec, state = api.compress(codec, grads, state)     # worker side
    ghat = api.reconstruct(codec, payloads, rhos, spec,
                           recon=ReconSpec(mode="ea"))          # PS side

``ReconSpec`` (core/recon_engine.py) says HOW the PS reconstructs: mode,
AE grouping, chunking, kernel routing.  The pre-spec ``mode=``/``groups=``
keywords still work as a deprecated shim.  The monolithic layout is the
only one ported; the segment-local decode (``emit=``) raises
``NotImplementedError``.  ``ReconSpec(channel=(y_eff, nu_eff))``
decodes one received multiple-access observation (``fed/channel.py``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Sequence

import torch

from repro_torch import not_in_slice
from repro_torch.core import bussgang
from repro_torch.core.compression import (
    BQCSCodec,
    CompressedGradient,
    FedQCSConfig,
    Layout,
    blocks_to_tree,
)
from repro_torch.core.gamp import em_gamp, gamp_health
from repro_torch.core.recon_engine import ReconSpec
from repro_torch.core.reconstruction import (
    aggregate_and_estimate,
    estimate_and_aggregate_packed,
    gamp_config_from,
)

__all__ = [
    "FedQCSConfig",
    "BQCSCodec",
    "Layout",
    "ReconSpec",
    "make_codec",
    "init_state",
    "compress",
    "reconstruct",
    "CompressorState",
]


@dataclasses.dataclass
class CompressorState:
    """Worker-side persistent state: the error-feedback residual blocks."""

    residual: torch.Tensor  # (nblocks, N)


def make_codec(cfg: FedQCSConfig, device="cuda", a: Optional[torch.Tensor] = None) -> BQCSCodec:
    """The codec on ``device`` (default the card; ``"cpu"`` runs the plain
    versions).  ``a`` injects the sensing matrix, as ``BQCSCodec`` does."""
    return BQCSCodec(cfg, a=a, device=device)


def init_state(
    codec: BQCSCodec, grads_template: Any, layout: Optional[Layout] = None
) -> CompressorState:
    return CompressorState(residual=codec.zero_residual(grads_template, layout))


def compress(codec: BQCSCodec, grads: Any, state: CompressorState,
             layout: Optional[Layout] = None):
    """Worker side: returns (CompressedGradient, layout, new state).  The
    payload's ``codes`` are the packed uint32 wire words; pass the returned
    layout to :func:`reconstruct`."""
    payload, spec, new_res = codec.compress_tree(grads, state.residual, layout)
    return payload, spec, CompressorState(residual=new_res)


def reconstruct(
    codec: BQCSCodec,
    payloads: Sequence[CompressedGradient],
    rhos: Sequence[float],
    spec: Layout,
    recon: Optional[ReconSpec] = None,
    mode: Optional[str] = None,
    groups: Optional[int] = None,
    emit=None,
) -> Any:
    """PS side: fuses K payloads into the reconstructed gradient dict.

    ``recon`` selects the strategy: mode="ea" runs one Q-EM-GAMP per worker
    payload straight from the packed words (the chunked engine); mode="ae"
    Bussgang-combines the codes first, or with ``recon.channel`` decodes the
    received observation with the payloads' alphas.  Chunking and kernel
    routing come from the spec, deferring to the codec config where unset.  A spec with
    ``return_info`` returns ``(tree, info)``: the per-problem ``converged``
    flags and ``iters`` counts ((K, nb) on EA, (nb,) on AE) and their
    summary (``gamp_iters_mean`` / ``gamp_iters_max`` /
    ``gamp_converged_frac``, live problems only).
    """
    if recon is None:
        if mode is not None or groups is not None:
            warnings.warn(
                "reconstruct(mode=..., groups=...) is deprecated; pass "
                "recon=ReconSpec(mode=..., groups=...) instead",
                DeprecationWarning,
                stacklevel=2,
            )
        recon = ReconSpec(
            mode=mode if mode is not None else "ae",
            groups=groups if groups is not None else 1,
        )
    elif mode is not None or groups is not None:
        raise TypeError(
            "pass either recon=ReconSpec(...) or the deprecated "
            "mode=/groups= keywords, not both"
        )
    if emit is not None:
        raise not_in_slice("the segment-local decode (reconstruct(emit=...))", "item 9")
    recon = recon.resolve(codec.cfg)
    alphas = torch.stack([p.alpha for p in payloads])
    rhos = torch.as_tensor(rhos, dtype=torch.float32, device=alphas.device)
    live = None
    if recon.mode == "ea":
        # the payload words pass straight to the packed engine
        words = torch.stack([p.codes for p in payloads])
        blocks = estimate_and_aggregate_packed(
            codec, words, alphas, rhos, use_kernels=recon.use_kernels, chunk=recon.chunk,
            with_info=recon.return_info,
        )
        live = alphas > 0  # dead blocks freeze at iteration 0
    elif recon.channel is not None:
        # the joint-estimation decode of one superimposed reception: y_eff
        # is already the aggregate's observation, so only the quantization
        # and channel variances and the GAMP-init energy remain (eq. 24 +
        # nu_eff)
        y_eff, nu_eff = recon.channel
        cfg = codec.cfg
        nu = bussgang.effective_noise_var(alphas, rhos, codec.codebook) + nu_eff
        energy = bussgang.signal_energy(alphas, rhos, cfg.m, cfg.block_size)
        blocks = em_gamp(
            y_eff, nu, codec.a, gamp_config_from(codec), init_var=energy,
            use_kernels=recon.use_kernels, with_info=recon.return_info,
        )
    else:
        # AE's Bussgang combine consumes indices: unpack once, at the PS
        codes = torch.stack([codec.unpack(p.codes) for p in payloads])
        blocks = aggregate_and_estimate(
            codec, codes, alphas, rhos, groups=recon.groups, use_kernels=recon.use_kernels,
            with_info=recon.return_info,
        )
    if not recon.return_info:
        return blocks_to_tree(blocks, spec)
    blocks, ginfo = blocks
    info = {"converged": ginfo.converged, "iters": ginfo.iters}
    info.update(gamp_health(ginfo, live))
    return blocks_to_tree(blocks, spec), info
