"""One-call FedQCS API over gradient dicts, port of ``repro.core.api``:

    codec = api.make_codec(FedQCSConfig(...), device="cuda")
    state = api.init_state(codec, grads_template)
    payload, spec, state = api.compress(codec, grads, state)     # worker side
    ghat = api.reconstruct(codec, payloads, rhos, spec,
                           recon=ReconSpec(mode="ea"))          # PS side

``ReconSpec`` (core/recon_engine.py) says HOW the PS reconstructs: mode,
AE grouping, chunking, kernel routing.  The pre-spec ``mode=``/``groups=``
keywords still work as a deprecated shim.  ``layout=`` picks the block
geometry (``core/layout.py``: monolithic by default, or per-tensor), and
``reconstruct(emit=)`` decodes an EA round a layout segment at a time.
``ReconSpec(channel=(y_eff, nu_eff))`` decodes one received
multiple-access observation (``fed/channel.py``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Sequence

import torch

from repro_torch.core import bussgang
from repro_torch.core.compression import (
    BQCSCodec,
    CompressedGradient,
    FedQCSConfig,
    blocks_to_tree,
)
from repro_torch.core.gamp import em_gamp, gamp_health
from repro_torch.core.layout import GradientLayout
from repro_torch.core.recon_engine import ReconSpec, ea_decode_segments
from repro_torch.core.reconstruction import (
    aggregate_and_estimate,
    estimate_and_aggregate_packed,
    gamp_config_from,
)

__all__ = [
    "FedQCSConfig",
    "BQCSCodec",
    "GradientLayout",
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
    codec: BQCSCodec, grads_template: Any, layout: Optional[GradientLayout] = None
) -> CompressorState:
    return CompressorState(residual=codec.zero_residual(grads_template, layout))


def compress(codec: BQCSCodec, grads: Any, state: CompressorState,
             layout: Optional[GradientLayout] = None):
    """Worker side: returns (CompressedGradient, layout, new state).  The
    payload's ``codes`` are the packed uint32 wire words.  ``layout`` is the
    block geometry (default monolithic); a per-tensor layout with
    per-segment sparsity budgets is encoded a segment at a time
    (``compress_tree_streamed``).  The returned spec IS the layout: pass it
    to :func:`reconstruct`."""
    payload, spec, new_res = codec.compress_tree(grads, state.residual, layout)
    return payload, spec, CompressorState(residual=new_res)


def reconstruct(
    codec: BQCSCodec,
    payloads: Sequence[CompressedGradient],
    rhos: Sequence[float],
    spec: Any,
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

    ``spec`` is the layout :func:`compress` returned (a
    :class:`GradientLayout`, or the legacy ``(treedef, shapes)`` tuple).
    With an EA spec and a layout, ``emit(segment, {leaf id: tensor})``
    turns the decode segment-local (``recon_engine.ea_decode_segments``):
    it fires with each segment's decoded leaves as soon as its rows solve,
    and the returned dict matches the whole-grid decode up to float
    reassociation.
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
    recon = recon.resolve(codec.cfg)
    alphas = torch.stack([p.alpha for p in payloads])
    rhos = torch.as_tensor(rhos, dtype=torch.float32, device=alphas.device)
    live = None
    if emit is not None:
        if recon.mode != "ea" or not isinstance(spec, GradientLayout):
            raise ValueError(
                "segment-local decode (emit=...) needs recon mode 'ea' and a "
                "GradientLayout spec"
            )
        if recon.return_info:
            raise ValueError("emit=... does not carry decode-health info")
        words = torch.stack([p.codes for p in payloads])
        blocks = ea_decode_segments(codec, words, alphas, rhos, spec, packed=True,
                                    use_kernels=recon.use_kernels, chunk=recon.chunk,
                                    emit=emit)
        return blocks_to_tree(blocks, spec, payloads[0].nbar)
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
    nbar = payloads[0].nbar
    if not recon.return_info:
        return blocks_to_tree(blocks, spec, nbar)
    blocks, ginfo = blocks
    info = {"converged": ginfo.converged, "iters": ginfo.iters}
    info.update(gamp_health(ginfo, live))
    return blocks_to_tree(blocks, spec, nbar), info
