"""Chunked packed-domain PS reconstruction engine, port of
``repro.core.recon_engine``.

The EA strategy (Procedure 2) is one independent Q-EM-GAMP inversion per
(worker, block): ``K * nb`` problems sharing one sensing matrix.  The engine
bounds what is live at once and how long each problem iterates:

  * **chunking** -- the flat problem batch streams through the solver in
    fixed-size chunks of ``FedQCSConfig.recon_chunk`` rows (a Python loop
    here, the reference's ``lax.scan``), so the GAMP state is O(chunk * N);
    the last chunk is zero-padded with dead rows (alpha == 0), which freeze
    at iteration 0 and come out exactly zero;
  * **packed-domain decode** -- chunks carry the uint32 wire words; the
    ``qgamp_step`` kernel unpacks them per lane group, the plain loop one
    chunk at a time (``qem_gamp_packed``);
  * **early stop per chunk** -- with ``GampConfig.early_stop`` each chunk's
    plain GAMP loop ends when its own slowest block froze.

The two-phase sweep (:func:`ea_decode_two_phase`) runs a scalar-variance
pass everywhere, then re-solves with exact variance only the blocks whose
converged flag is still false; its survivor set is data-dependent, so it
syncs with the host once.  :func:`decode_from_stats` finalizes a streamed
round (``fed/stream.py``) from its folded partial statistics, and
:func:`ea_decode_segments` decodes a layout segment at a time
(``core/layout.py``).  With a ``mesh``, the chunks are shared over the
processes of one of its axes (``chunked_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.gamp import (
    GampConfig,
    GampInfo,
    _qem_gamp_xla,
    em_gamp,
    qem_gamp,
    qem_gamp_packed,
)

__all__ = [
    "ReconSpec",
    "chunked_rows",
    "ea_solve_flat",
    "ea_decode",
    "ea_decode_segments",
    "ea_decode_two_phase",
    "decode_from_stats",
]


@dataclasses.dataclass(frozen=True)
class ReconSpec:
    """One value describing HOW the PS reconstructs a round (the reference's
    fields, with ``use_pallas`` renamed ``use_kernels``):

      mode: "ae" (aggregate-and-estimate) or "ea" (estimate-and-aggregate).
      groups: AE grouping G (K must divide by G).
      chunk: EA row chunking; None defers to ``cfg.recon_chunk``.
      use_kernels: step-kernel routing; None defers to ``cfg.use_kernels``.
      channel: a received multiple-access observation in place of the
        payloads' codes: the ``(y_eff (nb, M), nu_eff (nb,))`` pair a
        channel family's ``combine`` hook returns (fed/channel.py).  AE
        only; the payloads then contribute their alphas (the quantization
        noise and the GAMP init), not codes.
      return_info: ``api.reconstruct`` also returns the decode health.
    """

    mode: str = "ae"
    groups: int = 1
    chunk: Optional[int] = None
    use_kernels: Optional[bool] = None
    channel: Any = None
    return_info: bool = False

    def __post_init__(self):
        if self.mode not in ("ae", "ea"):
            raise ValueError(f"unknown recon mode {self.mode!r} (want 'ea' or 'ae')")
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        if self.mode == "ea" and self.channel is not None:
            raise ValueError(
                "a superimposed multiple-access reception has no per-client "
                "codes, so recon mode 'ea' cannot consume a channel "
                "observation (use mode='ae')"
            )
        if self.channel is not None and self.groups != 1:
            raise ValueError("groups != 1 is only defined for exact-code AE")

    def resolve(self, cfg) -> "ReconSpec":
        """Fills the defer-to-codec fields from a FedQCSConfig."""
        return dataclasses.replace(
            self,
            chunk=cfg.recon_chunk if self.chunk is None else self.chunk,
            use_kernels=cfg.use_kernels if self.use_kernels is None else self.use_kernels,
        )


def _pad_rows_zero(arrays, rows: int, target: int):
    """Zero-pads every tensor's leading axis from ``rows`` to ``target``.
    Zero rows are dead blocks (alpha == 0): the solvers freeze them from
    iteration 0 and emit exact zeros, so padding is output-invariant."""
    pad = target - rows
    if pad == 0:
        return tuple(arrays)
    return tuple(
        torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)])
        for x in arrays
    )


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for any dtype: CUDA has no uint32 gather, so wire words
    are gathered through their int32 view (the same bits)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)[idx].view(torch.uint32)
    return x[idx]


def chunked_rows(
    solve,
    inputs: Tuple[torch.Tensor, ...],
    chunk: int,
    out_width: int,
    mesh=None,
    axis_name: str = "recon",
) -> torch.Tensor:
    """Streams row-aligned ``inputs`` through ``solve(*chunk_inputs) ->
    (chunk, out_width)`` in ``ceil(rows / chunk)`` chunks of ``chunk`` rows,
    the last zero-padded with dead rows.  With a ``mesh``
    (``launch/mesh.py``), the chunks are shared over the processes of its
    ``axis_name`` axis: the chunk count is padded to the axis size, each
    rank solves its contiguous share and an ``all_gather`` gives every rank
    the whole result.  ``chunk <= 0``, or a chunk covering all rows without
    a mesh, degrades to one direct call."""
    rows = inputs[0].shape[0]
    if chunk <= 0 or (chunk >= rows and mesh is None):
        return solve(*inputs)
    nch = -(-rows // chunk)
    lo, hi = 0, nch
    if mesh is not None:
        ndev = mesh.shape[axis_name]
        nch = -(-nch // ndev) * ndev
        rank = mesh.check_group(axis_name)
        lo, hi = rank * (nch // ndev), (rank + 1) * (nch // ndev)
    padded = _pad_rows_zero(inputs, rows, nch * chunk)
    outs = [solve(*(x[i * chunk:(i + 1) * chunk] for x in padded)) for i in range(lo, hi)]
    out = torch.cat(outs).reshape((hi - lo) * chunk, out_width)
    if mesh is not None:
        from repro_torch.runtime.collectives import all_gather

        out = all_gather(out, mesh.group(axis_name)).reshape(nch * chunk, out_width)
    return out[:rows]


def ea_solve_flat(
    codec,
    obs: torch.Tensor,  # (rows, n_codes) codes or (rows, W) packed uint32 words
    alpha: torch.Tensor,  # (rows,)
    gamp: GampConfig,
    *,
    packed: bool,
    use_kernels: bool = False,
    chunk: int = 0,
    mesh=None,
    axis_name: str = "recon",
    with_info: bool = False,
):
    """Solves a flat batch of per-(worker, block) Q-EM-GAMP problems ->
    (rows, N) estimates, through ``qem_gamp_packed`` when ``packed`` else
    ``qem_gamp``.  ``with_info`` returns ``(estimates, GampInfo)``: the
    converged flags and iteration counts ride the chunks as two extra
    output columns."""
    n = codec.cfg.block_size
    if packed:
        def base(o, al):
            return qem_gamp_packed(o, al, codec.a, codec.codebook, gamp, codec.cfg.m,
                                   use_kernels=use_kernels, with_info=with_info)
    else:
        def base(o, al):
            return qem_gamp(o, al, codec.a, codec.codebook, gamp,
                            use_kernels=use_kernels, with_info=with_info)
    if not with_info:
        return chunked_rows(base, (obs, alpha), chunk, n, mesh=mesh, axis_name=axis_name)

    def solve(o, al):
        gh, info = base(o, al)
        return torch.cat([gh, info.converged.to(torch.float32)[:, None],
                          info.iters.to(torch.float32)[:, None]], dim=1)

    stacked = chunked_rows(solve, (obs, alpha), chunk, n + 2, mesh=mesh, axis_name=axis_name)
    info = GampInfo(stacked[:, n] > 0.5, stacked[:, n + 1].to(torch.int32))
    return stacked[:, :n], info


def ea_decode(
    codec,
    obs: torch.Tensor,  # (K, nb, n_codes) uint8 codes or (K, nb, W) uint32 words
    alphas: torch.Tensor,  # (K, nb)
    rhos: torch.Tensor,  # (K,)
    gamp: Optional[GampConfig] = None,
    *,
    packed: bool,
    use_kernels: bool = False,
    chunk: int = 0,
    mesh=None,
    axis_name: str = "recon",
    spec: Optional[ReconSpec] = None,
    with_info: bool = False,
):
    """FedQCS-EA decode through the engine: flatten the (K, nb) problem grid,
    chunk-solve, rho-weight and sum -> (nb, N) aggregated blocks.  A
    ``spec`` overrides ``chunk``/``use_kernels`` (its ``return_info``
    implies ``with_info``); with info the return is ``(blocks, GampInfo)``
    with (K, nb)-shaped arrays."""
    from repro_torch.core.reconstruction import gamp_config_from  # layering

    if spec is not None:
        spec = spec.resolve(codec.cfg)
        chunk, use_kernels = spec.chunk, spec.use_kernels
        with_info = with_info or spec.return_info
    gamp = gamp or gamp_config_from(codec)
    k, nb = obs.shape[:2]
    flat = ea_solve_flat(
        codec, obs.reshape((k * nb,) + tuple(obs.shape[2:])), alphas.reshape(k * nb), gamp,
        packed=packed, use_kernels=use_kernels, chunk=chunk, mesh=mesh, axis_name=axis_name,
        with_info=with_info,
    )
    if with_info:
        flat, info = flat
        agg = torch.einsum("k,kbn->bn", rhos, flat.reshape(k, nb, -1))
        return agg, GampInfo(info.converged.reshape(k, nb), info.iters.reshape(k, nb))
    return torch.einsum("k,kbn->bn", rhos, flat.reshape(k, nb, -1))


def ea_decode_segments(
    codec,
    obs: torch.Tensor,  # (K, nb, n_codes) uint8 codes or (K, nb, W) uint32 words
    alphas: torch.Tensor,  # (K, nb)
    rhos: torch.Tensor,  # (K,)
    layout,  # core.layout.GradientLayout (the round's block geometry)
    gamp: Optional[GampConfig] = None,
    *,
    packed: bool,
    use_kernels: bool = False,
    chunk: int = 0,
    emit=None,  # callback(segment, {leaf id: tensor}) per decoded segment
) -> torch.Tensor:
    """Segment-local FedQCS-EA decode: each layout segment's ``(K, rows)``
    block problems solve and aggregate on their own (one :func:`ea_decode`
    a segment), and ``emit(segment, leaves)`` fires with that segment's
    decoded leaves as soon as it is done, without waiting for the rest of
    the model.  Every segment is its own chunked solve, so no chunk
    straddles two tensors (build per-tensor layouts with
    ``row_multiple=chunk`` to keep the chunks full).  Each GAMP problem is
    one (worker, block) row, so the result matches :func:`ea_decode` over
    the whole grid up to float reassociation (products over other row
    counts round differently, and GAMP iterates on them).  Returns the
    aggregated ``(nb, N)`` block grid."""
    if layout.rows != obs.shape[1]:
        raise ValueError(f"layout has {layout.rows} block rows, payloads have {obs.shape[1]}")
    parts = []
    for seg in layout.segments:
        agg = ea_decode(codec, obs[:, seg.row_slice], alphas[:, seg.row_slice], rhos, gamp,
                        packed=packed, use_kernels=use_kernels, chunk=chunk)
        if emit is not None:
            emit(seg, layout.segment_leaves(seg.index, agg))
        parts.append(agg)
    return torch.cat(parts)


def ea_decode_two_phase(
    codec,
    obs: torch.Tensor,  # (K, nb, n_codes) uint8 codes or (K, nb, W) uint32 words
    alphas: torch.Tensor,  # (K, nb)
    rhos: torch.Tensor,  # (K,)
    gamp: Optional[GampConfig] = None,
    *,
    packed: bool,
    chunk: int = 0,
    refine_iters: Optional[int] = None,
    mesh=None,
    axis_name: str = "recon",
):
    """Two-phase EA sweep: scalar-variance GAMP on the plain loop everywhere
    (its early-freeze flags are the survivor signal; the step kernels have
    none), then exact-variance GAMP re-solves ONLY the blocks still
    unconverged.  The survivor gather syncs with the host once.  Returns
    (aggregated (nb, N) blocks, stats dict with the phase-2 counts)."""
    from repro_torch.core.reconstruction import gamp_config_from  # layering

    gamp = gamp or gamp_config_from(codec)
    k, nb = obs.shape[:2]
    rows = k * nb
    n = codec.cfg.block_size
    flat_obs = obs.reshape((rows,) + tuple(obs.shape[2:]))
    flat_alpha = alphas.reshape(rows)

    def codes_of(o):
        return codec.unpack(o) if packed else o

    p1 = dataclasses.replace(gamp, variance_mode="scalar")

    def solve_flags(o, al):
        gh, fl, it = _qem_gamp_xla(codes_of(o), al, codec.a, codec.codebook, p1)
        return torch.cat([gh, fl.to(torch.float32)[:, None], it.to(torch.float32)[:, None]],
                         dim=1)

    stacked = chunked_rows(solve_flags, (flat_obs, flat_alpha), chunk, n + 2, mesh=mesh,
                           axis_name=axis_name)
    ghat = stacked[:, :n]
    survivors = torch.nonzero(stacked[:, n] <= 0.5).flatten()  # the host sync
    n_surv = int(survivors.numel())
    if n_surv:
        p2 = dataclasses.replace(
            gamp, variance_mode="exact",
            iters=refine_iters if refine_iters is not None else gamp.iters, early_stop=False,
        )
        refined, _, _ = _qem_gamp_xla(codes_of(_take_rows(flat_obs, survivors)),
                                      flat_alpha[survivors], codec.a, codec.codebook, p2)
        ghat = ghat.index_copy(0, survivors, refined)
    stats = {
        "rows": rows,
        "phase2_rows": n_surv,
        "phase2_frac": float(n_surv) / max(rows, 1),
        "phase1_iters_mean": float(stacked[:, n + 1].mean()) if rows else 0.0,
        "unconverged_survivors": n_surv,
    }
    return torch.einsum("k,kbn->bn", rhos, ghat.reshape(k, nb, n)), stats


def decode_from_stats(
    codec,
    stats,  # core.aggregator.PartialStats (the folded round total)
    gamp: Optional[GampConfig] = None,
    *,
    use_kernels: bool = False,
    with_info: bool = False,
):
    """Finalizes a streamed round straight from folded partial sufficient
    statistics (``core/aggregator.py``) -> (nb, N) aggregated blocks.
    ``with_info`` returns ``(blocks, GampInfo | None)``: the finalize
    EM-GAMP's decode health on the "ae" path, None on "ea" (whose GAMP ran
    per ingest batch; ``StreamingPS`` accumulates that).

    "ea" stats hold the raw-weighted sum of per-client GAMP estimates, so
    finalization is the 1/W renormalization.  "ae" stats hold the Bussgang
    aggregate's (y, nu, energy) accumulated with RAW weights; after the 1/W
    and 1/W^2 rescale one EM-GAMP inversion finishes the decode as
    ``reconstruction.aggregate_and_estimate`` does (on the kernel route,
    ``gamp_step`` at nb rows)."""
    from repro_torch.core.aggregator import normalized_stats  # layering
    from repro_torch.core.reconstruction import gamp_config_from  # layering

    y, nu, energy = normalized_stats(stats)
    if stats.mode == "ea":
        return (y, None) if with_info else y
    gamp = gamp or gamp_config_from(codec)
    return em_gamp(y, nu, codec.a, gamp, init_var=energy, use_kernels=use_kernels,
                   with_info=with_info)
