"""Compressed cross-pod gradient reduction: the paper's technique as a
collective (port of ``repro.runtime.collectives``).

:func:`fedqcs_pod_allreduce` runs in one process per pod (on an in-pod
mesh: per device, over the ranks that share its in-pod position), over
the pod axis's ``torch.distributed`` process group
(``models/sharding.py``'s ``all_gather`` and ``all_reduce``).  Two wire
modes:

  * ``gather_codes`` (paper-faithful): an all-gather of the bit-packed
    uint32 words the fused encoder emits (as bytes), the f32 alphas and
    the participation flags; every pod then Bussgang-aggregates (AE) or
    runs the per-worker Q-EM-GAMP (EA) redundantly.  Cross-pod bytes a
    step: pods * nb * (W * 4 + 4).
  * ``psum_dequant``: each pod dequantizes and Bussgang-weights its own
    codes and one ``all_reduce`` sums the observation (and the noise and
    energy terms).  EA needs the per-worker codes, so it rejects this wire.

:func:`fedqcs_vmapped_allreduce` is the single-process form over a
``(pods, nb, N)`` batch (``impl="auto"``): the pods' encodes run one after
the other and the Bussgang sum over the pod axis is a plain sum.

Partial participation: a pod whose flag is 0 has weight rho_k = 0, so its
payload is ignored exactly, and its error-feedback residual keeps its FULL
carry (blocks + residual), to be sent once it rejoins.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import bussgang
from repro_torch.core.compression import BQCSCodec
from repro_torch.core.gamp import GampConfig, em_gamp
from repro_torch.core.layout import GradientLayout
from repro_torch.core.recon_engine import ReconSpec
from repro_torch.core.reconstruction import estimate_and_aggregate_packed
from repro_torch.models.sharding import all_gather, all_reduce

__all__ = [
    "fedqcs_pod_allreduce",
    "fedqcs_vmapped_allreduce",
    "make_sharded_allreduce",
    "fedqcs_partial_fold",
    "fedqcs_partial_finalize",
]


SHARDED_EA_ERROR = (
    "recon_mode='ea' is not supported by the per-shard (auto_sharded) "
    "path: it Bussgang-aggregates over the auto pod axis and never "
    "materializes per-worker codes; use impl='auto' or 'shard_map' "
    "with wire_mode='gather_codes' (see DESIGN.md)"
)


def fedqcs_pod_allreduce(
    blocks: torch.Tensor,  # (nb, N) this pod's gradient blocks
    residual: torch.Tensor,  # (nb, N) its error-feedback state
    codec: BQCSCodec,
    group=None,  # the pod axis's process group (None: the world group)
    participating: Optional[torch.Tensor] = None,  # scalar flag of this pod
    recon: Optional[ReconSpec] = None,  # overrides cfg.recon_mode / recon_chunk
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (reconstructed aggregate blocks, this pod's new residual),
    the aggregate identical on every rank."""
    cfg = codec.cfg
    n, m = cfg.block_size, cfg.m
    recon = (recon if recon is not None else ReconSpec(mode=cfg.recon_mode)).resolve(cfg)
    if participating is None:
        participating = 1.0
    part = torch.as_tensor(participating, dtype=torch.float32, device=blocks.device).reshape(())

    alive = all_gather(part, group)  # (K,)
    total = torch.clamp(torch.sum(alive), min=1.0)
    rhos = alive / total
    rho_self = part / total

    if recon.mode == "ea" and cfg.wire_mode != "gather_codes":
        raise ValueError(
            "recon_mode='ea' needs the per-worker codes on the PS side, i.e. "
            "wire_mode='gather_codes' (see DESIGN.md)"
        )

    if cfg.wire_mode == "gather_codes":
        words, alpha, new_residual = codec.compress_blocks_packed(blocks, residual)
        # a dead pod's encode reaches no aggregate: it keeps the full carry
        new_residual = torch.where(part > 0, new_residual, blocks + residual)
        all_words = all_gather(words, group)  # (K, nb, W)
        all_alpha = all_gather(alpha, group)  # (K, nb)
        if recon.mode == "ea":
            ghat = estimate_and_aggregate_packed(
                codec, all_words, all_alpha, rhos,
                use_kernels=recon.use_kernels, chunk=recon.chunk,
            )
            return ghat, new_residual
        y = bussgang.aggregate_packed(all_words, all_alpha, rhos, codec.codebook, m)
        nu = bussgang.effective_noise_var(all_alpha, rhos, codec.codebook)
        energy = bussgang.signal_energy(all_alpha, rhos, m, n)
    else:  # psum_dequant: only dequantized sums cross the wire
        if cfg.use_kernels:
            words, alpha, new_residual = codec.compress_blocks_packed(blocks, residual)
            deq = codec.dequantize_packed(words)
        else:
            codes, alpha, new_residual = codec.compress_blocks(blocks, residual)
            deq = codec.dequantize(codes)
        new_residual = torch.where(part > 0, new_residual, blocks + residual)
        w = bussgang.bussgang_weight(rho_self, alpha, codec.codebook)  # (nb,)
        y = all_reduce(w[:, None] * deq, group)
        safe = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
        ratio = rho_self / safe
        nu_local = codec.codebook.kappa * torch.where(
            alpha > 0, ratio * ratio, torch.zeros_like(alpha))
        nu = all_reduce(nu_local, group)
        en_local = torch.where(alpha > 0, rho_self * rho_self * m / (safe * safe),
                               torch.zeros_like(alpha)) / n
        energy = all_reduce(en_local, group)

    return _reconstruct(y, nu, energy, codec), new_residual


def fedqcs_vmapped_allreduce(
    blocks_pp: torch.Tensor,  # (pods, nb, N) per-pod gradient blocks
    residual_pp: torch.Tensor,  # (pods, nb, N)
    codec: BQCSCodec,
    participating: torch.Tensor,  # (pods,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-process form: every pod's encode in turn (one encoder launch a
    pod on the kernel route), then the Bussgang sum over pods (AE) or the
    per-worker decode of all pods' words (EA).  Returns (aggregate blocks,
    (pods, nb, N) new residuals)."""
    cfg = codec.cfg
    n, m = cfg.block_size, cfg.m
    part = participating.to(torch.float32)
    rhos = part / torch.clamp(torch.sum(part), min=1.0)
    ea = cfg.recon_mode == "ea"
    obs, alpha, new_residual = _encode_pods(codec, blocks_pp, residual_pp, part, packed=ea)
    if ea:
        return estimate_and_aggregate_packed(codec, obs, alpha, rhos), new_residual
    y = bussgang.aggregate_codes(obs, alpha, rhos, codec.codebook)
    nu = bussgang.effective_noise_var(alpha, rhos, codec.codebook)
    energy = bussgang.signal_energy(alpha, rhos, m, n)
    return _reconstruct(y, nu, energy, codec), new_residual


def _encode_pods(codec: BQCSCodec, blocks_pp, residual_pp, part, packed: bool):
    """Each pod's encode in turn -> (words or codes (pods, nb, .), alphas
    (pods, nb), new residuals (pods, nb, N)); a pod whose flag is 0 keeps
    blocks + residual.  One pod's encoder outputs are live at a time."""
    encode = codec.compress_blocks_packed if packed else codec.compress_blocks
    obs, alphas = [], []
    new_residual = torch.empty_like(residual_pp)
    for p in range(blocks_pp.shape[0]):
        o, al, r = encode(blocks_pp[p], residual_pp[p])
        new_residual[p] = torch.where(part[p] > 0, r, blocks_pp[p] + residual_pp[p])
        del r
        obs.append(o)
        alphas.append(al)
    return torch.stack(obs), torch.stack(alphas), new_residual


def make_sharded_allreduce(codec: BQCSCodec, mesh, local_shapes: Sequence[Tuple[int, ...]],
                           nbar_local: int):
    """Per-shard FedQCS (``impl="auto_sharded"``): each device blocks its own
    local shard of every gradient leaf -- a fixed permutation of the paper's
    global blocking, to which the sensing and quantization theory is
    invariant -- so the gradient tree never changes layout.  With one card a
    pod the local shards are the whole leaves.

    Returns ``body(residual (pods, nb, N), rhos (pods,), *grad_leaves
    (pods, ...)) -> (new_residual, *aggregate leaves)``.  AE only."""
    cfg = codec.cfg
    if cfg.recon_mode == "ea":
        raise ValueError(SHARDED_EA_ERROR)
    n = cfg.block_size
    # one key a leaf, in the leaves' order (zero-padded: the layout sorts keys)
    layout = GradientLayout.from_shapes(
        tuple(f"{i:06d}" for i in range(len(local_shapes))),
        [(tuple(s), torch.float32) for s in local_shapes], n,
    )
    if layout.nbar != nbar_local:
        raise ValueError(
            f"local_shapes sum to {layout.nbar} scalars, caller says {nbar_local}"
        )

    def body(residual, rhos, *grad_leaves):
        blocks = layout.to_blocks_batched(dict(zip(layout.treedef, grad_leaves)))
        # rho == 0 pods are dead: their full carry stays in the residual
        codes, alpha, new_res = _encode_pods(codec, blocks, residual, rhos, packed=False)
        y = bussgang.aggregate_codes(codes, alpha, rhos, codec.codebook)
        nu = bussgang.effective_noise_var(alpha, rhos, codec.codebook)
        energy = bussgang.signal_energy(alpha, rhos, cfg.m, n)
        ghat = _reconstruct(y, nu, energy, codec)
        tree = layout.tree_from_blocks(ghat)
        return (new_res, *(tree[k] for k in layout.treedef))

    return body


def fedqcs_partial_fold(
    stats,  # core.aggregator.PartialStats or None (None starts a round)
    words: torch.Tensor,  # (B, nb, W) packed wire words of one payload batch
    alphas: torch.Tensor,  # (B, nb)
    weights: torch.Tensor,  # (B,) RAW (unnormalized) aggregation weights
    codec: BQCSCodec,
    nu_chan: Optional[torch.Tensor] = None,  # (B, nb) channel variance
    noise: Optional[torch.Tensor] = None,  # (B, nb, M) sampled channel noise
):
    """Folds one gathered sub-cohort payload batch into running AE
    sufficient statistics (the streaming PS's building block); weights are
    raw, the finalize renormalizes."""
    from repro_torch.core import aggregator

    batch = aggregator.ae_batch_stats(codec, words, alphas, weights, nu_chan, noise)
    return batch if stats is None else aggregator.stats_add(stats, batch)


def fedqcs_partial_finalize(stats, codec: BQCSCodec, gamp: Optional[GampConfig] = None):
    """Decodes the round from folded partial stats -> (nb, N) aggregated
    blocks (one EM-GAMP on the renormalized Bussgang observation)."""
    from repro_torch.core import recon_engine

    return recon_engine.decode_from_stats(codec, stats, gamp, use_kernels=codec.cfg.use_kernels)


def _reconstruct(y, nu, energy, codec: BQCSCodec) -> torch.Tensor:
    cfg = codec.cfg
    gcfg = GampConfig(
        n_components=cfg.gamp_components,
        iters=cfg.gamp_iters,
        variance_mode=cfg.gamp_variance_mode,
        tol=0.0,  # a fixed amount of work inside the step
    )
    return em_gamp(y, nu, codec.a, gcfg, init_var=energy, use_kernels=cfg.use_kernels)
