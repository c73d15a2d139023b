"""Multi-head latent attention, DeepSeek-V3 (port of ``repro.models.mla``).

Train and prefill decompress the latents into full per-head K/V (plain
GEMMs).  Decode keeps the *compressed* latent ``ckv`` (kv_lora_rank) and
the shared rope key ``kr`` as the cache -- (rank + rope) values a token
instead of 2 H dh -- and absorbs the up-projections into the query and
output transforms, so attention contracts against the latent directly.
Both paths keep the reference's fp32 score scale and its ``-1e30`` mask.

On an in-pod mesh (the train path) the down-projections ``w_dq``,
``w_dkv`` and ``w_kr`` are gathered over ``data`` and every rank computes
the latents; the latents enter the tensor-parallel region (``tp_enter``:
their gradient, partial over the rank's heads, is summed over ``model``);
the up-projections ``w_uq``, ``w_uk`` and ``w_uv`` hold the rank's heads'
columns and ``wo`` its rows, the output summed over ``model``.  The
decode splits the latent cache's slots over ``model``
(:func:`apply_mla_decode`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    apply_rope,
    dense_init,
    dtype_of,
    full,
    rms_norm,
    update_slot,
    valid_slots,
)
from repro_torch.models.sharding import (
    cs,
    current_inpod,
    fsdp_mm,
    fsdp_mms,
    fsdp_out,
    model_heads,
    model_whole_parts,
    split_kv_combine,
    tp_enter,
)

_MASKED = -1e30


def init_mla(key: torch.Tensor, cfg: ModelConfig) -> dict:
    """MLA weights (stacked like ``key``), keys in sorted order:
    ``split(key, 8)`` into w_dq, w_uq, w_dkv, w_kr, w_uk, w_uv, wo."""
    d, h, dt = cfg.d_model, cfg.n_heads, dtype_of(cfg)
    qk_nope, qk_rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    ks = prng.split(key, 8).unbind(-2)
    return {
        "kv_norm_lr": full(key, (rkv,), 1.0, dt),
        "q_norm_lr": full(key, (rq,), 1.0, dt),
        "w_dkv": dense_init(ks[2], (d, rkv), dt, d),
        "w_dq": dense_init(ks[0], (d, rq), dt, d),
        "w_kr": dense_init(ks[3], (d, qk_rope), dt, d),
        "w_uk": dense_init(ks[4], (rkv, h * qk_nope), dt, rkv),
        "w_uq": dense_init(ks[1], (rq, h * (qk_nope + qk_rope)), dt, rq),
        "w_uv": dense_init(ks[5], (rkv, h * dv), dt, rkv),
        "wo": dense_init(ks[6], (h * dv, d), dt, h * dv),
    }


def _sqrt_dk(cfg: ModelConfig) -> np.float32:
    """sqrt(qk_nope + qk_rope) in fp32.  The train path multiplies the fp32
    scores by its reciprocal, the decode path divides by it (as the
    reference does each)."""
    return np.sqrt(np.float32(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))


def _queries(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """(q_nope, rotated q_rope), each (B, S, H, *): in-pod the rank's heads,
    from the normed query latent entering the tensor-parallel region."""
    b, s, d = x.shape
    qk_nope, qk_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = tp_enter(rms_norm(fsdp_mm(x, p["w_dq"]), p["q_norm_lr"], cfg.norm_eps))
    q = (cq @ p["w_uq"]).reshape(b, s, -1, qk_nope + qk_rope)
    return q[..., :qk_nope], apply_rope(q[..., qk_nope:], positions, cfg.rope_theta)


def latents(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> dict:
    """The layer's cache entries for ``x``: ``ckv`` (B, S, r), the normed
    latent, and ``kr`` (B, S, rope), the rotated shared key (in-pod: the
    down-projections gathered over ``data``, every rank computing both)."""
    dkv, kr = fsdp_mms(x, [p["w_dkv"], p["w_kr"]])
    ckv = rms_norm(dkv, p["kv_norm_lr"], cfg.norm_eps)
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return {"ckv": ckv, "kr": kr}


def mla_train(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """Full-sequence causal MLA (the decompressed path): ``(out, latents)``
    -- prefill keeps the latents as the cache."""
    b, s, d = x.shape
    qk_nope, qk_rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _queries(p, x, positions, cfg)
    h = q_nope.shape[2]  # the heads this rank holds
    lat = latents(p, x, positions, cfg)
    ckv, kr = tp_enter(lat["ckv"]), tp_enter(lat["kr"])
    k_nope = (ckv @ p["w_uk"]).reshape(b, s, h, qk_nope)
    v = (ckv @ p["w_uv"]).reshape(b, s, h, dv)
    k_rope = kr[:, :, None, :].expand(b, s, h, qk_rope)
    q = cs(torch.cat([q_nope, q_rope], dim=-1), "batch", "seq", "heads", None)
    kk = cs(torch.cat([k_nope, k_rope], dim=-1), "batch", "seq", "heads", None)
    inv_sqrt_dk = float(np.float32(1.0) / _sqrt_dk(cfg))
    scores = torch.einsum("bqhd,bshd->bhqs", q, kk).float() * inv_sqrt_dk
    mask = torch.arange(s, device=x.device)[None, :] <= torch.arange(s, device=x.device)[:, None]
    scores = torch.where(mask[None, None], scores, torch.tensor(_MASKED, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v).reshape(b, s, h * dv)
    return cs(fsdp_out(out, p["wo"], d), "batch", "seq", "dmodel", reduce="model"), lat


def apply_mla_train(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """Full-sequence causal MLA (the decompressed path)."""
    return mla_train(p, x, positions, cfg)[0]


def apply_mla_decode(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                     cache: dict, cache_pos):
    """The absorbed decode of x (B, 1, D): ``(out, cache)``.  ``cache`` is
    ``{"ckv" (B, Smax, r), "kr" (B, Smax, rope)}``; the new latents are
    written into it at ``cache_pos`` in place (the reference's clamped
    ``dynamic_update_slice``) and attention runs over the slots
    ``<= cache_pos``.

    In-pod the cache is the rank's slots (split-KV): every rank computes
    the new latents and the one that owns slot ``cache_pos`` writes them;
    the rank's heads' absorbed queries are gathered whole over ``model``,
    every head's partials over the rank's slots are combined over
    ``model`` (:func:`~repro_torch.models.sharding.split_kv_combine`), and
    the rank's heads' latent context goes through their ``w_uv`` columns
    and ``wo`` rows, the output summed over ``model``."""
    b, s, d = x.shape
    qk_nope, dv, r = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q_nope, q_rope = _queries(p, x, positions, cfg)
    h = q_nope.shape[2]  # the heads this rank holds
    new = latents(p, x, positions, cfg)
    ckv = update_slot(cache["ckv"], new["ckv"], cache_pos)
    kr = update_slot(cache["kr"], new["kr"], cache_pos)
    out_cache = {"ckv": ckv, "kr": kr}
    ckv_x, kr_x = ckv.to(x.dtype), kr.to(x.dtype)
    # absorb W_uk into the query: q_abs (B, 1, H, r)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, p["w_uk"].reshape(r, h, qk_nope))
    split = current_inpod() is not None
    if split:
        first, count = model_heads(cfg.n_heads)
        both = model_whole_parts([torch.cat([q_abs, q_rope], dim=-1)], 2)[0]
        q_abs, q_rope = both.split([r, q_rope.shape[-1]], dim=-1)
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, ckv_x)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, kr_x)).float() / float(_sqrt_dk(cfg))
    valid = valid_slots(ckv.shape[1], cache_pos, x.device)
    scores = torch.where(valid, scores, torch.tensor(_MASKED, device=x.device))
    if split:  # the rank's partials (a rank with no valid slot: m = -1e30, l = 0)
        m = torch.amax(scores, dim=-1)
        probs = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
        part = torch.einsum("bhqs,bsr->bqhr", probs.to(x.dtype), ckv_x)
        ctx = split_kv_combine(m.transpose(1, 2), torch.sum(probs, dim=-1).transpose(1, 2), part)
        ctx = ctx.to(x.dtype)[:, :, first:first + count]
    else:
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqs,bsr->bqhr", probs, ckv_x)  # the latent context
    out = torch.einsum("bqhr,rhd->bqhd", ctx, p["w_uv"].reshape(r, h, dv)).reshape(b, s, h * dv)
    return cs(fsdp_out(out, p["wo"], d), "batch", "seq", "dmodel", reduce="model"), out_cache
