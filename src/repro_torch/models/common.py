"""Shared building blocks of the model zoo's transformer family (port of
``repro.models.common``).

Parameters are nested dicts of tensors; every block has an ``init_*``
that draws from a threefry key (``repro_torch.prng``) along the
reference's key tree, and an ``apply`` function.  A ``(L, 2)`` batch of
layer keys draws a stacked block's L layers in one call, each layer on its
own counters (the reference's ``vmap`` over its layer keys); a key on the
``meta`` device gives the shapes and dtypes alone.  Compute runs in the
config dtype (bf16 by default) with fp32 norm, softmax-max and
probability-sum accumulation, in the reference's order of operations.
Attention has the training path and the cached decode path (a KV cache
written at ``cache_pos``); rotary embeddings are standard or Qwen2-VL's
M-RoPE.  Cross-attention (K/V from an encoder) and the ungated GELU MLP
serve the audio family.

On an in-pod mesh (``models/sharding.py``'s :func:`use_inpod`) the
training and serve paths run on the rank's shards, as the reference's
rules lay them out: attention's wq/wk/wv split by head over ``model`` (a
rank takes its query heads' KV groups) and ``wo`` by row, the MLP's wi/wg
by column and wo by row, the embedding and the head by vocabulary row;
every weight's d_model dimension gathered over ``data`` as it is used
(without autograd, the activations instead where they are the smaller:
``sharding.fsdp_mms``).  The
cross-entropy is vocab-parallel and the loss the mean over the pod's
tokens; a vocabulary the ``model`` axis does not divide keeps its table
whole over ``model`` (its sanitized spec), and every rank then takes the
whole rows.  A decode step attends over the rank's cache slots with
every query head and combines the ranks' partials over ``model``
(split-KV).  These blocks serve every family the in-pod program runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import prng
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import (
    all_reduce,
    batch_sum,
    cs,
    current_inpod,
    fsdp_mm,
    fsdp_mms,
    fsdp_out,
    fsdp_rows,
    kv_slots,
    model_columns,
    model_heads,
    model_whole_parts,
    split_kv_combine,
    tp_enter,
)

_INIT_STD = 0.02


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_key(seed, device) -> torch.Tensor:
    """An init's root key on ``device``: ``PRNGKey(seed)`` for an int seed,
    or the key given."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device)
    return prng.PRNGKey(seed, device=device)


def dense_init(key: torch.Tensor, shape, dtype, fan_in: Optional[int] = None) -> torch.Tensor:
    """fp32 normal draws from ``key`` (``(*L, 2)``: ``(*L, *shape)``, on the
    key's device) times 0.02 or 1/sqrt(fan_in), cast to ``dtype``."""
    scale = _INIT_STD if fan_in is None else float(np.float32(1.0) / np.sqrt(np.float32(fan_in)))
    return (prng.normal(key, shape) * scale).to(dtype)


def full(key: torch.Tensor, shape, value: float, dtype) -> torch.Tensor:
    """A constant leaf stacked like ``key``'s draws: ``(*L, *shape)``."""
    return torch.full((*key.shape[:-1], *shape), value, dtype=dtype, device=key.device)


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dim // 2), fp32."""
    half = dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, dh), positions (B, S) -> rotated x (the two halves of
    the head dimension rotate together)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  positions (3, B, S) are the (t, h, w)
    streams; ``sections`` partition the *half* head dimension, and each
    section rotates with its own stream."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to half the head dim {half}")
    cos_parts, sin_parts, off = [], [], 0
    for i, sec in enumerate(sections):
        exponent = torch.arange(off, off + sec, dtype=torch.float32, device=x.device) / half
        freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
        ang = positions[i].float()[..., None] * freqs  # (B, S, sec)
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        off += sec
    cos = torch.cat(cos_parts, dim=-1)[:, :, None, :]
    sin = torch.cat(sin_parts, dim=-1)[:, :, None, :]
    return _rotate(x, cos, sin)


def rotate(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The config's rotary embedding: M-RoPE over (3, B, S) positions when
    it has ``mrope_sections``, else RoPE over (B, S)."""
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def update_slot(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Writes ``new`` (B, s, ...) into ``buf`` (B, Smax, ...) at sequence
    slot ``pos``, in place, and returns ``buf``: the reference's
    ``jax.lax.dynamic_update_slice(buf, new, (0, pos, 0, ...))``, whose start
    index clamps to ``[0, Smax - s]`` (a ``pos`` past the end writes the
    last slot).  ``pos`` is an int or a 0-d tensor; nothing syncs with the
    device.  In-pod, ``buf`` is the rank's slots of the cache
    (:func:`~repro_torch.models.sharding.kv_slots`): only the new entries
    that fall in them are written."""
    s, local = new.shape[1], buf.shape[1]
    first, smax = kv_slots(local)
    start = torch.clamp(torch.as_tensor(pos, device=buf.device), 0, smax - s).to(torch.int64)
    if local == smax:
        return buf.index_copy_(1, start + torch.arange(s, device=buf.device), new.to(buf.dtype))
    for i in range(s):  # one slot at a time: a slot another rank owns keeps its value
        at = start + i - first
        inside = (at >= 0) & (at < local)
        slot = torch.where(inside, at, 0).reshape(1)
        keep = buf.index_select(1, slot)
        buf.index_copy_(1, slot, torch.where(inside, new[:, i:i + 1].to(buf.dtype), keep))
    return buf


def valid_slots(local: int, pos, device) -> torch.Tensor:
    """(local,) bool: the cache slots ``<= pos`` (the unclamped ``pos``) of
    a cache of ``local`` slots (in-pod: the rank's)."""
    first, _ = kv_slots(local)
    return torch.arange(first, first + local, device=device) <= torch.as_tensor(pos,
                                                                              device=device)


# ---------------------------------------------------------------------------
# attention (GQA with optional qk-norm and bias; training and decode paths)
# ---------------------------------------------------------------------------


def init_attention(key: torch.Tensor, cfg: ModelConfig) -> dict:
    """Attention weights (stacked like ``key``), keys in sorted order:
    ``split(key, 4)`` into wq, wk, wv, wo."""
    d, dh, dt = cfg.d_model, cfg.head_dim, dtype_of(cfg)
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    ks = prng.split(key, 4).unbind(-2)
    p = {}
    if cfg.qkv_bias:
        p["bk"] = full(key, (hkv,), 0.0, dt)
        p["bq"] = full(key, (hq,), 0.0, dt)
        p["bv"] = full(key, (hkv,), 0.0, dt)
    if cfg.qk_norm:
        p["k_norm"] = full(key, (dh,), 1.0, dt)
        p["q_norm"] = full(key, (dh,), 1.0, dt)
    p["wk"] = dense_init(ks[1], (d, hkv), dt, d)
    p["wo"] = dense_init(ks[3], (hq, d), dt, hq)
    p["wq"] = dense_init(ks[0], (d, hq), dt, d)
    p["wv"] = dense_init(ks[2], (d, hkv), dt, d)
    return p


def _sdpa_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_offset=0,
                kv_len_mask: Optional[torch.Tensor] = None):
    """Attention's unnormalized parts: (m, l, out) -- the fp32 row max
    (clamped at -1e30 for a row with no valid slot) and probability sum
    (B, Sq, KVH, g), and ``sum p v`` (B, Sq, KVH, g, dh) in the compute
    dtype.  q (B, Sq, H, dh), k/v (B, Sk, KVH, dh).  The S x S chain stays
    in the compute dtype; the row max and row sum run fp32.  ``q_offset``:
    the absolute position of q[0] (decode); ``kv_len_mask``: (B, Sk) bool
    of the valid cache slots (decode)."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
    if kv_len_mask is not None:
        scores = scores.masked_fill(~kv_len_mask[:, None, None, None, :], float("-inf"))
    m = torch.clamp(torch.amax(scores, dim=-1, keepdim=True).float(), min=-1e30)
    p = torch.exp(scores - m.to(scores.dtype))
    l = torch.sum(p, dim=-1, dtype=torch.float32)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return m[..., 0].permute(0, 3, 1, 2), l.permute(0, 3, 1, 2), out


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_offset=0,
          kv_len_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, dh), k/v (B, Sk, KVH, dh) -> (B, Sq, H, dh)
    (:func:`_sdpa_parts`, divided by the clamped row sum in the compute
    dtype)."""
    _, l, out = _sdpa_parts(q, k, v, causal, q_offset, kv_len_mask)
    out = out / torch.clamp(l, min=1e-30)[..., None].to(out.dtype)
    return out.reshape(q.shape)


def _split_kv_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: dict, pos,
                     cfg: ModelConfig):
    """In-pod decode attention over the rank's cache slots: the rank's query
    heads and new K/V gathered whole over ``model``, the new K/V written
    into the slot ``pos`` where the rank owns it, every query head's
    partials over the rank's slots combined over ``model``
    (:func:`~repro_torch.models.sharding.split_kv_combine`); returns the
    rank's own heads' output (B, 1, H / model, dh) and the cache."""
    b, dt = q.shape[0], q.dtype
    first, count = model_heads(cfg.n_heads)
    q, k, v = model_whole_parts([q, k, v], 2)
    ck = update_slot(cache["k"], k, pos)
    cv = update_slot(cache["v"], v, pos)
    valid = valid_slots(ck.shape[1], pos, q.device)[None].expand(b, -1)
    m, l, out = _sdpa_parts(q, ck.to(dt), cv.to(dt), causal=False, kv_len_mask=valid)
    out = split_kv_combine(m, l, out).to(dt).reshape(q.shape)
    return out[:, :, first:first + count], {"k": ck, "v": cv}


def _split_heads(x: torch.Tensor, dh: int) -> torch.Tensor:
    """(B, S, H * dh) -> (B, S, H, dh) (H: the heads this rank holds)."""
    b, s, _ = x.shape
    return x.reshape(b, s, -1, dh)


def apply_attention(p: dict, x: torch.Tensor, positions: Optional[torch.Tensor],
                    cfg: ModelConfig, causal: bool = True, cache: Optional[dict] = None,
                    cache_pos=None, cross_kv=None):
    """One layer's attention with weights ``p``: ``(out, kv)``.

    Train/prefill (``cache=None``): full-sequence attention; ``kv`` is the
    layer's ``{"k", "v"}`` (B, S, KVH, dh) after the norm and the rotary
    embedding, what prefill keeps as the cache (the reference recomputes
    the same values outside its scan).  Decode: ``cache`` is ``{"k", "v"}``
    (B, Smax, KVH, dh); the new K/V are written into it at ``cache_pos``
    in place (:func:`update_slot`), attention runs over the slots
    ``<= cache_pos``, and ``kv`` is that cache.  Cross-attention:
    ``cross_kv`` is the encoder's (k, v) (B, Se, KVH, dh), taken as they
    are (no norm, no rotary, no cache write); ``kv`` holds them.

    In-pod: ``p`` holds the rank's heads (query heads ``m * H / model`` on
    and their KV groups; the qk-norm scales whole); ``out`` is summed over
    ``model``.  A decode's ``cache`` is the rank's slots of every KV head
    (split-KV: :func:`_split_kv_decode`)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    d = cfg.d_model
    x = tp_enter(x)
    if cross_kv is None:
        q, k, v = fsdp_mms(x, [p["wq"], p["wk"], p["wv"]])
    else:
        q = fsdp_mm(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, dh)
    if cross_kv is None:
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = _split_heads(k, dh)
        v = _split_heads(v, dh)
    else:
        k, v = cross_kv
    if "q_norm" in p:  # one scale for every head: the rank applies it to its own
        q = rms_norm(q, tp_enter(p["q_norm"]), cfg.norm_eps)
        if cross_kv is None:
            k = rms_norm(k, tp_enter(p["k_norm"]), cfg.norm_eps)
    if positions is not None and cross_kv is None:
        q = rotate(q, positions, cfg)
        k = rotate(k, positions, cfg)
    q = cs(q, "batch", "seq", "heads", None)
    if cache is not None and cross_kv is None and current_inpod() is not None:
        out, kv = _split_kv_decode(q, k, v, cache, cache_pos, cfg)
    elif cache is not None and cross_kv is None:
        ck = update_slot(cache["k"], k, cache_pos)
        cv = update_slot(cache["v"], v, cache_pos)
        kv = {"k": ck, "v": cv}
        valid = valid_slots(ck.shape[1], cache_pos, x.device)[None].expand(b, -1)
        out = _sdpa(q, ck.to(x.dtype), cv.to(x.dtype), causal=False, kv_len_mask=valid)
    else:
        kv = {"k": k, "v": v}
        out = _sdpa(q, k, v, causal=causal)
    out = out.reshape(b, s, -1)
    return cs(fsdp_out(out, p["wo"], d), "batch", "seq", "dmodel", reduce="model"), kv


# ---------------------------------------------------------------------------
# MLP (SwiGLU; the audio family's plain GELU)
# ---------------------------------------------------------------------------


def init_mlp(key: torch.Tensor, d: int, f: int, dtype, gated: bool = True) -> dict:
    """MLP weights (stacked like ``key``): ``split(key, 3)`` into wi, wo and
    the gate wg."""
    ks = prng.split(key, 3).unbind(-2)
    p = {"wg": dense_init(ks[2], (d, f), dtype, d)} if gated else {}
    p["wi"] = dense_init(ks[0], (d, f), dtype, d)
    p["wo"] = dense_init(ks[1], (f, d), dtype, f)
    return p


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU when ``p`` has ``wg``, else GELU in its tanh form (the
    reference's ``jax.nn.gelu`` default).  In-pod: the ff columns of the
    rank's rows of wo (wi and wg are replicated by the reference's rules:
    the rank takes those columns), the output summed over ``model``."""
    d = x.shape[-1]
    x = tp_enter(x)
    width = p["wo"].shape[0]  # the rank's ff rows of wo
    gated = "wg" in p
    hs = fsdp_mms(x, [model_columns(p["wi"], width)]
                  + ([model_columns(p["wg"], width)] if gated else []))
    h = F.silu(hs[1]) * hs[0] if gated else F.gelu(hs[0], approximate="tanh")
    h = cs(h, "batch", "seq", "ff")
    return cs(fsdp_out(h, p["wo"], d), "batch", "seq", "dmodel", reduce="model")


# ---------------------------------------------------------------------------
# embedding, head and loss
# ---------------------------------------------------------------------------


def init_embed(key: torch.Tensor, cfg: ModelConfig) -> dict:
    """The embedding from ``key``; an untied head from ``fold_in(key, 1)``."""
    dt = dtype_of(cfg)
    p = {"embed": dense_init(key, (cfg.vocab_size, cfg.d_model), dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(prng.fold_in(key, 1), (cfg.d_model, cfg.vocab_size), dt,
                                  cfg.d_model)
    return p


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The tokens' rows.  In-pod: the rank's vocabulary rows look up the
    tokens they hold, and the rows are summed over ``model``; a table held
    whole over ``model`` (a vocabulary the axis does not divide: its
    sanitized spec) looks up every token on each rank, with no sum."""
    # F.embedding: its backward on the card sums each token's rows in a
    # fixed order (a replayed step is bit-identical)
    table = p["embed"]
    ip = current_inpod()
    if ip is None or ip.vocab_whole:
        return cs(fsdp_rows(table, tokens, cfg.d_model), "batch", "seq", "dmodel")
    local = tokens - ip.vocab_start(table.shape[0])
    inside = (local >= 0) & (local < table.shape[0])
    x = fsdp_rows(table, torch.where(inside, local, 0), cfg.d_model)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return cs(x, "batch", "seq", "dmodel", reduce="model")


def logits_from(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits (in-pod: of the rank's vocabulary rows, whose partial
    gradient of ``x`` is summed over ``model``; every row where the table
    is held whole over ``model``)."""
    ip = current_inpod()
    if ip is None or not ip.vocab_whole:
        x = tp_enter(x)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return cs(fsdp_mm(x, w), "batch", "seq", "vocab")


def _row_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each row's log-sum-exp minus its target logit (fp32; the exp()
    intermediate in the logits dtype)."""
    m = torch.amax(logits.float(), dim=-1)
    p = torch.exp(logits - m[..., None].to(logits.dtype))
    lse = torch.log(torch.sum(p, dim=-1, dtype=torch.float32)) + m
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse - gold.float()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean token cross-entropy.  The exp() intermediate stays in the
    logits dtype; the row max and the probability sum run fp32.  In-pod:
    the mean over the pod's tokens, vocab-parallel unless the tables are
    held whole over ``model``."""
    ip = current_inpod()
    if ip is not None:
        if ip.vocab_whole:
            return _pod_mean(_row_nll(logits, labels), mask, ip)
        return _pod_mean(_vocab_parallel_nll(logits, labels, ip), mask, ip)
    nll = _row_nll(logits, labels)
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _vocab_parallel_nll(logits, labels, ip) -> torch.Tensor:
    """Each row's cross-entropy from the rank's vocabulary rows: the row
    max, the probability sum and the target's logit reduced over
    ``model``."""
    group = ip.group("model")
    m = all_reduce(torch.amax(logits.float(), dim=-1), group, op="max")
    p = torch.exp(logits - m[..., None].to(logits.dtype))
    lse = torch.log(cs(torch.sum(p, dim=-1, dtype=torch.float32), reduce="model")) + m
    local = labels - ip.vocab_start(logits.shape[-1])
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0].float()
    gold = cs(torch.where(inside, gold, torch.zeros_like(gold)), reduce="model")
    return lse - gold


def _pod_mean(nll, mask, ip) -> torch.Tensor:
    """The mean over the pod's tokens: the sum and the count reduced over
    ``data``."""
    if mask is not None:
        count = torch.sum(mask)
        total = torch.sum(nll * mask)
    else:
        count = torch.tensor(float(nll.numel()), device=nll.device)
        total = torch.sum(nll)
    if ip.sizes["data"] > 1:
        count = all_reduce(count, ip.group("data"))
    return batch_sum(total) / torch.clamp(count, min=1.0)


def head_loss_params(params: dict, cfg: ModelConfig) -> dict:
    """The parameter subtree the LM-head stage touches: ``final_norm`` and
    the token matrices the logits read (all of ``tok`` when tied)."""
    tok = params["tok"] if cfg.tie_embeddings else {"lm_head": params["tok"]["lm_head"]}
    return {"final_norm": params["final_norm"], "tok": tok}


def head_loss(p: dict, x: torch.Tensor, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    """Final RMS norm -> (tied) logits -> mean token cross-entropy."""
    hidden = rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = logits_from(p["tok"], hidden, cfg)
    return softmax_cross_entropy(logits, ctx["labels"], ctx.get("mask"))


# ---------------------------------------------------------------------------
# layer stacks (the port's loop over the reference's scanned L axis)
# ---------------------------------------------------------------------------


def unstack_layers(stack: dict) -> list:
    """The stacked tree as one tree a layer (``unbind``: one backward op
    stacks every layer's gradient)."""
    items = [(path, v.unbind(0)) for path, v in tree_util.leaves_in_order(stack)]
    return [tree_util.unflatten((path, parts[i]) for path, parts in items)
            for i in range(len(items[0][1]))]


def run_layers(layer_fn, lps: list, x: torch.Tensor, cfg: ModelConfig, *args) -> torch.Tensor:
    """``x = layer_fn(lp, x, cfg, *args)`` for each layer tree ``lp`` of
    ``lps`` in order; under ``remat_policy`` (and with autograd on) each
    layer is recomputed in the backward pass (``torch.utils.checkpoint``)."""
    remat = remat_policy(cfg) and torch.is_grad_enabled()
    for lp in lps:
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer_fn, lp, x, cfg, *args,
                                                  use_reentrant=False)
        else:
            x = layer_fn(lp, x, cfg, *args)
    return x


def remat_policy(cfg: ModelConfig) -> bool:
    """Whether a layer's activations are recomputed in the backward pass
    (``torch.utils.checkpoint`` per layer).  The reference's ``minimal``
    policy saves the weight products and ``full`` nothing; the port
    recomputes the whole layer for both.  It changes memory, not values."""
    if cfg.remat_policy not in ("none", "minimal", "full"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return cfg.remat_policy != "none"
