"""Decoder-only transformer family: dense GQA, MoE, MLA with multi-token
prediction, and the VLM backbone (M-RoPE over patch-embedding prefixes);
training and serving (port of ``repro.models.transformer``).

Layers are *stacked* on a leading L axis, as in the reference, so the
parameter tree -- and with it the FedQCS block layout and the checkpoint
entries -- is the reference's leaf for leaf: ``layers`` (``attn``, ``ffn``,
``ln1``, ``ln2``), for DeepSeek-V3 also ``layers_dense`` (its first dense
layers) and the unstacked ``mtp`` block.  The reference scans that axis;
the port loops over it, recomputing each layer in the backward pass when
the config's ``remat_policy`` asks for it (``torch.utils.checkpoint``).

Serving: :func:`init_cache` (a GQA cache ``k``/``v`` (L, B, Smax, KVH, dh)
or an MLA latent cache ``ckv``/``kr`` (L, B, Smax, *)), :func:`prefill`
(last-position logits and the cache of the prompt, taken from each
layer's forward pass) and :func:`decode_step` (one token; the new K/V or
latents written at ``pos``).  On an in-pod mesh both run on the rank's
cache shard: its ``data`` share of the batch, its ``model`` share of the
slots (split-KV decode).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import entry_device, prng
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    apply_attention,
    apply_mlp,
    dense_init,
    dtype_of,
    embed_tokens,
    full,
    init_attention,
    init_embed,
    init_key,
    init_mlp,
    logits_from,
    rms_norm,
    run_layers,
    softmax_cross_entropy,
    unstack_layers,
)
from repro_torch.models.mla import apply_mla_decode, init_mla, mla_train
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.sharding import prompt_slots


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layers(key: torch.Tensor, cfg: ModelConfig, moe: bool) -> dict:
    """One layer's tree per key of ``key`` (``(L, 2)``: each leaf stacked on
    L): ``split(key)`` into the attention and the FFN."""
    dt, d = dtype_of(cfg), cfg.d_model
    k1, k2 = prng.split(key).unbind(-2)
    return {
        "attn": init_mla(k1, cfg) if cfg.use_mla else init_attention(k1, cfg),
        "ffn": init_moe(k2, cfg) if moe else init_mlp(k2, d, cfg.d_ff, dt),
        "ln1": full(key, (d,), 1.0, dt),
        "ln2": full(key, (d,), 1.0, dt),
    }


def init_params(cfg: ModelConfig, seed=0, device="cuda") -> Dict[str, Any]:
    """The reference's tree -- ``final_norm``, ``layers`` (each leaf stacked
    on L), ``layers_dense`` and ``mtp`` where the config has them, and
    ``tok`` -- drawn on ``device`` from ``PRNGKey(seed)`` (or the key
    ``seed``) along the reference's key tree: ``split(key, 4)`` into the
    embedding, the dense and the main stacks' layer keys and MTP's.  Keys
    are inserted in sorted order at every level (the reference's leaf
    order).  ``device="meta"`` gives the shapes and dtypes and allocates
    nothing."""
    key = init_key(seed, entry_device(device))
    ks = prng.split(key, 4).unbind(-2)
    dt, d = dtype_of(cfg), cfg.d_model
    n_dense = cfg.first_dense_layers if cfg.is_moe else 0  # ``layers_dense``
    params = {"final_norm": full(key, (d,), 1.0, dt),
              "layers": _init_layers(prng.split(ks[2], cfg.n_layers - n_dense), cfg,
                                     moe=cfg.is_moe)}
    if n_dense:
        params["layers_dense"] = _init_layers(prng.split(ks[1], n_dense), cfg, moe=False)
    if cfg.mtp:
        km1, km2 = prng.split(ks[3]).unbind(-2)
        params["mtp"] = {"layer": _init_layers(km2, cfg, moe=False),
                         "norm": full(key, (d,), 1.0, dt),
                         "proj": dense_init(km1, (2 * d, d), dt, 2 * d)}
    params["tok"] = init_embed(ks[0], cfg)
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _layer_fwd(lp: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               moe: bool):
    """One layer: ``(x, kv)``, ``kv`` the layer's K/V or MLA latents (what
    prefill keeps as its cache)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        attn_out, kv = mla_train(lp["attn"], h, positions, cfg)
    else:
        attn_out, kv = apply_attention(lp["attn"], h, positions, cfg, causal=True)
    x = x + attn_out
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + (apply_moe(lp["ffn"], h, cfg) if moe else apply_mlp(lp["ffn"], h)), kv


def _layer_out(lp, x, cfg, positions, moe):
    return _layer_fwd(lp, x, positions, cfg, moe)[0]


def _run_stack(stack: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               moe: bool, on_kv=None):
    """The stack's layers in order; with ``on_kv``, each layer's K/V (or
    latents) is passed to it."""
    if on_kv is None:
        return run_layers(_layer_out, unstack_layers(stack), x, cfg, positions, moe)
    for lp in unstack_layers(stack):
        x, kv = _layer_fwd(lp, x, positions, cfg, moe)
        on_kv(kv)
    return x


def _stacks(params: dict, cfg: ModelConfig):
    """(stack, moe?) in execution order: ``layers_dense`` first."""
    out = [(params["layers_dense"], False)] if "layers_dense" in params else []
    return out + [(params["layers"], cfg.is_moe)]


def forward_hidden(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    for stack, moe in _stacks(params, cfg):
        x = _run_stack(stack, x, positions, cfg, moe)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


# -- train stages (the reference's stage protocol) ---------------------------


def _positions(batch: dict, cfg: ModelConfig, b: int, s: int, device) -> torch.Tensor:
    """The VLM's (3, B, Sv + S) M-RoPE streams from the batch, else 0..S-1."""
    if cfg.family == "vlm":
        return batch["positions"]
    return torch.arange(s, device=device)[None].expand(b, s)


def train_ctx(batch: dict, cfg: ModelConfig) -> dict:
    """Stage context: tokens, labels (+ mask), positions (+ the VLM's
    patches)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    ctx = {"tokens": tokens, "labels": batch["labels"]}
    if "mask" in batch:
        ctx["mask"] = batch["mask"]
    if cfg.family == "vlm":
        ctx["patches"] = batch["patches"]
    ctx["positions"] = _positions(batch, cfg, b, s, tokens.device)
    return ctx


def embed_stage(sp: dict, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    """Token embedding (+ the VLM's patch prefix).  sp = {"embed": ...}."""
    x = embed_tokens(sp, ctx["tokens"], cfg)
    if cfg.family == "vlm":
        x = torch.cat([ctx["patches"].to(x.dtype), x], dim=1)
    return x


def stack_stage(stack: dict, x: torch.Tensor, ctx: dict, cfg: ModelConfig,
                moe: bool = False) -> torch.Tensor:
    """One stacked layer run (``moe``: its FFNs are MoE)."""
    return _run_stack(stack, x, ctx["positions"], cfg, moe)


def head_params(params: dict, cfg: ModelConfig) -> dict:
    """The head stage's subtree: ``final_norm``, the token matrices the
    logits read (all of ``tok`` when tied or under MTP, which re-embeds the
    shifted tokens; else ``lm_head``) and the MTP block."""
    tok = params["tok"] if (cfg.tie_embeddings or cfg.mtp) else {
        "lm_head": params["tok"]["lm_head"]}
    hp = {"final_norm": params["final_norm"], "tok": tok}
    if cfg.mtp:
        hp["mtp"] = params["mtp"]
    return hp


def head_stage(hp: dict, x: torch.Tensor, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    """Final norm -> (VLM: the text positions) -> logits -> cross-entropy
    (+ 0.3 x the MTP loss)."""
    hidden = rms_norm(x, hp["final_norm"], cfg.norm_eps)
    if cfg.family == "vlm":
        hidden = hidden[:, -ctx["tokens"].shape[1]:]
    loss = softmax_cross_entropy(logits_from(hp["tok"], hidden, cfg), ctx["labels"],
                                 ctx.get("mask"))
    if cfg.mtp:
        loss = loss + 0.3 * _mtp_loss(hp, hidden, ctx["tokens"], ctx["labels"],
                                      ctx["positions"], cfg)
    return loss


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    ctx = train_ctx(batch, cfg)
    x = embed_stage({"embed": params["tok"]["embed"]}, ctx, cfg)
    for stack, moe in _stacks(params, cfg):
        x = stack_stage(stack, x, ctx, cfg, moe)
    return head_stage(head_params(params, cfg), x, ctx, cfg)


def _mtp_loss(hp: dict, hidden, tokens, labels, positions, cfg: ModelConfig):
    """DeepSeek-V3's multi-token prediction: at position t, h_t (normed) and
    emb(token_{t+1}) through ``proj`` and one more layer predict
    token_{t+2}."""
    mp = hp["mtp"]
    emb_next = embed_tokens(hp["tok"], tokens, cfg)[:, 1:]
    x = torch.cat([rms_norm(hidden[:, :-1], mp["norm"], cfg.norm_eps), emb_next], dim=-1)
    x = _layer_out(mp["layer"], x @ mp["proj"], cfg, positions[..., :-1], False)
    return softmax_cross_entropy(logits_from(hp["tok"], x, cfg), labels[:, 1:])


# ---------------------------------------------------------------------------
# serving: cache, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, smax: int, device="cuda") -> dict:
    """Zeros in the config dtype: ``ckv`` (L, B, Smax, r) and ``kr`` (L, B,
    Smax, rope) under MLA, else ``k`` and ``v`` (L, B, Smax, KVH, dh);
    ``device="meta"`` allocates nothing."""
    dev = entry_device(device)
    dt, L = dtype_of(cfg), cfg.n_layers
    if cfg.use_mla:
        shapes = {"ckv": (L, batch, smax, cfg.kv_lora_rank),
                  "kr": (L, batch, smax, cfg.qk_rope_head_dim)}
    else:
        shapes = {k: (L, batch, smax, cfg.n_kv_heads, cfg.head_dim) for k in ("k", "v")}
    return {k: torch.zeros(shape, dtype=dt, device=dev) for k, shape in shapes.items()}


def _layer_decode(lp: dict, x: torch.Tensor, positions, cfg: ModelConfig, layer_cache: dict,
                  pos, moe: bool) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        attn_out, _ = apply_mla_decode(lp["attn"], h, positions, cfg, layer_cache, pos)
    else:
        attn_out, _ = apply_attention(lp["attn"], h, positions, cfg, causal=False,
                                      cache=layer_cache, cache_pos=pos)
    x = x + attn_out
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + (apply_moe(lp["ffn"], h, cfg) if moe else apply_mlp(lp["ffn"], h))


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                inplace: bool = False):
    """One-token decode: tokens (B, 1), ``pos`` the next write slot (an int
    or a 0-d tensor).  Returns (logits (B, 1, V), the cache with every
    layer's new K/V or latents at ``pos``).  ``inplace=True`` writes into
    ``cache`` itself (the serve step's donation); else a copy is written
    and ``cache`` is left as it was.  In-pod: the rank's cache shard, the
    tokens of its rows, the logits of its vocabulary columns."""
    if not inplace:
        cache = tree_util.tree_map(torch.clone, cache)
    b = tokens.shape[0]
    x = embed_tokens(params["tok"], tokens, cfg)
    pos_t = torch.as_tensor(pos, device=tokens.device)
    lead = (3, b, 1) if cfg.mrope_sections is not None else (b, 1)
    positions = pos_t.reshape((1,) * len(lead)).expand(lead)
    layer = 0
    for stack, moe in _stacks(params, cfg):
        for lp in unstack_layers(stack):
            x = _layer_decode(lp, x, positions, cfg, {k: v[layer] for k, v in cache.items()},
                              pos_t, moe)
            layer += 1
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from(params["tok"], hidden, cfg), cache


def prefill(params: dict, batch: dict, cfg: ModelConfig, smax: Optional[int] = None):
    """Full-sequence prefill: (last-position logits (B, 1, V), the cache
    of the whole input -- (L, B, Smax, ...) K/V or latents, the prompt's
    slots (VLM: patches + text) then zeros; ``smax`` None: the prompt's
    length).  In-pod (the serve step's batch over ``(pod, data)``) each
    layer's K/V go straight into the rank's cache shard
    (:func:`~repro_torch.models.sharding.prompt_slots`: batch over
    ``data``, slots over ``model``), and the logits are the rank's rows
    and vocabulary columns."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params["tok"], tokens, cfg)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    positions = _positions(batch, cfg, b, s, tokens.device)

    kvs = []

    def keep(kv):  # the layer's cache entry, as soon as it is made
        kvs.append({k: prompt_slots(v, smax, cfg.n_kv_heads if v.dim() == 4 else None)
                    for k, v in kv.items()})

    for stack, moe in _stacks(params, cfg):
        x = _run_stack(stack, x, positions, cfg, moe, keep)
    cache = {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]}
    del kvs
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from(params["tok"], hidden[:, -1:], cfg), cache
