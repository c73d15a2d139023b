"""Zamba2-style hybrid: a Mamba-2 backbone with one weight-SHARED attention
block run after every ``attn_every`` SSM layers (the Zamba trick: one set
of transformer weights amortized over the depth); port of
``repro.models.hybrid``.

The tree is ``final_norm``, ``mamba_layers`` (stacked on L), ``shared``
(``attn``, ``ln1``, ``ln2``, ``mlp``: one tree, used after each of the
``n_layers / attn_every`` groups, so its gradient sums over the groups)
and ``tok``.  The serve cache is ``{"mamba": {"conv", "ssm"}`` (L, ...),
``"attn": {"k", "v"}`` (groups, B, Smax, KVH, dh)}: one K/V cache a shared
block invocation.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import entry_device, prng
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    apply_attention,
    apply_mlp,
    dtype_of,
    embed_tokens,
    full,
    head_loss,
    head_loss_params,
    init_attention,
    init_embed,
    init_key,
    init_mlp,
    logits_from,
    rms_norm,
    run_layers,
    unstack_layers,
)
from repro_torch.models.ssm_lm import decode_layers, mamba_block, stack_caches


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of attn_every "
                         f"{cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def init_params(cfg: ModelConfig, seed=0, device="cuda") -> Dict[str, Any]:
    """The reference's tree, drawn on ``device`` from ``PRNGKey(seed)`` (or
    the key ``seed``): ``split(key, 5)`` into the Mamba layer keys, the
    embedding's and the shared block's attention and MLP (``"meta"``: shapes
    and dtypes only)."""
    key = init_key(seed, entry_device(device))
    ks = prng.split(key, 5).unbind(-2)
    dt, d = dtype_of(cfg), cfg.d_model
    shared = {"attn": init_attention(ks[2], cfg), "ln1": full(key, (d,), 1.0, dt),
              "ln2": full(key, (d,), 1.0, dt), "mlp": init_mlp(ks[3], d, cfg.d_ff, dt)}
    return {"final_norm": full(key, (d,), 1.0, dt),
            "mamba_layers": ssm_mod.init_mamba(prng.split(ks[0], cfg.n_layers), cfg),
            "shared": shared, "tok": init_embed(ks[1], cfg)}


def _groups(stack: dict, cfg: ModelConfig) -> list:
    """The stacked Mamba layers as ``n_layers / attn_every`` lists of layer
    trees."""
    lps, per = unstack_layers(stack), cfg.attn_every
    return [lps[g * per:(g + 1) * per] for g in range(_n_groups(cfg))]


def _shared_block(sp: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                  cache=None, cache_pos=None):
    """(x, kv): the shared attention block (``kv`` its K/V, or the decode
    cache written at ``cache_pos``)."""
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    attn_out, kv = apply_attention(sp["attn"], h, positions, cfg, causal=cache is None,
                                   cache=cache, cache_pos=cache_pos)
    x = x + attn_out
    h = rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + apply_mlp(sp["mlp"], h), kv


def _shared_out(sp: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> torch.Tensor:
    return _shared_block(sp, x, positions, cfg)[0]


# -- train stages (the reference's stage protocol) ---------------------------
#
# The shared attention block is weight-tied across every group, so the
# whole nested run is ONE stage.


def train_ctx(batch: dict, cfg: ModelConfig) -> dict:
    tokens = batch["tokens"]
    b, s = tokens.shape
    ctx = {"tokens": tokens, "labels": batch["labels"],
           "positions": torch.arange(s, device=tokens.device)[None].expand(b, s)}
    if "mask" in batch:
        ctx["mask"] = batch["mask"]
    return ctx


def embed_stage(sp: dict, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    return embed_tokens(sp, ctx["tokens"], cfg)


def stack_stage(sp: dict, x: torch.Tensor, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    """The full nested run.  sp = {"mamba_layers", "shared"}, never a slice
    (the shared block is used by every group).  Under ``remat_policy`` each
    Mamba layer and each shared block run is recomputed in the backward
    pass."""
    for lps in _groups(sp["mamba_layers"], cfg):
        x = run_layers(mamba_block, lps, x, cfg)
        x = run_layers(_shared_out, [sp["shared"]], x, cfg, ctx["positions"])
    return x


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    ctx = train_ctx(batch, cfg)
    x = embed_stage({"embed": params["tok"]["embed"]}, ctx, cfg)
    x = stack_stage({"mamba_layers": params["mamba_layers"], "shared": params["shared"]},
                    x, ctx, cfg)
    return head_loss(head_loss_params(params, cfg), x, ctx, cfg)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """Full-sequence prefill: (last-position logits (B, 1, V), the cache: the
    SSD final state and conv window of every Mamba layer, and the K/V of
    every shared block invocation, as its attention computed them)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = embed_tokens(params["tok"], tokens, cfg)
    mcaches, kvs = [], []
    for lps in _groups(params["mamba_layers"], cfg):
        for lp in lps:
            out, lc = ssm_mod.apply_mamba_prefill(lp, x, cfg)
            x = x + out
            mcaches.append(lc)
        x, kv = _shared_block(params["shared"], x, positions, cfg)
        kvs.append(kv)
    cache = {"mamba": stack_caches(mcaches), "attn": stack_caches(kvs)}
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from(params["tok"], hidden[:, -1:], cfg), cache


def init_cache(cfg: ModelConfig, batch: int, smax: int, device="cuda") -> dict:
    """Zeros: the Mamba states (L, ...) and the shared block's K/V (groups,
    B, Smax, KVH, dh) in the config dtype."""
    dev = entry_device(device)
    dt = dtype_of(cfg)
    shape = (_n_groups(cfg), batch, smax, cfg.n_kv_heads, cfg.head_dim)
    return {"mamba": ssm_mod.init_mamba_cache(cfg, batch, dt, cfg.n_layers, dev),
            "attn": {k: torch.zeros(shape, dtype=dt, device=dev) for k in ("k", "v")}}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                inplace: bool = False):
    """One-token decode at ``pos`` (an int or a 0-d tensor).  Returns
    (logits (B, 1, V), the cache: every Mamba layer's new state, and each
    shared block invocation's K/V written at ``pos``).  ``inplace=True``
    writes into ``cache`` itself; else into a copy."""
    if not inplace:
        cache = tree_util.tree_map(torch.clone, cache)
    b = tokens.shape[0]
    x = embed_tokens(params["tok"], tokens, cfg)
    pos_t = torch.as_tensor(pos, device=tokens.device)
    positions = pos_t.reshape(1, 1).expand(b, 1)
    for g, lps in enumerate(_groups(params["mamba_layers"], cfg)):
        x = decode_layers(lps, x, cfg, cache["mamba"], first=g * cfg.attn_every)
        x, _ = _shared_block(params["shared"], x, positions, cfg,
                             cache={k: v[g] for k, v in cache["attn"].items()},
                             cache_pos=pos_t)
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from(params["tok"], hidden, cfg), cache
