"""The pure Mamba-2 language model: attention-free, SSD blocks only (port of
``repro.models.ssm_lm``).

The tree is ``final_norm``, ``layers`` (each Mamba-2 leaf stacked on L) and
``tok``.  Layers run as a loop over the stack, each recomputed in the
backward pass when the config's ``remat_policy`` asks for it.  The serve
cache is ``{"conv", "ssm"}`` stacked on L, O(1) in the sequence length.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import entry_device, prng
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    dtype_of,
    embed_tokens,
    full,
    head_loss,
    head_loss_params,
    init_embed,
    init_key,
    logits_from,
    rms_norm,
    run_layers,
    unstack_layers,
)


def init_params(cfg: ModelConfig, seed=0, device="cuda") -> Dict[str, Any]:
    """The reference's tree, drawn on ``device`` from ``PRNGKey(seed)`` (or
    the key ``seed``): ``split(key, 2)`` into the layer keys and the
    embedding's (``"meta"``: shapes and dtypes only)."""
    key = init_key(seed, entry_device(device))
    ks = prng.split(key, 2).unbind(-2)
    return {"final_norm": full(key, (cfg.d_model,), 1.0, dtype_of(cfg)),
            "layers": ssm_mod.init_mamba(prng.split(ks[0], cfg.n_layers), cfg),
            "tok": init_embed(ks[1], cfg)}


def mamba_block(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One residual Mamba-2 block."""
    return x + ssm_mod.apply_mamba_train(lp, x, cfg)


# -- train stages (the reference's stage protocol) ---------------------------


def train_ctx(batch: dict, cfg: ModelConfig) -> dict:
    ctx = {"tokens": batch["tokens"], "labels": batch["labels"]}
    if "mask" in batch:
        ctx["mask"] = batch["mask"]
    return ctx


def embed_stage(sp: dict, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    return embed_tokens(sp, ctx["tokens"], cfg)


def stack_stage(layers: dict, x: torch.Tensor, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    """One (chunk of the) stacked Mamba run: ``layers`` is an (L', ...) slice."""
    return run_layers(mamba_block, unstack_layers(layers), x, cfg)


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    ctx = train_ctx(batch, cfg)
    x = embed_stage({"embed": params["tok"]["embed"]}, ctx, cfg)
    x = stack_stage(params["layers"], x, ctx, cfg)
    return head_loss(head_loss_params(params, cfg), x, ctx, cfg)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def stack_caches(caches: list) -> dict:
    """Per-layer ``{"conv", "ssm"}`` caches stacked on a leading L axis."""
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def prefill(params: dict, batch: dict, cfg: ModelConfig):
    """Full-sequence prefill: (last-position logits (B, 1, V), the per-layer
    state cache)."""
    x = embed_tokens(params["tok"], batch["tokens"], cfg)
    caches = []
    for lp in unstack_layers(params["layers"]):
        out, lc = ssm_mod.apply_mamba_prefill(lp, x, cfg)
        x = x + out
        caches.append(lc)
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from(params["tok"], hidden[:, -1:], cfg), stack_caches(caches)


def init_cache(cfg: ModelConfig, batch: int, smax: int, device="cuda") -> dict:
    """Zeros; ``smax`` is unused: the state is O(1) in the sequence length
    (the point of SSMs)."""
    del smax
    return ssm_mod.init_mamba_cache(cfg, batch, dtype_of(cfg), cfg.n_layers,
                                    entry_device(device))


def decode_layers(lps: list, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                  first: int = 0) -> torch.Tensor:
    """One token through the layer trees ``lps``; layer i's new state is
    written into ``cache``'s row ``first + i`` in place."""
    for i, lp in enumerate(lps):
        layer = {k: v[first + i] for k, v in cache.items()}
        out, new = ssm_mod.apply_mamba_decode(lp, x, cfg, layer)
        for k, v in new.items():
            layer[k].copy_(v)
        x = x + out
    return x


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                inplace: bool = False):
    """One-token decode (``pos`` is unused: the state carries the history).
    Returns (logits (B, 1, V), the cache with every layer's new state).
    ``inplace=True`` writes the new states into ``cache`` itself (the serve
    step's donation); else into a copy, and ``cache`` is left as it was."""
    del pos
    if not inplace:
        cache = tree_util.tree_map(torch.clone, cache)
    x = embed_tokens(params["tok"], tokens, cfg)
    x = decode_layers(unstack_layers(params["layers"]), x, cfg, cache)
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from(params["tok"], hidden, cfg), cache
