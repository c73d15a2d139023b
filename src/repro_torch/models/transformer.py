"""Decoder-only transformer, the dense GQA family (port of
``repro.models.transformer``).

Layers are *stacked* on a leading L axis, as in the reference, so the
parameter tree -- and with it the FedQCS block layout and the checkpoint
entries -- is the reference's leaf for leaf.  The reference scans that
axis; the port loops over it, recomputing each layer in the backward pass
when the config's ``remat_policy`` asks for it (``torch.utils.checkpoint``).

MoE, MLA, multi-token prediction and the VLM inputs, and the serve steps
(``init_cache``, ``prefill``, ``decode_step``), raise: ROADMAP.md item 11.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch import entry_device, not_in_slice
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    apply_attention,
    apply_mlp,
    dtype_of,
    embed_tokens,
    head_loss,
    head_loss_params,
    init_attention,
    init_embed,
    init_mlp,
    remat_policy,
    rms_norm,
)


def check_dense(cfg: ModelConfig) -> None:
    """Raises for the parts of the family that are not ported."""
    for flag, what in ((cfg.family != "dense", f"the {cfg.family!r} model family"),
                       (cfg.is_moe, "mixture-of-experts layers"),
                       (cfg.use_mla, "multi-head latent attention"),
                       (cfg.mtp, "multi-token prediction"),
                       (cfg.mrope_sections is not None, "M-RoPE")):
        if flag:
            raise not_in_slice(f"{what} ({cfg.name})", "item 11")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """The reference's tree -- ``final_norm``, ``layers`` (``attn``, ``ffn``,
    ``ln1``, ``ln2``, each stacked on L) and ``tok`` -- drawn on the CPU from
    a generator seeded with ``seed`` and moved to ``device``.  Keys are
    inserted in sorted order at every level (the reference's leaf order).
    ``device="meta"`` gives the shapes and dtypes and allocates nothing."""
    check_dense(cfg)
    device = entry_device(device)
    meta = device.type == "meta"
    gen = None if meta else torch.Generator().manual_seed(int(seed))
    dt, L, d = dtype_of(cfg), cfg.n_layers, cfg.d_model
    tok = init_embed(gen, cfg)
    layers = {
        "attn": init_attention(gen, cfg, L),
        "ffn": init_mlp(gen, d, cfg.d_ff, dt, L),
        "ln1": torch.ones((L, d), dtype=dt),
        "ln2": torch.ones((L, d), dtype=dt),
    }
    params = {"final_norm": torch.ones((d,), dtype=dt), "layers": layers, "tok": tok}
    return _to(params, device)


def _to(tree, device):
    return tree_util.tree_map(lambda v: v.to(device), tree)


# ---------------------------------------------------------------------------
# forward (train)
# ---------------------------------------------------------------------------


def _layer_fwd(lp: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + apply_attention(lp["attn"], h, positions, cfg, causal=True)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + apply_mlp(lp["ffn"], h)


def _unstack(stack: dict):
    """The stacked tree as one tree a layer (``unbind``: one backward op
    stacks every layer's gradient)."""
    items = [(path, v.unbind(0)) for path, v in tree_util.leaves_in_order(stack)]
    return [tree_util.unflatten((path, parts[i]) for path, parts in items)
            for i in range(len(items[0][1]))]


def _run_stack(stack: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    remat = remat_policy(cfg)
    for lp in _unstack(stack):
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(_layer_fwd, lp, x, positions, cfg,
                                                  use_reentrant=False)
        else:
            x = _layer_fwd(lp, x, positions, cfg)
    return x


def forward_hidden(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    x = _run_stack(params["layers"], x, positions, cfg)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


# -- train stages (the reference's stage protocol) ---------------------------


def train_ctx(batch: dict, cfg: ModelConfig) -> dict:
    """Stage context: tokens, labels (+ mask), positions."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    ctx = {"tokens": tokens, "labels": batch["labels"]}
    if "mask" in batch:
        ctx["mask"] = batch["mask"]
    ctx["positions"] = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return ctx


def embed_stage(sp: dict, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    return embed_tokens(sp, ctx["tokens"], cfg)


def stack_stage(stack: dict, x: torch.Tensor, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    return _run_stack(stack, x, ctx["positions"], cfg)


def head_params(params: dict, cfg: ModelConfig) -> dict:
    return head_loss_params(params, cfg)


def head_stage(hp: dict, x: torch.Tensor, ctx: dict, cfg: ModelConfig) -> torch.Tensor:
    return head_loss(hp, x, ctx, cfg)


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    check_dense(cfg)
    ctx = train_ctx(batch, cfg)
    x = embed_stage({"embed": params["tok"]["embed"]}, ctx, cfg)
    x = stack_stage(params["layers"], x, ctx, cfg)
    return head_stage(head_params(params, cfg), x, ctx, cfg)


# ---------------------------------------------------------------------------
# serving: item 11
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, smax: int):
    raise not_in_slice("the transformer's KV cache (init_cache)", "item 11")


def prefill(params, batch, cfg: ModelConfig):
    raise not_in_slice("the transformer's prefill step", "item 11")


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    raise not_in_slice("the transformer's decode step", "item 11")
