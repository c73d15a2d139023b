"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The conv frontend is a stub, as in the reference: the model takes
pre-computed frame embeddings (B, S_frames, d_model) directly.  Sinusoidal
absolute positions, bidirectional encoder self-attention, causal decoder
self-attention plus cross-attention over the encoder's output, GELU MLPs.

The tree is ``dec_layers`` (``cross_attn``, ``ln1``, ``ln2``, ``ln_x``,
``mlp``, ``self_attn``; stacked on L), ``enc_layers`` (``attn``, ``ln1``,
``ln2``, ``mlp``; stacked), ``enc_norm``, ``final_norm`` and ``tok``.  The
serve cache is the decoder's self-attention ``k``/``v`` (L, B, Smax, KVH,
dh) and the cross K/V ``cross_k``/``cross_v`` (L, B, S_enc, KVH, dh) that
prefill computes once from the encoder's output.

On an in-pod mesh the layers are ``models/common.py``'s: attention on the
rank's heads (the cross-attention's K/V too, from its wk/wv columns), the
GELU MLP column-parallel (``mlp/wi``) and row-parallel (``mlp/wo``), the
norms replicated; the frames are split over (pod, data) with the tokens.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import entry_device, prng
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    apply_attention,
    apply_mlp,
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
from repro_torch.models.sharding import fsdp, tp_enter


def _angles(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(..., 1) fp32 positions -> (..., d) [sin | cos] of pos / 10000^(2i/d)."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos / torch.pow(torch.tensor(10000.0, dtype=torch.float32), 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid(s: int, d: int, dtype, device="cpu") -> torch.Tensor:
    """(s, d) sinusoidal positions 0..s-1 in ``dtype``."""
    return _angles(torch.arange(s, dtype=torch.float32, device=device)[:, None], d).to(dtype)


def _init_enc_layer(key: torch.Tensor, cfg: ModelConfig) -> dict:
    dt, d = dtype_of(cfg), cfg.d_model
    k1, k2 = prng.split(key).unbind(-2)
    return {
        "attn": init_attention(k1, cfg),
        "ln1": full(key, (d,), 1.0, dt),
        "ln2": full(key, (d,), 1.0, dt),
        "mlp": init_mlp(k2, d, cfg.d_ff, dt, gated=False),
    }


def _init_dec_layer(key: torch.Tensor, cfg: ModelConfig) -> dict:
    dt, d = dtype_of(cfg), cfg.d_model
    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    return {
        "cross_attn": init_attention(k2, cfg),
        "ln1": full(key, (d,), 1.0, dt),
        "ln2": full(key, (d,), 1.0, dt),
        "ln_x": full(key, (d,), 1.0, dt),
        "mlp": init_mlp(k3, d, cfg.d_ff, dt, gated=False),
        "self_attn": init_attention(k1, cfg),
    }


def init_params(cfg: ModelConfig, seed=0, device="cuda") -> Dict[str, Any]:
    """The reference's tree, drawn on ``device`` from ``PRNGKey(seed)`` (or
    the key ``seed``): ``split(key, 3)`` into the encoder and decoder layer
    keys and the embedding's (``"meta"``: shapes and dtypes only)."""
    key = init_key(seed, entry_device(device))
    ks = prng.split(key, 3).unbind(-2)
    d = cfg.d_model
    return {"dec_layers": _init_dec_layer(prng.split(ks[1], cfg.n_layers), cfg),
            "enc_layers": _init_enc_layer(prng.split(ks[0], cfg.n_encoder_layers), cfg),
            "enc_norm": full(key, (d,), 1.0, dtype_of(cfg)),
            "final_norm": full(key, (d,), 1.0, dtype_of(cfg)),
            "tok": init_embed(ks[2], cfg)}


def _enc_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + apply_attention(lp["attn"], h, None, cfg, causal=False)[0]
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + apply_mlp(lp["mlp"], h)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    _, s, d = frames.shape
    dt = dtype_of(cfg)
    x = frames.to(dt) + _sinusoid(s, d, dt, frames.device)[None]
    x = run_layers(_enc_layer, unstack_layers(params["enc_layers"]), x, cfg)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(lp: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross-attention's K/V (B, S_enc, KVH, dh) of the encoder's output
    (in-pod: the rank's KV heads; the output enters the tensor-parallel
    region, its gradient summed over ``model``)."""
    b, s, d = enc_out.shape
    dh = cfg.head_dim
    enc_out = tp_enter(enc_out)
    k = (enc_out @ fsdp(lp["cross_attn"]["wk"], 0, d)).reshape(b, s, -1, dh)
    v = (enc_out @ fsdp(lp["cross_attn"]["wv"], 0, d)).reshape(b, s, -1, dh)
    return k, v


def _dec_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig, enc_out: torch.Tensor):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + apply_attention(lp["self_attn"], h, None, cfg, causal=True)[0]
    h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
    x = x + apply_attention(lp["cross_attn"], h, None, cfg, causal=False,
                            cross_kv=_cross_kv(lp, enc_out, cfg))[0]
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + apply_mlp(lp["mlp"], h)


def _decoder(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    s = tokens.shape[1]
    x = embed_tokens(params["tok"], tokens, cfg)
    x = x + _sinusoid(s, cfg.d_model, x.dtype, x.device)[None]
    x = run_layers(_dec_layer, unstack_layers(params["dec_layers"]), x, cfg, enc_out)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def train_loss(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    enc_out = encode(params, batch["frames"], cfg)
    hidden = _decoder(params, batch["tokens"], enc_out, cfg)
    logits = logits_from(params["tok"], hidden, cfg)
    return softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, smax: int, device="cuda",
               enc_len: int = 1500) -> dict:
    """Zeros in the config dtype: the decoder's self-attention ``k``/``v``
    (L, B, Smax, KVH, dh) and the cross ``cross_k``/``cross_v`` (L, B,
    enc_len, KVH, dh) that prefill fills."""
    dev = entry_device(device)
    dt, L, kvh, dh = dtype_of(cfg), cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    self_shape, cross_shape = (L, batch, smax, kvh, dh), (L, batch, enc_len, kvh, dh)
    return {"k": torch.zeros(self_shape, dtype=dt, device=dev),
            "v": torch.zeros(self_shape, dtype=dt, device=dev),
            "cross_k": torch.zeros(cross_shape, dtype=dt, device=dev),
            "cross_v": torch.zeros(cross_shape, dtype=dt, device=dev)}


def prefill(params: dict, batch: dict, cfg: ModelConfig, smax: int):
    """The encoder pass fills every layer's cross K/V; then a BOS token (id
    0) is decoded at position 0 into an empty self-attention cache of
    ``smax`` slots.  Returns (the BOS step's logits (B, 1, V), the cache)."""
    enc_out = encode(params, batch["frames"], cfg)
    b = enc_out.shape[0]
    cache = init_cache(cfg, b, smax, enc_out.device, enc_len=enc_out.shape[1])
    for i, lp in enumerate(unstack_layers(params["dec_layers"])):
        k, v = _cross_kv(lp, enc_out, cfg)
        cache["cross_k"][i].copy_(k)
        cache["cross_v"][i].copy_(v)
    del enc_out
    bos = torch.zeros((b, 1), dtype=torch.int64, device=cache["k"].device)
    return decode_step(params, cache, bos, 0, cfg, inplace=True)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                inplace: bool = False):
    """One-token decode at ``pos`` (an int or a 0-d tensor): the sinusoid at
    ``pos``; self-attention over the slots ``<= pos`` with the new K/V
    written at ``pos``; cross-attention over the cached encoder K/V.
    Returns (logits (B, 1, V), the cache); ``inplace=True`` writes into
    ``cache`` itself, else into a copy."""
    if not inplace:
        cache = tree_util.tree_map(torch.clone, cache)
    x = embed_tokens(params["tok"], tokens, cfg)
    pos_t = torch.as_tensor(pos, device=tokens.device)
    x = x + _angles(pos_t.float().reshape(1), cfg.d_model)[None, None].to(x.dtype)
    for i, lp in enumerate(unstack_layers(params["dec_layers"])):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn_out, _ = apply_attention(lp["self_attn"], h, None, cfg, causal=False,
                                      cache={"k": cache["k"][i], "v": cache["v"][i]},
                                      cache_pos=pos_t)
        x = x + attn_out
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        cross = (cache["cross_k"][i].to(h.dtype), cache["cross_v"][i].to(h.dtype))
        x = x + apply_attention(lp["cross_attn"], h, None, cfg, causal=False,
                                cross_kv=cross)[0]
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], h)
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from(params["tok"], hidden, cfg), cache
