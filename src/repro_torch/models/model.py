"""Unified model API: family dispatch and per-shape input specs (port of
``repro.models.model``).

Every architecture exposes the reference's entry points: ``init_params``,
``train_loss``, ``prefill``, ``decode_step`` and ``init_cache``, whatever
its family: ``dense``, ``moe`` and ``vlm`` (``models/transformer.py``),
``ssm`` (``models/ssm_lm.py``), ``hybrid`` (``models/hybrid.py``) and
``audio`` (``models/encdec.py``).  :func:`input_specs` gives each input of
a step as a :class:`TensorSpec` (shape and dtype), the reference's
ShapeDtypeStruct stand-ins; token ids and positions are int64, torch's
index dtype, where the reference's are int32.  :func:`grow_cache` makes a
prefill cache room for decode steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import entry_device, not_in_slice, prng
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, sharding, ssm_lm, transformer
from repro_torch.models.common import dtype_of, init_key


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

_VIS_FRAC = 4  # vlm: 1/4 of the sequence budget is patch embeddings
_AUDIO_TEXT_FRAC = 8  # audio: text tokens are 1/8 of the frame budget


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, allocated by nothing."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _module(cfg: ModelConfig):
    return {
        "dense": transformer,
        "moe": transformer,
        "vlm": transformer,
        "ssm": ssm_lm,
        "hybrid": hybrid,
        "audio": encdec,
    }[cfg.family]


def init_params(cfg: ModelConfig, seed=0, device="cuda"):
    """The family's parameter tree, drawn on ``device`` from
    ``PRNGKey(seed)`` (``seed`` may also be a key) as the reference draws it
    (``"meta"``: shapes and dtypes only)."""
    return _module(cfg).init_params(cfg, seed, device)


def train_loss(params, batch, cfg: ModelConfig):
    return _module(cfg).train_loss(params, batch, cfg)


def init_cache(cfg: ModelConfig, batch: int, smax: int, device="cuda", mesh=None):
    """Zeros of the family's decode cache for ``batch`` rows and ``smax``
    slots; on an in-pod ``mesh``, of a rank's shard of it
    (:func:`~repro_torch.models.sharding.cache_spec`: the rows over
    ``data``, the slots over ``model``)."""
    if mesh is None or not mesh.inpod:
        return _module(cfg).init_cache(cfg, batch, smax, device)
    check_mesh_serve(cfg)
    whole = _module(cfg).init_cache(cfg, batch, smax, "meta")
    dev = entry_device(device)
    return tree_util.tree_map(lambda v: torch.zeros(v.shape, dtype=v.dtype, device=dev),
                              sharding.shard_cache(whole, mesh))


def check_mesh_serve(cfg: ModelConfig) -> None:
    """Raises for a family whose serve steps do not run on an in-pod mesh
    yet: the SSM and hybrid families' conv-window and state placement, and
    the audio family's cross K/V."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise not_in_slice(f"the {cfg.family} family's serve steps on an in-pod mesh (its "
                           "conv-window and SSM-state or cross-K/V placement)",
                           "item 10c, second part")


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, inplace: bool = False):
    return _module(cfg).decode_step(params, cache, tokens, pos, cfg, inplace)


def prefill(params, batch, cfg: ModelConfig, smax: Optional[int] = None):
    """(last-position logits, the cache of the prompt).  The audio family
    decodes its BOS token into a self-attention cache of ``smax`` slots
    (default: the frame count); the others' caches get ``smax`` slots on
    each self-attention leaf (default: the prompt's), as
    :func:`grow_cache` makes them -- the transformer family's written
    there directly, which on an in-pod mesh places each layer's K/V in
    the rank's slots."""
    mod = _module(cfg)
    if cfg.family == "audio":
        return mod.prefill(params, batch, cfg, smax or batch["frames"].shape[1])
    if mod is transformer:
        return mod.prefill(params, batch, cfg, smax)
    logits, cache = mod.prefill(params, batch, cfg)
    return logits, (cache if smax is None else grow_cache(cache, smax))


SLOT_LEAVES = ("k", "v", "ckv", "kr")  # cache leaves with a sequence-slot axis (dim 2)


def grow_cache(cache: dict, smax: int) -> dict:
    """A copy of a prefill cache with at least ``smax`` slots on each
    self-attention leaf (its K/V or MLA latents: the prompt's slots, then
    zeros), ready for decode steps at the positions after the prompt.  SSM
    states are O(1) in the sequence and the encoder's cross K/V keep its
    length: those leaves are copied as they are.  The prefill's cache is
    left as it was."""
    def grow(path, v):
        if path[-1] not in SLOT_LEAVES or v.shape[2] >= smax:
            return v.clone()
        out = v.new_zeros(v.shape[:2] + (smax,) + v.shape[3:])
        out[:, :, :v.shape[2]] = v
        return out

    return tree_util.unflatten((path, grow(path, v))
                               for path, v in tree_util.leaves_in_order(cache))


def supports_cell(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Whether (arch x shape) is in contract: (ok, the reason if not)."""
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k requires sub-quadratic attention (see DESIGN.md)"
    if cell.kind == "decode" and not cfg.supports_decode:
        return False, "architecture has no decode step"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """The step's inputs as TensorSpecs: the train or prefill batch (the
    VLM's: text tokens, a quarter of the sequence as patch embeddings, and
    (3, B, S) positions; the audio family's: ``seq`` frame embeddings and,
    to train, max(64, seq / 8) text tokens), or the decode inputs (tokens
    (B, 1), ``pos`` and the cache of ``seq`` slots)."""
    _module(cfg)
    cell = SHAPES[shape]
    b, s = cell.batch, cell.seq
    i64 = torch.int64
    if cell.kind == "decode":
        cache = tree_util.tree_map(lambda v: TensorSpec(tuple(v.shape), v.dtype),
                                   init_cache(cfg, b, s, device="meta"))
        return {"tokens": TensorSpec((b, 1), i64), "pos": TensorSpec((), i64), "cache": cache}
    if cfg.family == "audio":
        specs = {"frames": TensorSpec((b, s, cfg.d_model), dtype_of(cfg))}
        if cell.kind == "train":
            st = max(64, s // _AUDIO_TEXT_FRAC)
            specs["tokens"] = TensorSpec((b, st), i64)
            specs["labels"] = TensorSpec((b, st), i64)
        return specs
    st = s - s // _VIS_FRAC if cfg.family == "vlm" else s
    specs = {"tokens": TensorSpec((b, st), i64)}
    if cfg.family == "vlm":
        specs["patches"] = TensorSpec((b, s - st, cfg.d_model), dtype_of(cfg))
        specs["positions"] = TensorSpec((3, b, s), i64)
    if cell.kind == "train":
        specs["labels"] = TensorSpec((b, st), i64)
    return specs


def make_batch(cfg: ModelConfig, shape: str, seed=0, device="cuda") -> Dict[str, Any]:
    """Random inputs matching :func:`input_specs`, drawn on ``device`` from
    ``PRNGKey(seed)`` (or the key ``seed``) as the reference fills them --
    the same key for every leaf: ``randint(key, shape, 0, max(2, V)) % V``
    token ids (and ``pos``), M-RoPE positions 0..S-1 on every stream, and
    ``normal(key, shape)`` cast to the spec's dtype times 0.02 (patches,
    frames, a decode cache).  ``device="meta"`` draws nothing."""
    key = init_key(seed, entry_device(device))

    def fill(spec: TensorSpec) -> torch.Tensor:
        if spec.dtype == torch.int64:
            if len(spec.shape) == 3 and spec.shape[0] == 3:
                return torch.arange(spec.shape[-1], device=key.device).expand(
                    spec.shape).contiguous()
            return prng.randint(key, spec.shape, 0, max(2, cfg.vocab_size)) % cfg.vocab_size
        x = prng.normal(key, spec.shape).to(spec.dtype)
        return x * torch.tensor(0.02, dtype=spec.dtype, device=key.device)

    return tree_util.tree_map(fill, input_specs(cfg, shape))
