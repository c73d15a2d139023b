"""Unified model API: family dispatch and per-shape input specs (port of
``repro.models.model``).

Every architecture exposes the reference's entry points: ``init_params``,
``train_loss``, ``prefill``, ``decode_step`` and ``init_cache``.  The port
carries the ``dense`` family (``models/transformer.py``); the ``moe``,
``vlm``, ``ssm``, ``hybrid`` and ``audio`` families raise, naming ROADMAP.md
item 11.  :func:`input_specs` gives each input of a step as a
:class:`TensorSpec` (shape and dtype), the reference's ShapeDtypeStruct
stand-ins.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import entry_device, not_in_slice
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import batch_generator
from repro_torch.models import transformer
from repro_torch.models.common import dtype_of


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


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, allocated by nothing."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _module(cfg: ModelConfig):
    if cfg.family != "dense":
        raise not_in_slice(f"the {cfg.family!r} model family ({cfg.name})", "item 11")
    return transformer


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """The family's parameter tree on ``device`` (``"meta"``: shapes and
    dtypes only)."""
    return _module(cfg).init_params(cfg, seed, device)


def train_loss(params, batch, cfg: ModelConfig):
    return _module(cfg).train_loss(params, batch, cfg)


def init_cache(cfg: ModelConfig, batch: int, smax: int):
    return _module(cfg).init_cache(cfg, batch, smax)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    return _module(cfg).decode_step(params, cache, tokens, pos, cfg)


def prefill(params, batch, cfg: ModelConfig):
    return _module(cfg).prefill(params, batch, cfg)


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """The train or prefill batch of a dense model as TensorSpecs (tokens
    are int64, torch's index dtype).  Decode inputs hold the KV cache:
    item 11."""
    _module(cfg)
    cell = SHAPES[shape]
    if cell.kind == "decode":
        raise not_in_slice("the decode step's inputs (the KV cache)", "item 11")
    b, s = cell.batch, cell.seq
    specs = {"tokens": TensorSpec((b, s), torch.int64)}
    if cell.kind == "train":
        specs["labels"] = TensorSpec((b, s), torch.int64)
    return specs


def make_batch(cfg: ModelConfig, shape: str, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """A random batch matching :func:`input_specs` (uniform tokens from a
    seeded CPU generator), moved to ``device``."""
    dev = entry_device(device)
    gen = batch_generator(seed)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype == torch.int64:
            out[name] = torch.randint(0, max(2, cfg.vocab_size), spec.shape, generator=gen)
        else:
            out[name] = (torch.randn(spec.shape, generator=gen) * 0.02).to(dtype_of(cfg))
    return {k: v.to(dev) for k, v in out.items()}
