"""Adam and SGD with momentum over parameter dicts (flat, or nested as the
model zoo's), with fp32 or blockwise-int8 moment states (port of
``repro.optim.adam``).

The update is written out as the reference writes it -- bias terms
``1 - b**t`` in float32, ``mhat / (sqrt(vhat) + eps)`` -- rather than
through ``torch.optim.Adam``, whose arithmetic order differs.

``state_dtype="int8"`` stores each moment as a :class:`QLeaf`: int8 codes
in the parameter's shape and one fp32 scale per block of 256 entries of
the flattened leaf (linear blockwise quantization; Adam's second moment in
the sqrt domain with a half-LSB floor, as the reference).

On an in-pod mesh a rank holds a shard of each leaf (a :class:`Shard`
says where it lies) and its ``QLeaf`` is the shard of the whole leaf's:
the codes of its entries and every block's scale.  A block's maximum is
taken over the rank's entries in it (each entry's block from its flat
index in the whole leaf) and over the ranks the leaf is split across
(an all-reduce); a maximum and a division are exact, so the shard's codes
and scales are the whole-leaf quantization's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.models.sharding import all_reduce

Params = Dict[str, Any]  # name -> tensor, or name -> nested dict of tensors

_QBLOCK = 256


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adam"  # adam | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"  # float32 | int8
    momentum: float = 0.9  # sgd


def schedule(cfg: OptConfig, step) -> float:
    """Linear warmup -> cosine decay to min_lr_frac, in float32 arithmetic on
    the host (a Python float holding the f32 value, so no scalar is copied to
    the device -- which would synchronise the stream)."""
    f = np.float32
    step = f(step)
    warm = min((step + f(1.0)) / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip(
        (step - f(cfg.warmup_steps)) / f(max(cfg.decay_steps - cfg.warmup_steps, 1)),
        f(0.0), f(1.0),
    )
    cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * prog))
    frac = f(cfg.min_lr_frac) + (f(1.0) - f(cfg.min_lr_frac)) * cos
    return float(f(cfg.lr) * warm * frac)


# ---------------------------------------------------------------------------
# blockwise int8 moment quantization
# ---------------------------------------------------------------------------


class QLeaf(NamedTuple):
    q: torch.Tensor  # int8, the leaf's shape
    scale: torch.Tensor  # f32, (ceil(size / 256),)


class Shard(NamedTuple):
    """Where a rank's shard of a leaf lies in the whole leaf: the whole
    ``shape``, the shard's first index along each dimension (``start``) and
    the process group of the ranks the leaf is split across (None: held
    whole)."""

    shape: Tuple[int, ...]
    start: Tuple[int, ...]
    group: Any


def _nblocks(shape) -> int:
    return -(-int(np.prod(shape, dtype=np.int64)) // _QBLOCK)


def _block_of(local_shape, shard: Shard, device) -> torch.Tensor:
    """(n,) int64: the 256-entry block of the whole leaf that each entry of
    the shard (row-major) falls in."""
    flat = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for dim in reversed(range(len(local_shape))):
        idx = torch.arange(shard.start[dim], shard.start[dim] + local_shape[dim],
                           dtype=torch.int64, device=device)
        view = [1] * len(local_shape)
        view[dim] = -1
        flat = flat + idx.view(view) * stride
        stride *= shard.shape[dim]
    return (flat // _QBLOCK).reshape(-1)


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    """(n,) -> (ceil(n / 256), 256), zero-padded."""
    return torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % _QBLOCK)).reshape(-1, _QBLOCK)


def _quantize_leaf(x: torch.Tensor, sqrt_domain: bool = False,
                   shard: Optional[Shard] = None) -> QLeaf:
    """Blockwise int8.  ``sqrt_domain=True`` (Adam's second moment) stores
    sqrt(x) / sqrt(blockmax): v spans many decades within a block, and a
    linear mapping would underflow small v to exactly 0.  ``shard``: ``x``
    is that shard of a leaf; the result is its shard of the whole leaf's
    ``QLeaf`` (a collective over ``shard.group``)."""
    flat = x.reshape(-1).to(torch.float32)
    if shard is not None:
        return _quantize_shard(flat, sqrt_domain, shard, tuple(x.shape))
    fp = _blocks(flat)
    if sqrt_domain:
        fp = torch.sqrt(torch.clamp(fp, min=0.0))
    scale = torch.amax(torch.abs(fp), dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(fp / safe[:, None]), -127, 127).to(torch.int8)
    return QLeaf(q.reshape(-1)[: flat.shape[0]].reshape(x.shape), scale)


def _quantize_shard(flat: torch.Tensor, sqrt_domain: bool, shard: Shard, shape) -> QLeaf:
    block = _block_of(shape, shard, flat.device)
    if sqrt_domain:
        flat = torch.sqrt(torch.clamp(flat, min=0.0))
    top = torch.zeros(_nblocks(shard.shape), dtype=torch.float32, device=flat.device)
    top = top.scatter_reduce(0, block, torch.abs(flat), reduce="amax")
    if shard.group is not None:
        top = all_reduce(top, shard.group, op="max")
    scale = top / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(flat / safe[block]), -127, 127).to(torch.int8)
    return QLeaf(q.reshape(shape), scale)


def _dequantize_leaf(ql: QLeaf, sqrt_domain: bool = False,
                     shard: Optional[Shard] = None) -> torch.Tensor:
    flat = ql.q.reshape(-1).to(torch.float32)
    if shard is not None:  # each entry by its block's scale, as the whole leaf's
        scale = ql.scale[_block_of(tuple(ql.q.shape), shard, flat.device)]
    else:
        flat, scale = _blocks(flat), ql.scale[:, None]
    if sqrt_domain:
        flat = torch.clamp(torch.abs(flat), min=0.5)  # half-LSB floor: v never hits 0
        out = torch.square(flat * scale)
        out = torch.where(scale == 0.0, torch.zeros_like(out), out)
    else:
        out = flat * scale
    return out.reshape(-1)[: ql.q.numel()].reshape(ql.q.shape)


def _maybe_q(x: torch.Tensor, cfg: OptConfig, sqrt_domain: bool = False,
             shard: Optional[Shard] = None):
    return _quantize_leaf(x, sqrt_domain, shard) if cfg.state_dtype == "int8" else x


def _maybe_dq(x, sqrt_domain: bool = False, shard: Optional[Shard] = None) -> torch.Tensor:
    return _dequantize_leaf(x, sqrt_domain, shard) if isinstance(x, QLeaf) else x


def _f32_product(a: float, b: float) -> float:
    """a * b rounded to f32, as the reference's ``lr * weight_decay`` (an f32
    array times a Python float) before it meets the parameters."""
    return float(np.float32(a) * np.float32(b))


def _check(cfg: OptConfig) -> None:
    if cfg.kind not in ("adam", "sgd") or cfg.state_dtype not in ("float32", "int8"):
        raise ValueError(f"unknown optimizer kind={cfg.kind!r} state_dtype={cfg.state_dtype!r}")


def init_state(cfg: OptConfig, params: Params,
               shards: Optional[Dict[tuple, Shard]] = None) -> Dict[str, dict]:
    """{"m": ..., "v": ...} for Adam, {"m": ...} for SGD: trees of the
    parameters' structure (flat or nested), fp32 zeros or their QLeafs.
    ``shards`` (path -> :class:`Shard`): ``params`` are a rank's shards, and
    each QLeaf holds the whole leaf's block scales (all zero)."""
    _check(cfg)

    def zeros(path, p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.state_dtype == "int8" and shards is not None:
            return QLeaf(z.to(torch.int8), torch.zeros(_nblocks(shards[path].shape),
                                                       dtype=torch.float32, device=p.device))
        return _maybe_q(z, cfg)

    names = ("m", "v") if cfg.kind == "adam" else ("m",)
    return {s: tree_util.unflatten((path, zeros(path, p))
                                   for path, p in tree_util.leaves_in_order(params))
            for s in names}


def update(cfg: OptConfig, grads: Params, state, params: Params, step,
           norm_sq: Optional[Callable[[Params], torch.Tensor]] = None,
           shards: Optional[Dict[tuple, Shard]] = None) -> Tuple[Params, dict]:
    """One step over a flat or nested parameter dict; the new parameters and
    state keep the parameters' structure and key order.  ``norm_sq(grads)``
    gives the squared global norm the clip reads (default: the tree's own;
    an in-pod rank's sums its shards over the pod, a replicated leaf
    once).  ``shards`` (path -> :class:`Shard`): the tensors are a rank's
    shards, and its int8 moments the shards of the whole leaves'."""
    _check(cfg)
    shard_of = (shards or {}).get
    lr = schedule(cfg, step)
    paths = [p for p, _ in tree_util.leaves_in_order(params)]
    g_of = {p: tree_util.get(grads, p) for p in paths}
    if cfg.grad_clip > 0:
        if norm_sq is None:
            # the squared norms summed in the gradient tree's own order
            gn = torch.sqrt(sum(torch.sum(g.float() * g.float())
                                for _, g in tree_util.leaves_in_order(grads)))
        else:
            gn = torch.sqrt(norm_sq(grads))
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
        g_of = {p: g * clip for p, g in g_of.items()}
    m_of = {p: tree_util.get(state["m"], p) for p in paths}
    if cfg.kind == "sgd":
        new_p, new_m = [], []
        for path, p in tree_util.leaves_in_order(params):
            sh = shard_of(path)
            mf = cfg.momentum * _maybe_dq(m_of[path], shard=sh) + g_of[path].float()
            q = p.float() - lr * mf
            if cfg.weight_decay:
                q = q - _f32_product(lr, cfg.weight_decay) * p.float()
            new_p.append((path, q.to(p.dtype)))
            new_m.append((path, _maybe_q(mf, cfg, shard=sh)))
        return tree_util.unflatten(new_p), {"m": tree_util.unflatten(new_m)}
    t = np.float32(step) + np.float32(1.0)
    bias1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)  # f32, as the reference
    bias2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    new_p, new_m, new_v = [], [], []
    for path, p in tree_util.leaves_in_order(params):
        sh = shard_of(path)
        gf = g_of[path].float()
        mf = cfg.b1 * _maybe_dq(m_of[path], shard=sh) + (1 - cfg.b1) * gf
        vf = (cfg.b2 * _maybe_dq(tree_util.get(state["v"], path), sqrt_domain=True, shard=sh)
              + (1 - cfg.b2) * (gf * gf))
        step_dir = (mf / bias1) / (torch.sqrt(vf / bias2) + cfg.eps)
        q = p.float() - lr * step_dir
        if cfg.weight_decay:
            q = q - _f32_product(lr, cfg.weight_decay) * p.float()
        new_p.append((path, q.to(p.dtype)))
        new_m.append((path, _maybe_q(mf, cfg, shard=sh)))
        new_v.append((path, _maybe_q(vf, cfg, sqrt_domain=True, shard=sh)))
    return tree_util.unflatten(new_p), {"m": tree_util.unflatten(new_m),
                                        "v": tree_util.unflatten(new_v)}
