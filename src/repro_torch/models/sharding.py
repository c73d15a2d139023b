"""Logical-axis sharding rules for the model zoo (port of
``repro.models.sharding``).

The reference maps logical activation axes (``batch``, ``heads``, ...) to
mesh axes and constrains activations with :func:`cs`; parameters get
partition specs from name-based rules (:func:`param_specs`).  The port's
mesh has one card per pod (``launch/mesh.py``: ``data * model`` is 1), so
every constraint is the identity and :func:`cs` returns its input.  The
rules stay, with the reference's tables, for the per-shard FedQCS geometry
(``runtime/steps.py::shard_block_geometry``) and the state's specs
(``train_state_shardings``); they place nothing until a pod spans several
cards (ROADMAP.md item 10b).  The checkpointer reads no spec: it restores
onto one ``device``.  A spec is a tuple with one entry a dimension:
``None``, a mesh axis name, or a tuple of axis names.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Optional, Tuple

from repro_torch import tree as tree_util

Spec = Tuple[Any, ...]

_state = threading.local()


class ShardingRules:
    """Maps logical activation axes -> mesh axes.  None mesh axis = unsharded."""

    DEFAULT = {
        "batch": "data",
        "seq": None,
        "seq_kv": "model",  # decode-time KV sequence (split-KV)
        "dmodel": None,
        "heads": "model",
        "kv_heads": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "blocks": ("data", "model"),  # FedQCS (nblocks, N) views
    }

    def __init__(self, overrides: Optional[dict] = None, axis_sizes: Optional[dict] = None):
        self.table = dict(self.DEFAULT)
        if overrides:
            self.table.update(overrides)
        self.axis_sizes = dict(axis_sizes or {})

    def _axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, (tuple, list)):
            n = 1
            for a in axes:
                n *= self.axis_sizes.get(a, 1)
            return n
        return self.axis_sizes.get(axes, 1)

    def _resolve(self, value, dim: Optional[int]):
        if isinstance(value, list):  # candidates, best-fit by divisibility
            for cand in value:
                if dim is None or not self.axis_sizes or dim % self._axis_size(cand) == 0:
                    return cand
            return None
        if dim is not None and self.axis_sizes and value is not None:
            if dim % self._axis_size(value) != 0:
                return None
        return value

    def spec(self, *logical: Optional[str], dims: Optional[Tuple[int, ...]] = None) -> Spec:
        raw = [self.table.get(l) if l else None for l in logical]
        if dims is None:
            dims = (None,) * len(raw)
        return tuple(self._resolve(a, d) for a, d in zip(raw, dims))


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


def cs(x, *logical: Optional[str]):
    """The reference's sharding constraint by logical axis names.  Every
    axis a constraint could name has size 1 on the port's mesh, so it is the
    identity."""
    return x


# ---------------------------------------------------------------------------
# Parameter specs by path-name rules (the reference's table).
# ---------------------------------------------------------------------------

_PARAM_RULES: Tuple[Tuple[str, Tuple[Tuple[Optional[str], ...], ...]], ...] = (
    (r"embed", (("model", "data"),)),  # (V, D)
    (r"lm_head|final_head", (("data", "model"),)),  # (D, V)
    (r"wqkv|wq$|wk$|wv$", (("data", "model"),)),  # (D, H*dh)
    (r"bq$|bk$|bv$", (("model",),)),  # qkv bias
    (r"wo$", (("model", "data"),)),  # (H*dh, D)
    (r"w_dkv|w_dq", (("data", None),)),  # MLA down-proj (D, r)
    (r"w_uk|w_uv|w_uq", ((None, "model"),)),  # MLA up-proj (r, H*dh)
    (r"w_kr", (("data", None),)),  # MLA rope key proj
    (r"router", (("data", None),)),  # (D, E)
    (r"experts/w(i|g)", (("model", "data", None),)),
    (r"experts/wo", (("model", None, "data"),)),
    (r"mlp/w(i|g)|shared/w(i|g)", (("data", "model"),)),  # (D, F)
    (r"mlp/wo|shared/wo", (("model", "data"),)),  # (F, D)
    (r"in_proj", (("data", "model"),)),  # mamba (D, X)
    (r"out_proj", (("model", "data"),)),  # mamba (di, D)
    (r"conv_w", ((None, "model"),)),  # (K, C)
    (r"norm|scale|bias|a_log|d_skip|dt_bias", ((None,),)),  # vectors: replicated
)


def _fits(spec, shape, axis_sizes) -> bool:
    for ax, dim in zip(spec, shape):
        if ax is None:
            continue
        size = 1
        for a in ax if isinstance(ax, tuple) else (ax,):
            size *= axis_sizes.get(a, 1)
        if dim % size != 0:
            return False
    return True


def _spec_for(path: str, shape, axis_sizes) -> Spec:
    ndim = len(shape)
    for pattern, candidates in _PARAM_RULES:
        if re.search(pattern, path):
            for trailing in candidates:
                tr = trailing[-ndim:] if len(trailing) > ndim else trailing
                spec = (None,) * (ndim - len(tr)) + tuple(tr)
                if axis_sizes is None or _fits(spec, shape, axis_sizes):
                    return spec
            trailing = candidates[0]  # the caller's sanitizer handles the rest
            tr = trailing[-ndim:] if len(trailing) > ndim else trailing
            return (None,) * (ndim - len(tr)) + tuple(tr)
    return (None,) * ndim


def param_specs(params, axis_sizes: Optional[dict] = None):
    """A tree of specs of the parameters' structure (by path-name rules on
    the lower-cased ``/``-joined path).  ``axis_sizes`` (mesh axis -> size)
    enables the divisibility-aware choice among candidates."""
    return tree_util.unflatten(
        (path, _spec_for(tree_util.slash(path).lower(), tuple(leaf.shape), axis_sizes))
        for path, leaf in tree_util.leaves_in_order(params)
    )
