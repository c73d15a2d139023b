"""Logical-axis sharding rules for the model zoo and the in-pod program
(port of ``repro.models.sharding``).

The reference maps logical activation axes (``batch``, ``heads``, ...) to
mesh axes and constrains activations with :func:`cs`; parameters get
partition specs from name-based rules (:func:`param_specs`).  Its layout is
"2D FSDP x TP": batch over ``data``; heads, ff and vocab over ``model``;
the d_model dimension of every weight matrix over ``data``.

The port runs that layout as one process per device of an in-pod mesh
(``launch/mesh.py``).  Each rank holds its shard of every leaf
(:func:`local_shard`, by the leaf's sanitized spec; :func:`gather_leaf`
puts a leaf back together), and the model's layers call the collectives
the reference's constraints resolve into, as autograd functions:

  * :func:`fsdp`: a weight shard gathered over ``data`` along its d_model
    dimension; its backward reduce-scatters (sums) the gradient;
  * :func:`model_whole`: a tensor split over ``model`` gathered whole
    (Mamba's column-parallel ``in_proj`` projections and its ``conv_w``,
    whose ``model`` halves do not fall on head boundaries: a rank then
    takes its heads' columns);
  * :func:`model_columns`: a rank's columns of a weight the rules
    replicate (the dense MLP's wi and wg: no rule names ``ffn/wi``);
  * :func:`own_experts`: the rank's experts of a stack split over
    ``model`` along its ff rows, whole (an all-to-all over ``model``; its
    backward sends each part's gradient back);
  * :func:`tp_enter`: the identity, with an all-reduce over ``model`` in
    the backward (Megatron's copy at a tensor-parallel region's entry), for
    an activation or a replicated weight the rank uses on its heads only;
  * :func:`cs` with ``reduce=``: an all-reduce in the forward and the
    identity in the backward (Megatron's reduce at the region's exit: the
    row-parallel products' partial sums);
  * :func:`model_sum`: an all-reduce over ``model`` in both directions (a
    statistic over every head that feeds each rank's own heads: the gated
    RMSNorm's sum of squares).

A rank's gradient of a leaf is whole over ``model`` once the backward is
done: every partial sum over ``model`` passes one of these functions on
its way to the leaf.  Only the sum over the rank's tokens is left (over
``data``, for a leaf that ``data`` does not split: the step's).

These act only while :func:`use_inpod` holds this rank's :class:`InPod`;
without one (every single-process path) they are the identity.  A spec is
a tuple with one entry a dimension: ``None``, a mesh axis name, or a tuple
of axis names (major first).
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Optional, Tuple

import torch

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


def cs(x, *logical: Optional[str], reduce: Optional[str] = None):
    """The reference's sharding constraint by logical axis names.  A rank
    holds its activations in the layout the constraint names already, so
    the constraint is the identity -- except where ``x`` holds partial sums
    over the mesh axis ``reduce`` (a row-parallel product), which the
    reference's replicated layout turns into an all-reduce: under
    :func:`use_inpod`, ``x`` is summed over that axis (the backward passes
    the gradient through)."""
    ip = _inpod
    if reduce is None or ip is None or ip.sizes[reduce] == 1:
        return x
    return _Reduce.apply(x, ip.group(reduce))


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


# ---------------------------------------------------------------------------
# Collectives of the in-pod program (over torch.distributed groups).
# ---------------------------------------------------------------------------


def _on_host(x: torch.Tensor, group) -> bool:
    """gloo's collectives run on host memory: a CUDA tensor's goes through a
    host copy, the same way on every call."""
    import torch.distributed as dist

    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` summed (or its maximum, ``op="max"``) over the
    group's ranks.  Half-precision floats reduce in fp32 and round once."""
    import torch.distributed as dist

    buf = x.detach().to("cpu" if _on_host(x, group) else x.device, copy=True)
    half = buf.dtype in (torch.bfloat16, torch.float16)
    if half:
        buf = buf.float()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return buf.to(device=x.device, dtype=x.dtype)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(...) on each rank -> (world, ...) in the group's rank order.  The
    bytes travel as they are (any dtype)."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    send = x.detach().contiguous().reshape(-1).view(torch.uint8)
    if _on_host(x, group):
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(parts, send, group=group)
    out = torch.stack(parts).to(x.device)
    return out.view(x.dtype).reshape((world,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(world, ...) on each rank -> (world, ...): part j goes to the
    group's rank j, and part j of the result came from rank j.  The bytes
    travel as they are (any dtype)."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    send = x.detach().contiguous().reshape(world, -1).view(torch.uint8)
    if _on_host(x, group):
        send = send.cpu()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    return out.to(x.device).view(x.dtype).reshape(x.shape)


class _Gather(torch.autograd.Function):
    """The shards of the group's ranks concatenated along ``dim``; the
    backward sums the gradient over the ranks and keeps this rank's part."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.world = dist.get_rank(group), dist.get_world_size(group)
        return torch.cat(all_gather(x, group).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g, ctx.group)
        return total.chunk(ctx.world, dim=ctx.dim)[ctx.rank].contiguous(), None, None


class _Swap(torch.autograd.Function):
    """(E, f, ...) -- every expert's part j of its rows on rank j -- to
    (E / world, world * f, ...): this rank's experts with all the ranks'
    parts; the backward sends each part's gradient back to its rank."""

    @staticmethod
    def forward(ctx, w, group, world):
        ctx.group, ctx.world = group, world
        parts = all_to_all(w.reshape((world, w.shape[0] // world) + w.shape[1:]), group)
        return parts.transpose(0, 1).flatten(1, 2)

    @staticmethod
    def backward(ctx, g):
        parts = g.unflatten(1, (ctx.world, g.shape[1] // ctx.world)).transpose(0, 1)
        return all_to_all(parts, ctx.group).flatten(0, 1), None, None


class _Copy(torch.autograd.Function):
    """The identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """The sum over the group; the backward passes the gradient through."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBoth(torch.autograd.Function):
    """The sum over the group; the backward sums the gradient over it too
    (each rank's consumers of the sum are its own)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


# ---------------------------------------------------------------------------
# The rank's place on an in-pod mesh.
# ---------------------------------------------------------------------------


class InPod:
    """One rank of an in-pod mesh: its coordinates, the axis sizes and the
    process groups its layers' collectives run over.  ``vocab_whole``:
    the vocabulary tables are held whole over ``model`` (their sanitized
    spec, where the axis does not divide the vocabulary), so every rank
    takes every row.  ``dispatch_axes``: the mesh axes whose ranks' tokens
    one MoE dispatch covers (major first): the pod's, ``("data",)``, in a
    FedQCS step (the reference's per-pod program); the whole batch's,
    ``("pod", "data")``, in the baseline (its one global program)."""

    def __init__(self, mesh, vocab_whole: bool, dispatch_axes: Tuple[str, ...]):
        self.mesh = mesh
        self.sizes = dict(mesh.shape)
        self.coords = mesh.coords()
        self.vocab_whole = vocab_whole
        self.dispatch_axes = dispatch_axes

    def group(self, axes):
        return self.mesh.group(axes)

    def vocab_start(self, local: int) -> int:
        """The first vocabulary row of this rank's ``local`` rows."""
        return self.coords["model"] * local


_inpod: Optional[InPod] = None  # process-wide: a remat recompute runs on autograd's thread


@contextlib.contextmanager
def use_inpod(ip: Optional[InPod]):
    """Installs ``ip`` as the rank's in-pod context (``None``: none)."""
    global _inpod
    prev, _inpod = _inpod, ip
    try:
        yield
    finally:
        _inpod = prev


def current_inpod() -> Optional[InPod]:
    return _inpod


def fsdp(w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """A weight with its d_model dimension ``dim`` (``full`` wide) whole: a
    shard of it is gathered over ``data`` (the reference's ZeRO-3 weight
    sharding); a weight that holds it whole, or no in-pod context, passes
    as it is."""
    ip = _inpod
    if ip is None or w.shape[dim] == full:
        return w
    return _Gather.apply(w, ip.group("data"), dim)


def model_whole(w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """A weight or an activation with its dimension ``dim`` (``full`` wide)
    whole over ``model``: a shard of it is gathered; the backward sums the
    gradient over ``model`` (each rank's is partial: its heads' columns)
    and keeps the rank's part.  A tensor that holds it whole passes as it
    is."""
    ip = _inpod
    if ip is None or w.shape[dim] == full:
        return w
    return _Gather.apply(w, ip.group("model"), dim % w.dim())


def model_columns(w: torch.Tensor, width: int) -> torch.Tensor:
    """The rank's ``width`` trailing columns of a weight replicated over
    ``model`` (the columns its share of a row-parallel product reads); a
    weight already split over ``model`` passes as it is.  The backward
    sums the replicated weight's gradient over ``model``."""
    ip = _inpod
    if ip is None or w.shape[-1] == width:
        return w
    return tp_enter(w).narrow(-1, ip.coords["model"] * width, width)


def own_experts(w: torch.Tensor) -> torch.Tensor:
    """The rank's ``E / model`` experts of an (E, ff, ...) stack whose ff
    rows are split over ``model`` (``experts/wo``, under the reference's
    ``wo$`` rule), with their ff rows whole: each rank sends every other
    rank the part of its rows that rank's experts need, and nothing else.
    The backward sends each part's gradient back (no sum: one rank uses
    each entry).  Outside an in-pod context, or with one ``model`` rank,
    ``w`` holds every expert whole and passes as it is."""
    ip = _inpod
    if ip is None or ip.sizes["model"] == 1:
        return w
    return _Swap.apply(w, ip.group("model"), ip.sizes["model"])


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """An activation, or a weight the rules replicate, entering a
    tensor-parallel region (used on the rank's heads or columns only): the
    identity, whose backward sums the gradient over ``model``."""
    ip = _inpod
    if ip is None or ip.sizes["model"] == 1:
        return x
    return _Copy.apply(x, ip.group("model"))


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """A partial sum over the rank's heads summed over ``model``, where each
    rank goes on with its own heads: the backward sums the gradient over
    ``model`` too."""
    ip = _inpod
    if ip is None or ip.sizes["model"] == 1:
        return x
    return _ReduceBoth.apply(x, ip.group("model"))


def model_heads(count: int) -> Tuple[int, int]:
    """(first, number) of the ``count`` heads this rank holds: a contiguous
    ``count / model`` of them (all of them outside an in-pod context)."""
    ip = _inpod
    if ip is None:
        return 0, count
    per = count // ip.sizes["model"]
    return ip.coords["model"] * per, per


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A partial sum over this rank's tokens summed over the pod's (over
    ``data``; the backward passes the gradient through)."""
    ip = _inpod
    if ip is None or ip.sizes["data"] == 1:
        return x
    return _Reduce.apply(x, ip.group("data"))


# ---------------------------------------------------------------------------
# Placement: a leaf's shard by its spec, and back.
# ---------------------------------------------------------------------------


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (major first)."""
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def local_shard(x: torch.Tensor, spec: Spec, sizes: dict, coords: dict) -> torch.Tensor:
    """This rank's shard of ``x`` (a contiguous copy): each dimension split
    into the product of its spec axes' sizes, the chunk at the rank's
    coordinates (the first axis of a tuple major).  An optimizer ``QLeaf``
    (a named tuple, its spec one too) is cut field by field."""
    if isinstance(x, tuple):
        return type(x)(*(local_shard(v, s, sizes, coords) for v, s in zip(x, spec)))
    for dim, entry in enumerate(spec):
        count, index = 1, 0
        for a in spec_axes(entry):
            count, index = count * sizes.get(a, 1), index * sizes.get(a, 1) + coords.get(a, 0)
        if count > 1:
            x = x.chunk(count, dim=dim)[index]
    return x.contiguous()


def gather_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's :func:`local_shard` (a collective:
    every rank of the mesh calls it, leaf for leaf; a ``QLeaf`` field by
    field)."""
    if isinstance(x, tuple):
        return type(x)(*(gather_leaf(v, s, mesh) for v, s in zip(x, spec)))
    for dim, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):  # the minor axis first
            if mesh.shape.get(a, 1) > 1:
                x = torch.cat(all_gather(x, mesh.group(a)).unbind(0), dim=dim)
    return x
