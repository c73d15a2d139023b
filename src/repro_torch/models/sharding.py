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

The serve steps run on the same layout: the prefill's batch over ``(pod,
data)``, the decode cache's batch over ``data`` and its slots over
``model`` (:func:`cache_spec`).  Without autograd a product with a weight
sharded over ``data`` moves whichever is smaller, the weight or the
activations (:func:`fsdp_mms`, :func:`fsdp_out`, :func:`fsdp_rows`): a
decode step's few rows travel instead of the layer's weights.
:func:`prompt_slots` places a prompt's K/V in the rank's slots,
:func:`split_kv_combine` joins the ranks' partial attention over their
slots, :func:`greedy_tokens` takes the argmax over the vocabulary shards.

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
    ``("pod", "data")``, in the baseline and the prefill (their one global
    program); in a decode step, whose rows are the cache's ``data`` share
    (the same on every pod), the whole batch's again: ``("data",)``."""

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


def _moves_activations(x_numel: int, w_numel: int) -> bool:
    """Whether a product with a weight sharded over ``data`` gathers the
    activations instead of the weight: without autograd (the serve steps),
    where they are the smaller (a decode step's few rows).  Every ``data``
    rank of the product decides alike: their shapes are one."""
    return not torch.is_grad_enabled() and x_numel < w_numel


def fsdp_mms(x: torch.Tensor, ws) -> list:
    """``x @ w`` for each weight of ``ws`` whose d_model rows (dim -2, as
    wide as ``x``'s last dimension) may be a ``data`` shard: gathered over
    ``data`` (:func:`fsdp`); or, where :func:`_moves_activations`, every
    ``data`` rank's ``x`` gathered once, each rank's fp32 partial products
    of its rows summed over ``data`` and rounded once (the weights stay)."""
    ip, full = _inpod, x.shape[-1]
    split = [w.shape[-2] != full for w in ws]
    if ip is None or not any(split):
        return [x @ w for w in ws]
    if not _moves_activations(x.numel(), sum(w.numel() for w, sp in zip(ws, split) if sp)):
        return [x @ fsdp(w, w.dim() - 2, full) for w in ws]
    group, d = ip.group("data"), ip.coords["data"]
    xs = all_gather(x, group)  # (data, ..., full): every data rank's rows
    parts = [torch.matmul(xs.narrow(-1, d * w.shape[-2], w.shape[-2]).float(), w.float())
             for w, sp in zip(ws, split) if sp]
    sums = all_reduce(torch.cat(parts, dim=-1), group)[d].to(x.dtype).split(
        [p.shape[-1] for p in parts], dim=-1)
    it = iter(sums)
    return [next(it) if sp else x @ w for w, sp in zip(ws, split)]


def fsdp_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for one weight whose d_model rows may be a ``data`` shard
    (:func:`fsdp_mms`)."""
    return fsdp_mms(x, [w])[0]


def fsdp_out(h: torch.Tensor, w: torch.Tensor, full: int) -> torch.Tensor:
    """``h @ w`` for a weight whose d_model columns (dim -1, ``full`` wide)
    may be a ``data`` shard: gathered over ``data``; or, where
    :func:`_moves_activations`, every ``data`` rank's ``h`` gathered, the
    rank's columns of each rank's product, and an all-to-all over ``data``
    that brings each rank its rows' columns (the products as one rank's)."""
    ip = _inpod
    if ip is None or w.shape[-1] == full:
        return h @ w
    if not _moves_activations(h.numel(), w.numel()):
        return h @ fsdp(w, w.dim() - 1, full)
    group = ip.group("data")
    cols = all_to_all(torch.matmul(all_gather(h, group), w), group)
    return torch.cat(cols.unbind(0), dim=-1)


def fsdp_rows(table: torch.Tensor, ids: torch.Tensor, full: int) -> torch.Tensor:
    """The rows ``ids`` of an embedding table whose d_model columns
    (``full`` wide) may be a ``data`` shard: the table gathered over
    ``data``; or, where :func:`_moves_activations`, every ``data`` rank's
    ids gathered, looked up in the rank's columns and sent back by an
    all-to-all over ``data``."""
    import torch.nn.functional as F

    ip = _inpod
    if ip is None or table.shape[-1] == full:
        return F.embedding(ids, table)
    if not _moves_activations(ids.numel() * full, table.numel()):
        return F.embedding(ids, fsdp(table, 1, full))
    group = ip.group("data")
    cols = all_to_all(F.embedding(all_gather(ids, group), table), group)
    return torch.cat(cols.unbind(0), dim=-1)


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


def model_whole_parts(xs, dim: int) -> list:
    """Each tensor of ``xs`` -- split over ``model`` along ``dim``, their
    other dimensions alike -- whole, by one all-gather over ``model`` (no
    backward: the decode's query heads and new K/V)."""
    ip = _inpod
    if ip is None or ip.sizes["model"] == 1:
        return list(xs)
    dim %= xs[0].dim()
    parts = all_gather(torch.cat(xs, dim=dim), ip.group("model"))
    return [torch.cat(part.unbind(0), dim=dim)
            for part in parts.split([x.shape[dim] for x in xs], dim=dim + 1)]


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


# ---------------------------------------------------------------------------
# Serving on the mesh: the cache's placement, the split-KV combine, greedy.
# ---------------------------------------------------------------------------


def _even(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def cache_spec(name: str, shape, sizes: dict) -> Spec:
    """The reference's KV/state cache layout (its ``_cache_spec``) for the
    leaf ``name`` of ``shape`` on a mesh of axis ``sizes``: batch over
    ``data``, the sequence slots (split-KV decode) or the SSM heads / conv
    channels over ``model``, each where the axis divides the dimension."""
    data = lambda d: "data" if _even(d, sizes.get("data", 1)) else None  # noqa: E731
    model = lambda d: "model" if _even(d, sizes.get("model", 1)) else None  # noqa: E731
    if any(k in name for k in ("ckv", "kr")):  # (L, B, S, r)
        return (None, data(shape[1]), model(shape[2]), None)
    if "conv" in name:  # (L, B, K, C)
        return (None, data(shape[1]), None, model(shape[3]))
    if "ssm" in name or len(shape) == 5:  # (L, B, H, P, N); (L, B, S, KVH, dh)
        return (None, data(shape[1]), model(shape[2]), None, None)
    return (None,) * len(shape)


def cache_specs(cache, sizes: dict):
    """A cache tree's specs (:func:`cache_spec` of each leaf by its path)."""
    return tree_util.unflatten(
        (path, cache_spec(tree_util.slash(path).lower(), tuple(leaf.shape), sizes))
        for path, leaf in tree_util.leaves_in_order(cache))


def shard_cache(cache, mesh):
    """This rank's shard of a whole cache (:func:`cache_specs`): the batch
    rows of its ``data`` index and the contiguous slots ``[m * Smax /
    model, (m + 1) * Smax / model)`` of its ``model`` index (a mesh made
    outside its world: rank 0's)."""
    specs = cache_specs(cache, mesh.shape)
    coords = mesh.coords() if getattr(mesh, "rank", None) is not None else {}
    return tree_util.unflatten(
        (path, local_shard(leaf, tree_util.get(specs, path), mesh.shape, coords))
        for path, leaf in tree_util.leaves_in_order(cache))


def gather_cache(cache, specs, mesh):
    """The whole cache from every rank's :func:`shard_cache` (a collective:
    every rank calls it); ``specs``: :func:`cache_specs` of the whole
    cache."""
    return tree_util.unflatten((path, gather_leaf(leaf, tree_util.get(specs, path), mesh))
                               for path, leaf in tree_util.leaves_in_order(cache))


def kv_slots(local: int) -> Tuple[int, int]:
    """(the first global slot, Smax) of a cache shard of ``local`` slots:
    in-pod the slots are split over ``model`` (``(m * local, model *
    local)``); outside, the shard is the whole cache."""
    ip = _inpod
    if ip is None:
        return 0, local
    return ip.coords["model"] * local, ip.sizes["model"] * local


def prompt_slots(x: torch.Tensor, smax: Optional[int], heads: Optional[int] = None):
    """A layer's prompt K/V (B, S, KVH, dh) -- or MLA latents (B, S, r) --
    as its cache entry of ``smax`` slots (the prompt's, then zeros; None:
    the prompt's S).  In-pod ``x`` is the prefill rank's: its batch rows
    (over ``(pod, data)``) and, for K/V, its ``heads / model`` KV heads
    (``heads``: the whole count); the entry is the rank's cache shard
    (:func:`cache_spec`): every KV head gathered over ``model``, the rank's
    ``smax / model`` slots, and the rows gathered over ``(pod, data)`` of
    which it keeps its ``data`` share."""
    s = x.shape[1]
    smax = s if smax is None else smax
    ip = _inpod
    if ip is None:
        if smax <= s:
            return x
        out = x.new_zeros((x.shape[0], smax) + tuple(x.shape[2:]))
        out[:, :s] = x
        return out
    model = ip.sizes["model"]
    if smax < s or smax % model:
        raise ValueError(f"a cache of {smax} slots for a prompt of {s} on a {model}-way model "
                         "axis: it needs at least the prompt's slots, a multiple of the axis")
    if heads is not None:
        x = model_whole(x, 2, heads)
    local = smax // model
    first = ip.coords["model"] * local
    part = x.new_zeros((x.shape[0], local) + tuple(x.shape[2:]))
    mine = x[:, first:first + local]
    part[:, :mine.shape[1]] = mine
    rows = gather_leaf(part, (("pod", "data"),), ip.mesh)
    return local_shard(rows, ("data",), ip.sizes, ip.coords)


def split_kv_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Attention over every ``model`` rank's cache slots from each rank's
    partials over its own (flash-decoding's combine): ``m`` the fp32 row
    maxima (a rank with no valid slot holds its clamp, -1e30), ``l`` the
    fp32 probability sums with ``exp(s - m)``, ``o`` the unnormalized
    outputs (..., d), ``m`` and ``l`` of ``o``'s leading shape.  Each
    rank's share is weighted by ``exp(m - max over ranks)`` (0 for a
    rank with no valid slot) and summed, from one all-gather over
    ``model``; returns the fp32 output."""
    ip = _inpod
    if ip is None or ip.sizes["model"] == 1:
        return o.float() / torch.clamp(l, min=1e-30)[..., None]
    parts = all_gather(torch.cat([m[..., None], l[..., None], o.float()], dim=-1),
                       ip.group("model"))
    m, l, o = parts[..., 0], parts[..., 1], parts[..., 2:]
    w = torch.exp(m - torch.amax(m, dim=0))
    return torch.sum(o * w[..., None], dim=0) / torch.clamp(torch.sum(l * w, dim=0),
                                                              min=1e-30)[..., None]


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) greedy ids, the lowest index winning a tie (the
    reference's ``argmax``).  In-pod, ``logits`` holds the rank's
    vocabulary columns (all of them where the table is held whole): each
    rank's best is gathered over ``model`` and the lowest global index of
    the best value wins."""
    idx = torch.argmax(logits, dim=-1)
    ip = _inpod
    if ip is None or ip.vocab_whole or ip.sizes["model"] == 1:
        return idx
    best = torch.gather(logits, -1, idx[:, None])[:, 0]
    both = all_gather(torch.stack([best.double(), (idx + ip.vocab_start(logits.shape[-1]))
                                   .double()], dim=-1), ip.group("model"))  # exact in fp64
    vals, ids = both[..., 0], both[..., 1]
    return torch.amin(torch.where(vals == torch.amax(vals, dim=0), ids, float("inf")),
                      dim=0).to(idx.dtype)
