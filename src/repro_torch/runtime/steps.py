"""Train-step builders: where the model, the optimizer, FedQCS and the mesh
meet (port of ``repro.runtime.steps``).

:func:`make_train_step` returns ``step_fn(state, batch) -> (state,
metrics)`` in one of four forms:

  * **baseline** (``fed_cfg is None``): the full batch's gradient, Adam.
  * ``impl="auto"``: the batch splits into the state's pods; each pod's
    gradient (one after the other: the pods are independent, and a loop
    keeps ``torch.utils.checkpoint`` out of ``vmap``) is blocked on the
    monolithic layout, rows padded to a multiple of 512, and
    :func:`~repro_torch.runtime.collectives.fedqcs_vmapped_allreduce`
    compresses every pod and decodes the aggregate.
  * ``impl="auto_sharded"``: the per-shard blocking of the reference
    (``shard_block_geometry``); with one card a pod the local shards are the
    whole leaves, so it is ``auto`` without the row padding.  AE only.
  * ``impl="shard_map"``: one process per pod over the mesh's pod process
    group: this pod's gradient, :func:`~repro_torch.runtime.collectives.\
fedqcs_pod_allreduce` (the packed words gathered, or the dequantized sums
    reduced), then the mean of the pods' losses.  Its state holds this
    pod's ``(1, nb, N)`` residual; every pod applies the same aggregate, so
    the parameters stay identical across pods without a broadcast.

On an in-pod mesh (``data * model > 1``: one process per device,
``launch/mesh.py``) every family's step is the reference's "2D FSDP x
TP" program on each rank (``models/sharding.py``; the leaves placed by
their sanitized specs):
the rank's shards of the parameters, moments (fp32, or int8 ``QLeaf``s
whose 256-entry blocks run over the whole leaf: ``optim/adam.py``'s
:class:`~repro_torch.optim.adam.Shard`) and residual, its share of the
batch (over (pod, data)), the pod's loss and gradient shards, then the pod
exchange over the ranks that share its in-pod position:

  * ``impl="auto_sharded"``: the rank blocks its own shards and the
    Bussgang aggregate is summed over the pods; each rank decodes its
    ``nb_local`` rows.  AE only.
  * ``impl="auto"`` and ``"shard_map"``: the pod's monolithic blocking
    (rows padded to 512), its rows split over the pod's ``data * model``
    ranks (``"blocks": ("data", "model")``), each rank's rows built leaf by
    leaf from the pod's shards and its decoded rows returned to the shards
    leaf by leaf (no rank holds the pod's whole gradient).  They differ in
    the wire only: ``auto`` sums the dequantized observations (AE) or
    gathers the packed words (EA); ``shard_map`` takes the config's wire.
  * the baseline: the pod's gradient averaged over the pods (an MoE
    layer dispatches over the whole batch, as the reference's one
    program does).

The steps run on the device the state lives on; the FedQCS codec is made
on ``device``.  The serve steps :func:`make_prefill_step` and
:func:`make_decode_step` run the model's ``prefill`` and ``decode_step``
under ``torch.inference_mode()``; on an in-pod mesh (the transformer
family) each rank runs its shard of the reference's serve program: the
prefill over its ``(pod, data)`` rows with heads over ``model``, the
decode over its ``data`` rows and its ``model`` share of the cache's slots
(split-KV).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import entry_device, not_in_slice
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core.compression import (
    BQCSCodec,
    FedQCSConfig,
    blocks_to_tree,
    flatten_to_blocks,
)
from repro_torch.core.layout import GradientLayout
from repro_torch.models import model as model_api
from repro_torch.models.sharding import (
    InPod,
    all_reduce,
    cache_spec,
    gather_leaf,
    greedy_tokens,
    local_shard,
    param_specs,
    spec_axes,
    use_inpod,
)
from repro_torch.optim import adam
from repro_torch.runtime.collectives import (
    SHARDED_EA_ERROR,
    fedqcs_pod_allreduce,
    fedqcs_vmapped_allreduce,
    make_sharded_allreduce,
)

_ROW_MULTIPLE = 512  # FedQCS block rows are padded to a multiple of this


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors (shapes and dtypes only)."""
    return model_api.init_params(cfg, device="meta")


def _axis_size(entry, mesh) -> int:
    size = 1
    for a in entry if isinstance(entry, tuple) else (entry,):
        size *= mesh.shape.get(a, 1)
    return size


def sanitize_spec(spec, shape, mesh) -> tuple:
    """Drops the spec's axes whose mesh size does not divide the dimension;
    pads the spec to the tensor's rank."""
    axes = []
    for i, a in enumerate(spec):
        if a is None:
            axes.append(None)
            continue
        axes.append(a if (i < len(shape) and shape[i] % _axis_size(a, mesh) == 0) else None)
    axes += [None] * (len(shape) - len(axes))
    return tuple(axes)


def _param_spec_items(params, mesh):
    """(path, sanitized spec, leaf) in ``jax.tree_util`` leaf order."""
    specs = param_specs(params, axis_sizes=dict(mesh.shape))
    return [(path, sanitize_spec(tree_util.get(specs, path), tuple(leaf.shape), mesh), leaf)
            for path, leaf in tree_util.leaves(params)]


def shard_block_geometry(cfg: ModelConfig, fed_cfg: FedQCSConfig, mesh):
    """The per-device FedQCS blocking of ``impl="auto_sharded"``: (nb_local,
    nbar_local, local_shapes, specs), the shapes and specs in leaf order."""
    items = _param_spec_items(abstract_params(cfg), mesh)
    local_shapes, total = [], 0
    for _, spec, leaf in items:
        shape = list(leaf.shape)
        for i, entry in enumerate(spec):
            if entry is not None:
                shape[i] //= _axis_size(entry, mesh)
        local_shapes.append(tuple(shape))
        total += int(torch.Size(shape).numel())
    nb_local = -(-total // fed_cfg.block_size)
    specs = tree_util.unflatten((path, spec) for path, spec, _ in items)
    return nb_local, total, local_shapes, specs


def block_rows(cfg: ModelConfig, fed_cfg: FedQCSConfig) -> int:
    """The monolithic layout's block rows (padded to ``_ROW_MULTIPLE``)."""
    return GradientLayout.monolithic(abstract_params(cfg), fed_cfg.block_size,
                                     row_multiple=_ROW_MULTIPLE).rows


def init_train_state(
    cfg: ModelConfig,
    opt_cfg: adam.OptConfig,
    fed_cfg: Optional[FedQCSConfig],
    seed: int = 0,
    n_pods: int = 1,
    abstract: bool = False,
    mesh=None,
    impl: str = "auto",
    device="cuda",
    params=None,
):
    """The train state: ``params``, ``opt``, ``step`` and, with FedQCS, the
    error-feedback ``residual`` and the pods' ``participating`` flags.

    The residual is ``(n_pods, nb, N)`` (``nb`` padded to a multiple of
    512); ``impl="auto_sharded"`` (needs ``mesh``) blocks per device shard,
    ``(n_pods, nb_local * data * model, N)``; ``impl="shard_map"`` holds
    this pod's ``(1, nb, N)`` slice.  ``abstract=True`` builds ``meta``
    tensors (shapes only).  ``seed`` is an int (``PRNGKey(seed)``: the
    default 0 is the reference's default key) or a key of
    ``repro_torch.prng``.  ``params``: a parameter tree on ``device`` to
    hold instead of drawing one from ``seed`` (held, not copied).

    On an in-pod mesh (made inside its world) the state is this rank's
    shard of the whole state, placed by :func:`train_state_shardings`:
    its shards of the parameters (drawn whole, or ``params`` whole, then
    cut) and moments, its ``(1, rows / (data * model), N)`` residual rows
    and every pod's flags; ``n_pods`` is the mesh's."""
    if mesh is not None and mesh.inpod:
        return _init_inpod_state(cfg, opt_cfg, fed_cfg, seed, abstract, mesh, impl, device,
                                 params)
    dev = torch.device("meta") if abstract else entry_device(device)
    return _whole_state(cfg, opt_cfg, fed_cfg, seed, n_pods, dev, mesh, impl, params)


def _whole_state(cfg, opt_cfg, fed_cfg, seed, n_pods, dev, mesh, impl, params):
    """The whole state on ``dev`` (``mesh``: its axis sizes set
    ``auto_sharded``'s geometry)."""
    if params is None:
        params = model_api.init_params(cfg, seed, dev)
    else:
        for path, leaf in tree_util.leaves(params):
            if leaf.device.type != dev.type:
                raise ValueError(f"params{tree_util.keystr(path)} lies on {leaf.device}, "
                                 f"the state on {dev}")
    state = {"params": params, "opt": adam.init_state(opt_cfg, params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if fed_cfg is not None:
        n = fed_cfg.block_size
        if impl == "auto_sharded":
            if mesh is None:
                raise ValueError("impl='auto_sharded' needs the mesh")
            nb_local = shard_block_geometry(cfg, fed_cfg, mesh)[0]
            rows = nb_local * mesh.shape.get("data", 1) * mesh.shape.get("model", 1)
        else:
            rows = block_rows(cfg, fed_cfg)
        pods = 1 if impl == "shard_map" else n_pods
        state["residual"] = torch.zeros((pods, rows, n), dtype=torch.float32, device=dev)
        state["participating"] = torch.ones((n_pods,), dtype=torch.float32, device=dev)
    return state


def train_state_shardings(state, mesh, fed: bool):
    """The state's partition specs (params by the name rules, optimizer
    moments as their parameter, a ``QLeaf``'s scale replicated, the residual
    over pod x (data, model)).  With one card a pod, every spec places the
    whole tensor on each pod's card."""
    pspecs = tree_util.unflatten(
        (path, spec) for path, spec, _ in _param_spec_items(state["params"], mesh))

    def opt_tree(tree):
        return tree_util.unflatten(
            (path, adam.QLeaf(q=tree_util.get(pspecs, path), scale=())
             if isinstance(leaf, adam.QLeaf) else tree_util.get(pspecs, path))
            for path, leaf in tree_util.leaves_in_order(tree))

    out = {"params": pspecs, "step": (),
           "opt": {k: opt_tree(v) for k, v in state["opt"].items()}}
    if fed:
        out["residual"] = ("pod", ("data", "model"), None)
        out["participating"] = ()
    return out


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, gradient tree of the parameters' structure)."""
    items = tree_util.leaves_in_order(params)
    leaves = [p.detach().requires_grad_(True) for _, p in items]
    tree = tree_util.unflatten(zip((path for path, _ in items), leaves))
    loss = model_api.train_loss(tree, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_util.unflatten(zip((path for path, _ in items), grads))


def _pod_batch(batch, pods: int, p: int):
    """Pod ``p``'s share of the batch (batch dim split in ``pods``: dim 0 of
    every leaf, the audio family's (B, S, D) ``frames`` too; the VLM's (3,
    B, S) ``positions`` carry it second)."""
    def share(name, v):
        if name == "positions":
            return v.reshape((v.shape[0], pods, -1) + tuple(v.shape[2:]))[:, p]
        return v.reshape((pods, -1) + tuple(v.shape[1:]))[p]

    return {k: share(k, v) for k, v in batch.items()}


def pod_blocks(params, batch, cfg: ModelConfig, pods: int, n: int, device):
    """Each pod's loss and gradient blocks on the monolithic layout (rows
    padded to 512), one pod at a time into one (pods, nb, N) buffer: (the
    losses, the blocks, the layout)."""
    losses, blocks_pp, layout = [], None, None
    for p in range(pods):
        loss, grads = value_and_grad(params, _pod_batch(batch, pods, p), cfg)
        losses.append(loss)
        if layout is None:
            layout = GradientLayout.monolithic(grads, n, row_multiple=_ROW_MULTIPLE)
            blocks_pp = torch.empty((pods, layout.rows, n), dtype=torch.float32, device=device)
        blocks_pp[p] = layout.to_blocks(grads)
        del grads
    return losses, blocks_pp, layout


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adam.OptConfig,
    fed_cfg: Optional[FedQCSConfig],
    mesh,
    impl: str = "auto",
    device="cuda",
    a: Optional[torch.Tensor] = None,
):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.  ``device``
    holds the FedQCS codec (its sensing matrix ``a`` is drawn from the
    config seed, or injected).  The reference's ``donate`` has no
    counterpart: a step's old tensors are freed once the caller drops the
    old state.  On an in-pod mesh: the rank's step (the module docstring);
    its state is :func:`init_train_state`'s on that mesh and its batch the
    whole batch, of which it takes its share."""
    if mesh is not None and mesh.inpod:
        return _make_inpod_step(cfg, opt_cfg, fed_cfg, mesh, impl, device, a)
    if fed_cfg is None:
        def base_step(state, batch):
            loss, grads = value_and_grad(state["params"], batch, cfg)
            new_params, new_opt = adam.update(
                opt_cfg, grads, state["opt"], state["params"], int(state["step"]))
            return {"params": new_params, "opt": new_opt,
                    "step": state["step"] + 1}, {"loss": loss}

        return base_step

    if impl not in ("auto", "auto_sharded", "shard_map"):
        raise ValueError(f"unknown impl {impl!r} (auto | auto_sharded | shard_map)")
    codec = BQCSCodec(fed_cfg, a=a, device=device)
    n = fed_cfg.block_size

    def finish(state, grads, new_residual, loss):
        new_params, new_opt = adam.update(opt_cfg, grads, state["opt"], state["params"],
                                          int(state["step"]))
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1,
                "residual": new_residual,
                "participating": state["participating"]}, {"loss": loss}

    if impl == "auto_sharded":
        _, nbar_local, local_shapes, _ = shard_block_geometry(cfg, fed_cfg, mesh)
        body = make_sharded_allreduce(codec, mesh, local_shapes, nbar_local)

        def sharded_step(state, batch):
            pods = state["residual"].shape[0]
            part = state["participating"]
            rhos = part / torch.clamp(torch.sum(part), min=1.0)
            losses, per_pod = [], []
            for p in range(pods):
                loss, grads = value_and_grad(state["params"], _pod_batch(batch, pods, p), cfg)
                losses.append(loss)
                per_pod.append([g for _, g in tree_util.leaves(grads)])
                del grads
            grad_leaves = [torch.stack(gs) for gs in zip(*per_pod)]
            del per_pod
            new_residual, *ghat_leaves = body(state["residual"], rhos, *grad_leaves)
            del grad_leaves
            paths = [path for path, _ in tree_util.leaves(state["params"])]
            grads = tree_util.unflatten(zip(paths, ghat_leaves))
            return finish(state, grads, new_residual, torch.stack(losses).mean())

        return sharded_step

    if impl == "auto":
        def auto_step(state, batch):
            losses, blocks_pp, layout = pod_blocks(state["params"], batch, cfg,
                                                   state["residual"].shape[0], n,
                                                   state["residual"].device)
            ghat, new_residual = fedqcs_vmapped_allreduce(
                blocks_pp, state["residual"], codec, state["participating"])
            del blocks_pp
            grads = blocks_to_tree(ghat, layout)
            return finish(state, grads, new_residual, torch.stack(losses).mean())

        return auto_step

    rank = mesh.check_group("pod")
    group = mesh.group("pod")
    pods = mesh.shape["pod"]

    def pod_step(state, batch):
        if state["residual"].shape[0] != 1:
            raise ValueError(
                f"impl='shard_map' takes this pod's (1, nb, N) residual, got "
                f"{tuple(state['residual'].shape)} (init_train_state(..., impl='shard_map'))")
        loss, grads = value_and_grad(state["params"], _pod_batch(batch, pods, rank), cfg)
        blocks, layout, _ = flatten_to_blocks(grads, n, row_multiple=_ROW_MULTIPLE)
        del grads
        ghat, new_residual = fedqcs_pod_allreduce(
            blocks, state["residual"][0], codec, group=group,
            participating=state["participating"][rank])
        del blocks
        grads = blocks_to_tree(ghat, layout)
        loss_mean = all_reduce(loss, group) / pods
        return finish(state, grads, new_residual[None], loss_mean)

    return pod_step


# ---------------------------------------------------------------------------
# the in-pod program: one process per device of a (pod, data, model) mesh
# ---------------------------------------------------------------------------

ITEM_WIDE_MODEL_AXIS = "item 10g"  # counts only the production mesh's 16-way axis meets
_VOCAB_TABLES = ("embed", "lm_head")  # held whole over model where it does not divide V


def _check_inpod(cfg: ModelConfig, opt_cfg: Optional[adam.OptConfig], mesh) -> list:
    """Returns the parameters' (path, sanitized spec, meta leaf) items: a
    leaf dimension the mesh does not divide is held whole along that axis
    (the reference's ``sanitize_spec``), which the layers take for the
    vocabulary tables (``models/common.py``).  Raises for a head or expert
    count, or another leaf dimension, that the ``model`` axis does not
    divide."""
    model = mesh.shape["model"]
    counts = [("query", cfg.n_heads), ("KV", cfg.n_kv_heads)]
    if cfg.family in ("ssm", "hybrid"):
        counts.append(("SSM", cfg.ssm_heads))
    for kind, count in counts:
        if count % model:
            raise not_in_slice(f"{count} {kind} heads over a {model}-way model axis",
                               ITEM_WIDE_MODEL_AXIS)
    if cfg.is_moe and cfg.n_experts % model:
        raise not_in_slice(f"{cfg.n_experts} experts over a {model}-way model axis",
                           ITEM_WIDE_MODEL_AXIS)
    params = abstract_params(cfg)
    items = _param_spec_items(params, mesh)
    rules = param_specs(params, axis_sizes=dict(mesh.shape))
    for path, spec, _ in items:
        dropped = {a for want, got in zip(tree_util.get(rules, path), spec) if got is None
                   for a in spec_axes(want)}
        if "model" in dropped and path[-1] not in _VOCAB_TABLES:
            raise not_in_slice(f"params{tree_util.keystr(path)}: a dimension the {model}-way "
                               "model axis does not divide", ITEM_WIDE_MODEL_AXIS)
    return items


def state_specs(cfg: ModelConfig, opt_cfg: adam.OptConfig, fed_cfg: Optional[FedQCSConfig],
                mesh, impl: str = "auto"):
    """The specs of the whole train state on ``mesh`` (its
    :func:`train_state_shardings`): what each rank's in-pod state is a
    shard of."""
    whole = _whole_state(cfg, opt_cfg, fed_cfg, 0, mesh.shape["pod"], torch.device("meta"),
                         mesh, "auto" if impl == "shard_map" else impl, None)
    return whole, train_state_shardings(whole, mesh, fed_cfg is not None)


def _coords(mesh) -> dict:
    return mesh.coords() if getattr(mesh, "rank", None) is not None else {}


def opt_shards(cfg: ModelConfig, mesh) -> dict:
    """Where each parameter's shard lies in its whole leaf on an in-pod
    mesh (path -> :class:`~repro_torch.optim.adam.Shard`): what a rank's
    int8 moments take their whole-leaf block scales over (a mesh made
    outside its world: rank 0's place, no groups)."""
    items = _param_spec_items(abstract_params(cfg), mesh)
    c = {a: 0 for a in mesh.shape} | _coords(mesh)
    world = getattr(mesh, "rank", None) is not None
    keys = {frozenset(("data",)): "data", frozenset(("model",)): "model",
            frozenset(("data", "model")): ("data", "model")}
    out = {}
    for path, spec, leaf in items:
        start, axes = [], set()
        for dim, entry in enumerate(spec):
            count, index = 1, 0
            for a in spec_axes(entry):
                count, index = count * mesh.shape[a], index * mesh.shape[a] + c[a]
                if mesh.shape[a] > 1:
                    axes.add(a)
            start.append(index * (leaf.shape[dim] // count))
        group = mesh.group(keys[frozenset(axes)]) if axes and world else None
        out[path] = adam.Shard(tuple(leaf.shape), tuple(start), group)
    return out


def shard_state(state, specs, mesh):
    """This rank's shard of a whole state (each leaf by its spec; a
    ``QLeaf``'s codes by its parameter's, its block scales whole)."""
    coords = _coords(mesh)
    return tree_util.unflatten(
        (path, local_shard(leaf, tree_util.get(specs, path), mesh.shape, coords))
        for path, leaf in tree_util.leaves_in_order(state))


def gather_state(state, specs, mesh):
    """The whole state on every rank from each rank's shard (a collective:
    every rank calls it)."""
    return tree_util.unflatten((path, gather_leaf(leaf, tree_util.get(specs, path), mesh))
                               for path, leaf in tree_util.leaves_in_order(state))


def _init_inpod_state(cfg, opt_cfg, fed_cfg, seed, abstract, mesh, impl, device, params):
    _check_inpod(cfg, opt_cfg, mesh)
    dev = torch.device("meta") if abstract else entry_device(device)
    whole, specs = state_specs(cfg, opt_cfg, fed_cfg, mesh, impl)
    if params is None:
        params = model_api.init_params(cfg, seed, dev)
    coords = _coords(mesh)
    params = tree_util.unflatten(
        (path, local_shard(leaf, tree_util.get(specs["params"], path), mesh.shape, coords))
        for path, leaf in tree_util.leaves_in_order(params))
    state = {"params": params,
             "opt": adam.init_state(opt_cfg, params, shards=opt_shards(cfg, mesh)),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if fed_cfg is not None:
        _, rows, n = whole["residual"].shape
        dm = mesh.shape["data"] * mesh.shape["model"]
        state["residual"] = torch.zeros((1, rows // dm, n), dtype=torch.float32, device=dev)
        state["participating"] = torch.ones((mesh.shape["pod"],), dtype=torch.float32,
                                            device=dev)
    return state


def local_batch(batch, mesh):
    """This rank's share of a whole batch: the batch dimension (dim 0; the
    VLM's ``positions``' dim 1) split over (pod, data), chunk ``pod * data +
    d`` -- each pod's half as ``impl="auto"`` splits it, then the pod's
    share over ``data``."""
    c = mesh.coords()
    count = mesh.shape["pod"] * mesh.shape["data"]
    index = c["pod"] * mesh.shape["data"] + c["data"]

    def share(name, v):
        dim = 1 if name == "positions" else 0
        if v.shape[dim] % count:
            raise ValueError(f"batch[{name!r}] has {v.shape[dim]} rows along dim {dim}: "
                             f"not a multiple of pod x data = {count}")
        return v.chunk(count, dim=dim)[index]

    return {k: share(k, v) for k, v in batch.items()}


class _PodRows:
    """The pod's monolithic blocking (the reference's ``flatten_to_blocks``,
    rows padded to 512) split over its ``data * model`` ranks: rank ``r = d
    * model + m`` of the pod holds rows ``[r * rows_local, (r + 1) *
    rows_local)``.  Leaf by leaf, a leaf's gradient shards are gathered
    over the pod and the rank keeps the part in its rows; back, each rank
    puts its rows' part of a leaf in a zero leaf, a sum over the pod makes
    the whole leaf and the rank keeps its shard.  One whole leaf lives at
    a time."""

    def __init__(self, items, n: int, mesh):
        self.items, self.n, self.mesh = [], n, mesh
        offset = 0
        for path, spec, leaf in items:
            self.items.append((path, spec, tuple(leaf.shape), leaf.dtype, offset))
            offset += leaf.numel()
        rows = -(-offset // n)
        rows = -(-rows // _ROW_MULTIPLE) * _ROW_MULTIPLE
        dm = mesh.shape["data"] * mesh.shape["model"]
        self.rows_local = rows // dm
        c = mesh.coords()
        self.lo = (c["data"] * mesh.shape["model"] + c["model"]) * self.rows_local * n
        self.hi = self.lo + self.rows_local * n
        self.coords = c
        self.group = mesh.group(("data", "model"))

    def _span(self, offset: int, size: int):
        return max(offset, self.lo), min(offset + size, self.hi)

    def to_rows(self, grads, device) -> torch.Tensor:
        out = torch.zeros(self.rows_local * self.n, dtype=torch.float32, device=device)
        for path, spec, shape, _, offset in self.items:
            whole = gather_leaf(tree_util.get(grads, path), spec, self.mesh).reshape(-1)
            a, b = self._span(offset, whole.numel())
            if a < b:
                out[a - self.lo:b - self.lo] = whole[a - offset:b - offset]
            del whole
        return out.view(self.rows_local, self.n)

    def to_tree(self, rows: torch.Tensor):
        flat = rows.reshape(-1)
        out = []
        for path, spec, shape, dtype, offset in self.items:
            size = int(torch.Size(shape).numel())
            part = torch.zeros(size, dtype=torch.float32, device=rows.device)
            a, b = self._span(offset, size)
            if a < b:
                part[a - offset:b - offset] = flat[a - self.lo:b - self.lo]
            whole = all_reduce(part, self.group).view(shape)
            out.append((path, local_shard(whole, spec, self.mesh.shape, self.coords).to(dtype)))
            del part, whole
        return tree_util.unflatten(out)


def _vocab_whole(items) -> bool:
    """Whether the vocabulary tables are held whole over ``model`` (their
    sanitized specs dropped the axis)."""
    return any(path[-1] in _VOCAB_TABLES and "model" not in sum(map(spec_axes, spec), ())
               for path, spec, _ in items)


def pod_value_and_grad(params, batch, cfg: ModelConfig, mesh, items=None,
                       dispatch_axes=("data",)):
    """An in-pod rank's (pod loss, gradient shards): the loss is the mean
    over the pod's tokens (the same on the pod's ranks) and each leaf's
    gradient is the rank's shard of the pod's gradient.  ``batch`` is the
    whole batch; ``params`` the rank's shards; ``dispatch_axes`` the
    tokens one MoE dispatch covers (:class:`InPod`).  The layers'
    collectives leave every gradient whole over ``model``
    (``models/sharding.py``); a leaf ``data`` does not split holds the
    rank's tokens' part, summed over ``data`` here (once, however many
    times the leaf was used)."""
    items = items if items is not None else _check_inpod(cfg, None, mesh)
    with use_inpod(InPod(mesh, _vocab_whole(items), dispatch_axes)):
        loss, grads = value_and_grad(params, local_batch(batch, mesh), cfg)
    out = []
    for path, spec, _ in items:
        g = tree_util.get(grads, path)
        if mesh.shape["data"] > 1 and not any("data" in spec_axes(e) for e in spec):
            g = all_reduce(g, mesh.group("data"))  # the rank's tokens' part
        out.append((path, g))
    return loss, tree_util.unflatten(out)


def _make_inpod_step(cfg, opt_cfg, fed_cfg, mesh, impl, device, a):
    """The per-rank step of an in-pod mesh (see the module docstring)."""
    items = _check_inpod(cfg, opt_cfg, mesh)
    if impl not in ("auto", "auto_sharded", "shard_map"):
        raise ValueError(f"unknown impl {impl!r} (auto | auto_sharded | shard_map)")
    c = mesh.coords()
    pods = mesh.shape["pod"]
    pod_group = mesh.group("pod")
    inner = mesh.group(("data", "model"))
    # a leaf counts once in the global norm: on the rank at index 0 of
    # each in-pod axis it is replicated over
    owned = {path: all(c[ax] == 0 for ax in ("data", "model")
                       if not any(ax in spec_axes(e) for e in spec))
             for path, spec, _ in items}

    def grads_of(state, batch, dispatch_axes=("data",)):
        return pod_value_and_grad(state["params"], batch, cfg, mesh, items, dispatch_axes)

    def norm_sq(grads):
        leaves = tree_util.leaves_in_order(grads)
        local = torch.zeros((), dtype=torch.float32, device=leaves[0][1].device)
        for path, g in leaves:
            if owned[path]:
                local = local + torch.sum(g.float() * g.float())
        return all_reduce(local, inner)

    shards = opt_shards(cfg, mesh)

    def finish(state, grads, loss, extra):
        new_params, new_opt = adam.update(opt_cfg, grads, state["opt"], state["params"],
                                          int(state["step"]), norm_sq=norm_sq, shards=shards)
        loss = all_reduce(loss, pod_group) / pods
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1,
                **extra}, {"loss": loss}

    if fed_cfg is None:
        def base_step(state, batch):  # the whole batch's program, as the reference's
            loss, grads = grads_of(state, batch, ("pod", "data"))
            if pods > 1:
                grads = tree_util.tree_map(
                    lambda g: (all_reduce(g.float(), pod_group) / pods).to(g.dtype), grads)
            return finish(state, grads, loss, {})

        return base_step

    if impl == "auto_sharded":
        if fed_cfg.recon_mode == "ea":
            raise ValueError(SHARDED_EA_ERROR)
        _, nbar_local, local_shapes, _ = shard_block_geometry(cfg, fed_cfg, mesh)
        layout = GradientLayout.from_shapes(
            tuple(f"{i:06d}" for i in range(len(local_shapes))),
            [(tuple(s), torch.float32) for s in local_shapes], fed_cfg.block_size)
        paths = [path for path, _, _ in items]
        wire = "psum_dequant"

        def to_blocks(grads, device):
            return layout.to_blocks(dict(zip(layout.treedef,
                                             (tree_util.get(grads, p) for p in paths))))

        def to_tree(ghat):
            tree = layout.tree_from_blocks(ghat)
            return tree_util.unflatten(zip(paths, (tree[k] for k in layout.treedef)))
    else:
        rows = _PodRows(items, fed_cfg.block_size, mesh)
        to_blocks, to_tree = rows.to_rows, rows.to_tree
        if impl == "auto":  # the reference's auto: dequantized sums (AE), words (EA)
            wire = "gather_codes" if fed_cfg.recon_mode == "ea" else "psum_dequant"
        else:
            wire = fed_cfg.wire_mode
    codec = BQCSCodec(dataclasses.replace(fed_cfg, wire_mode=wire), a=a, device=device)

    def fed_step(state, batch):
        loss, grads = grads_of(state, batch)
        blocks = to_blocks(grads, state["residual"].device)
        del grads
        ghat, new_residual = fedqcs_pod_allreduce(
            blocks, state["residual"][0], codec, group=pod_group,
            participating=state["participating"][c["pod"]])
        del blocks
        return finish(state, to_tree(ghat), loss,
                      {"residual": new_residual[None],
                       "participating": state["participating"]})

    return fed_step


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def _serve_context(cfg: ModelConfig, mesh, dispatch_axes) -> Optional[InPod]:
    """The rank's in-pod context of a serve step on ``mesh`` (None off the
    mesh); raises for a family the in-pod serve steps do not run, and for a
    mesh made outside its world."""
    if mesh is None or not mesh.inpod:
        return None
    model_api.check_mesh_serve(cfg)
    return InPod(mesh, _vocab_whole(_check_inpod(cfg, None, mesh)), dispatch_axes)


def serve_specs(cfg: ModelConfig, mesh, kind: str) -> dict:
    """The specs of an in-pod serve step's outputs (``kind``: ``prefill``
    or ``decode``): ``logits`` (B, 1, V) -- the rows over ``(pod, data)``
    (prefill) or ``data`` (decode), the vocabulary over ``model`` unless
    the tables are held whole -- and the decode's ``next_tok`` (B, 1).
    ``gather_leaf(out, spec, mesh)`` puts an output back together."""
    vocab = None if _vocab_whole(_check_inpod(cfg, None, mesh)) else "model"
    rows = ("pod", "data") if kind == "prefill" else "data"
    return {"logits": (rows, None, vocab), "next_tok": (rows, None)}


def make_prefill_step(cfg: ModelConfig, mesh):
    """Returns ``prefill_fn(params, batch, smax=None) -> (last-position
    logits, cache)``, run under ``torch.inference_mode()``: the cache has
    ``smax`` slots on each self-attention leaf (None: the prompt's length;
    the audio family's: its frame count).

    On an in-pod mesh (the transformer family) ``params`` are the rank's
    shards (:func:`shard_state` of the parameters) and ``batch`` the whole
    prompt, of which the rank runs its rows over ``(pod, data)``
    (:func:`local_batch`) -- the reference's one program over the batch
    (an MoE layer dispatches the whole batch's tokens).  The logits are the
    rank's rows and vocabulary columns; the cache is the rank's shard
    (:func:`~repro_torch.models.sharding.cache_spec`: the rows of its
    ``data`` share, the slots ``[m * smax / model, (m + 1) * smax /
    model)``)."""
    ip = _serve_context(cfg, mesh, ("pod", "data"))

    def prefill_fn(params, batch, smax=None):
        if cfg.family == "audio":
            smax = smax or batch["frames"].shape[1]
        with torch.inference_mode(), use_inpod(ip):
            return model_api.prefill(params, batch if ip is None else local_batch(batch, mesh),
                                     cfg, smax)

    return prefill_fn


def make_decode_step(cfg: ModelConfig, mesh, donate: bool = True):
    """Returns ``decode_fn(params, cache, tokens, pos) -> (next_tok, logits,
    new_cache)``, run under ``torch.inference_mode()``: ``next_tok`` (B, 1)
    is the greedy token (the first index wins a tie).  ``donate=True``
    writes the new K/V (or SSM states) into ``cache`` itself and returns it (the
    counterpart of the reference's buffer donation); ``donate=False``
    leaves ``cache`` as it was.

    On an in-pod mesh (the transformer family) ``cache`` is the rank's
    shard (:func:`make_prefill_step`'s, or ``model.init_cache(...,
    mesh=)``) and ``tokens`` the whole (B, 1) or the rank's rows: the rank
    decodes the rows of its ``data`` share (the same on every pod) over its
    slots, every query head's partials combined over ``model`` (split-KV);
    an MoE layer dispatches the step's B tokens.  ``next_tok`` is the
    rank's rows (the same on every ``model`` rank), the logits its rows
    and vocabulary columns, the cache its shard."""
    ip = _serve_context(cfg, mesh, ("data",))

    def decode_fn(params, cache, tokens, pos):
        if ip is not None and tokens.shape[0] != next(iter(cache.values())).shape[1]:
            tokens = tokens.chunk(mesh.shape["data"])[ip.coords["data"]]  # the rank's rows
        with torch.inference_mode(), use_inpod(ip):
            logits, new_cache = model_api.decode_step(params, cache, tokens, pos, cfg,
                                                      inplace=donate)
            return greedy_tokens(logits[:, -1])[:, None], logits, new_cache

    return decode_fn


# ---------------------------------------------------------------------------
# input shardings (the reference's specs, as spec tuples)
# ---------------------------------------------------------------------------


def _bd(mesh):
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _even(dim: int, mesh, axes) -> bool:
    size = _axis_size(axes, mesh)
    return dim % size == 0 and dim >= size


def batch_shardings(cfg: ModelConfig, shape: str, mesh):
    """The specs of :func:`~repro_torch.models.model.input_specs`'s inputs on
    ``mesh``: the batch dimension over (pod, data) where it divides (the
    VLM's ``positions`` carry it second), a decode cache by
    :func:`_cache_spec`, a scalar replicated.  :func:`local_batch` takes a
    rank's share of a train batch."""
    specs = model_api.input_specs(cfg, shape)
    bd = _bd(mesh)

    def spec_for(path, leaf):
        name = tree_util.slash(path).lower()
        shp = tuple(leaf.shape)
        if not shp:
            return ()
        if "positions" in name:
            return (None, bd if _even(shp[1], mesh, bd) else None) + (None,) * (len(shp) - 2)
        if name.startswith("cache"):
            return _cache_spec(name, shp, mesh)
        return (bd if _even(shp[0], mesh, bd) else None,) + (None,) * (len(shp) - 1)

    return tree_util.unflatten((path, spec_for(path, leaf))
                               for path, leaf in tree_util.leaves_in_order(specs))


def _cache_spec(name: str, shp, mesh) -> tuple:
    """The reference's KV/state cache layout
    (:func:`~repro_torch.models.sharding.cache_spec`): batch over ``data``,
    the sequence (split-KV decode) or the SSM heads / conv channels over
    ``model``.  The in-pod serve steps place the transformer family's
    cache by it."""
    return cache_spec(name, shp, mesh.shape)
