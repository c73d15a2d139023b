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

The steps run on the device the state lives on; the FedQCS codec is made
on ``device``.  The serve steps :func:`make_prefill_step` and
:func:`make_decode_step` run the model's ``prefill`` and ``decode_step``
under ``torch.inference_mode()``.
"""

from __future__ import annotations

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
from repro_torch.models.sharding import param_specs
from repro_torch.optim import adam
from repro_torch.runtime.collectives import (
    all_reduce_sum,
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
    hold instead of drawing one from ``seed`` (held, not copied)."""
    dev = torch.device("meta") if abstract else entry_device(device)
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
    old state."""
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
        loss_mean = all_reduce_sum(loss, group) / pods
        return finish(state, grads, new_residual[None], loss_mean)

    return pod_step


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, mesh):
    """Returns ``prefill_fn(params, batch) -> (last-position logits, cache)``,
    run under ``torch.inference_mode()``.  The audio family's cache has as
    many self-attention slots as the prompt has frames."""

    def prefill_fn(params, batch):
        smax = batch["frames"].shape[1] if cfg.family == "audio" else None
        with torch.inference_mode():
            return model_api.prefill(params, batch, cfg, smax)

    return prefill_fn


def make_decode_step(cfg: ModelConfig, mesh, donate: bool = True):
    """Returns ``decode_fn(params, cache, tokens, pos) -> (next_tok, logits,
    new_cache)``, run under ``torch.inference_mode()``: ``next_tok`` (B, 1)
    is the greedy token (the first index wins a tie).  ``donate=True``
    writes the new K/V (or SSM states) into ``cache`` itself and returns it (the
    counterpart of the reference's buffer donation); ``donate=False``
    leaves ``cache`` as it was."""

    def decode_fn(params, cache, tokens, pos):
        with torch.inference_mode():
            logits, new_cache = model_api.decode_step(params, cache, tokens, pos, cfg,
                                                      inplace=donate)
            next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return next_tok, logits, new_cache

    return decode_fn


def batch_shardings(cfg: ModelConfig, shape: str, mesh):
    """The input specs' placement on a mesh: with one card a pod there is
    nothing to place.  Data and model axes inside a pod: ROADMAP.md item
    10b."""
    raise not_in_slice("input shardings on a multi-card pod (batch_shardings)", "item 10b")
