"""Rank body of tests/test_torch_inpod.py's eight-process ``gloo`` world.

Each rank of the port's ``make_debug_mesh(2, 2, 2)`` runs every scenario
of the in-pod program on the CPU, from whole states the test process wrote
(the reference's, converted), and returns what it computed: its loss, its
residual shard and (rank 0) the gathered parameters.  It imports torch and
``repro_torch`` only, so a spawned rank starts without JAX.

Scenarios (``inp`` is the test process's input dict):
  * ``grads``: the pod's loss and gradient at the initial parameters
    (gathered over the pod);
  * ``auto``, ``ea``, ``partial``, ``baseline``, ``sharded0`` and
    ``sharded1``: one ``make_train_step`` step each from the reference's
    state before it (``partial``: pod 1 dead; ``sharded1``: the second
    ``auto_sharded`` step);
  * ``remat``: ``sharded0`` with the layers recomputed in the backward;
  * ``shard_map``: ``impl="shard_map"`` (the packed words gathered) from
    the ``auto`` state;
  * ``ckpt``: the reference's state after its first ``auto`` step saved
    from the shards (rank 0 writes), a step from the initial state saved
    and continued one more step, then restored from its checkpoint and
    replayed;
  * ``families``: for each of ``inp["families"]`` (a smoke model of the
    SSM, hybrid, MoE, MLA, VLM or audio family, its config's changes, its
    batch and its scenarios), its pod gradient and the steps it names as
    above (``int8``: an ``auto`` step with int8 moments; ``ckpt``: a
    restart replayed);
  * ``serve``: for each of ``inp["serve"]``'s smoke models (seed 0's
    parameters, :func:`serve_batch`'s prompt), the in-pod
    ``make_prefill_step`` into a cache of ``SERVE_SMAX`` slots and
    ``SERVE_STEPS`` greedy ``make_decode_step`` steps from it (the tokens
    gathered over ``data`` between steps): the rank's logits, cache shard
    (and the prefill's whole cache, gathered) and ``next_tok`` after each,
    and the first step's donation (in place) beside ``donate=False`` (the
    cache left as it was);
  * ``int8``: the dense model with int8 Adam states: one ``auto`` step from
    the reference's int8 state; ``update``: Adam on the rank's shards of
    the reference's state after that step against Adam on the whole leaves
    (the same gradient and clip), the rank's ``QLeaf``s and parameters
    against their shards of the whole's, bit for bit; ``ckpt``: the
    reference's state after its step saved from the shards (for the test
    process's restore onto one device), and a restart replayed.
"""

import dataclasses
import os


def run(rank, world, device, inp, ckpt_dir):
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.sharding import gather_leaf
    from repro_torch.optim.adam import OptConfig
    from repro_torch.runtime import steps

    cfg = smoke_config("qwen3-0.6b")
    fed = FedQCSConfig(**inp["fed_kw"])
    opt = OptConfig(**inp["opt_kw"])
    mesh = make_debug_mesh(2, 2, 2)
    a = inp["a"]
    out = {"coords": mesh.coords()}

    def run_step(name, state, batch, impl="auto", fed_cfg=fed, model_cfg=cfg):
        whole, specs = steps.state_specs(model_cfg, opt, fed_cfg, mesh, impl)
        fn = steps.make_train_step(model_cfg, opt, fed_cfg, mesh, impl=impl, device=device,
                                   a=a)
        new, m = fn(steps.shard_state(state, specs, mesh), batch)
        gathered = steps.gather_state(new, specs, mesh)
        out[name] = {"loss": float(m["loss"]), "residual": new.get("residual"),
                     "state": gathered if rank == 0 else None}
        return new, specs

    # the pod's gradient at the initial parameters
    _, specs = steps.state_specs(cfg, opt, fed, mesh)
    params = steps.shard_state(inp["init"]["params"], specs["params"], mesh)
    loss, grads = steps.pod_value_and_grad(params, inp["batches"][0], cfg, mesh)
    out["grads"] = {"loss": float(loss), "grads": tree_util.unflatten(
        (path, gather_leaf(g, tree_util.get(specs["params"], path), mesh))
        for path, g in tree_util.leaves(grads))}

    out["families"] = {label: _family(label, fam, inp, mesh, opt, fed, a, device, rank,
                                      ckpt_dir)
                       for label, fam in inp["families"].items()}
    out["int8"] = _int8(inp, mesh, fed, a, device, rank, os.path.join(ckpt_dir, "int8"))
    out["serve"] = {arch: serve(arch, mesh, device) for arch in inp["serve"]}
    out["greedy_ties"] = greedy_ties(mesh)

    run_step("auto", inp["init"], inp["batches"][0])
    run_step("ea", inp["init"], inp["batches"][0],
             fed_cfg=dataclasses.replace(fed, recon_mode="ea", use_kernels=True))
    run_step("partial", dict(inp["init"], participating=torch.tensor([1.0, 0.0])),
             inp["batches"][0])
    base = {k: v for k, v in inp["init"].items() if k not in ("residual", "participating")}
    run_step("baseline", base, inp["batches"][0], fed_cfg=None)
    run_step("sharded0", inp["sharded_init"], inp["batches"][0], impl="auto_sharded")
    run_step("sharded1", inp["sharded_after"], inp["batches"][1], impl="auto_sharded")
    run_step("remat", inp["sharded_init"], inp["batches"][0], impl="auto_sharded",
             model_cfg=dataclasses.replace(cfg, remat_policy="full"))
    run_step("shard_map", inp["init"], inp["batches"][0], impl="shard_map")

    # checkpoints: the reference's state saved from the shards; a restart
    ckpt = Checkpointer(ckpt_dir, keep=4, async_save=False)
    ckpt.save(1, steps.shard_state(inp["auto_after"], specs, mesh), specs=specs, mesh=mesh)
    out["ckpt"] = _restart(ckpt, cfg, opt, fed, mesh, inp["init"], inp["batches"], device, a)
    return out


def _restart(ckpt, cfg, opt, fed, mesh, state, batches, device, a):
    """The whole ``state``'s shards stepped on ``batches[0]`` and saved as
    step 2, then stepped on ``batches[1]``; the save restored into the
    shards and replayed on ``batches[1]``: the step restored and whether
    the replay is the run that went on, bit for bit (a ``QLeaf`` field by
    field)."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.runtime import steps

    whole, specs = steps.state_specs(cfg, opt, fed, mesh)
    fn = steps.make_train_step(cfg, opt, fed, mesh, device=device, a=a)
    state, _ = fn(steps.shard_state(state, specs, mesh), batches[0])
    ckpt.save(2, state, specs=specs, mesh=mesh)
    cont, _ = fn(state, batches[1])
    torch.distributed.barrier()
    restored, at = ckpt.restore(whole, step=2, specs=specs, mesh=mesh, device=device)
    replay, _ = fn(restored, batches[1])
    flat = lambda t: [x for _, v in tree_util.leaves(t)  # noqa: E731
                      for x in (v if isinstance(v, tuple) else (v,))]
    return {"step": at, "same": all(torch.equal(x, y) for x, y in zip(flat(cont), flat(replay)))}


def _step(name, out, cfg, opt, fed, mesh, state, batch, device, a, rank, impl="auto"):
    """One in-pod step of ``cfg`` from the whole ``state``: its loss, the
    rank's residual, the gradient rows it sent (``blocks``: its rows of the
    pod's gradient plus its carry) and (rank 0) the gathered state go into
    ``out[name]``; returns the rank's new state and the specs."""
    from repro_torch.runtime import steps

    whole, specs = steps.state_specs(cfg, opt, fed, mesh, impl)
    fn = steps.make_train_step(cfg, opt, fed, mesh, impl=impl, device=device, a=a)
    seen, pod_allreduce = {}, steps.fedqcs_pod_allreduce

    def capture(blocks, residual, *args, **kw):
        seen["blocks"] = blocks + residual
        return pod_allreduce(blocks, residual, *args, **kw)

    steps.fedqcs_pod_allreduce = capture
    try:
        new, m = fn(steps.shard_state(state, specs, mesh), batch)
    finally:
        steps.fedqcs_pod_allreduce = pod_allreduce
    gathered = steps.gather_state(new, specs, mesh)
    out[name] = {"loss": float(m["loss"]), "residual": new.get("residual"),
                 "blocks": seen.get("blocks"), "state": gathered if rank == 0 else None}
    return new, specs


def _pod_grads(cfg, opt, fed, mesh, params, batch):
    """The pod's loss and gradient at the whole ``params``, gathered."""
    from repro_torch import tree as tree_util
    from repro_torch.models.sharding import gather_leaf
    from repro_torch.runtime import steps

    _, specs = steps.state_specs(cfg, opt, fed, mesh)
    local = steps.shard_state(params, specs["params"], mesh)
    loss, grads = steps.pod_value_and_grad(local, batch, cfg, mesh)
    return {"loss": float(loss), "grads": tree_util.unflatten(
        (path, gather_leaf(g, tree_util.get(specs["params"], path), mesh))
        for path, g in tree_util.leaves(grads))}


def _family(label, fam, inp, mesh, opt, fed, a, device, rank, ckpt_dir):
    """One smoke model's scenarios (see the module docstring): ``fam`` holds
    its ``arch``, the smoke config's ``overrides``, its ``batch``, its
    ``scenarios`` and the whole states they start from (``init``;
    ``sharded_init``, ``int8_init`` where named)."""
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import smoke_config

    cfg = dataclasses.replace(smoke_config(fam["arch"]), **fam["overrides"])
    batch = fam["batch"]
    init = fam["init"]
    out = {"grads": _pod_grads(cfg, opt, fed, mesh, init["params"], batch)}
    runs = {  # scenario -> (the whole state it starts from, _step's arguments)
        "auto": lambda: (init, {}),
        "ea": lambda: (init, {"fed": dataclasses.replace(fed, recon_mode="ea",
                                                         use_kernels=True)}),
        "partial": lambda: (dict(init, participating=torch.tensor([1.0, 0.0])), {}),
        "baseline": lambda: ({k: v for k, v in init.items()
                              if k not in ("residual", "participating")}, {"fed": None}),
        "sharded0": lambda: (fam["sharded_init"], {"impl": "auto_sharded"}),
        "shard_map": lambda: (init, {"impl": "shard_map"}),
        "int8": lambda: (fam["int8_init"],
                         {"opt": dataclasses.replace(opt, state_dtype="int8")}),
    }
    for name in fam["scenarios"]:
        if name == "ckpt":
            ckpt = Checkpointer(os.path.join(ckpt_dir, label), keep=4, async_save=False)
            out["ckpt"] = _restart(ckpt, cfg, opt, fed, mesh, init, [batch, batch], device, a)
            continue
        state, kw = runs[name]()
        kw = {"opt": opt, "fed": fed, **kw}
        _step(name, out, cfg, kw.pop("opt"), kw.pop("fed"), mesh, state, batch, device, a, rank,
              **kw)
    return out


def _int8(inp, mesh, fed, a, device, rank, ckpt_dir):
    """The dense model's int8 scenarios (see the module docstring)."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models.sharding import local_shard
    from repro_torch.optim import adam
    from repro_torch.runtime import steps

    cfg = smoke_config("qwen3-0.6b")
    opt = adam.OptConfig(**inp["opt_kw"], state_dtype="int8")
    batches, after = inp["batches"], inp["int8_after"]
    out = {}
    _step("step", out, cfg, opt, fed, mesh, inp["int8_init"], batches[0], device, a, rank)

    # Adam on the rank's shards against Adam on the whole leaves
    _, specs = steps.state_specs(cfg, opt, fed, mesh)
    grads = _pod_grads(cfg, opt, fed, mesh, after["params"], batches[1])["grads"]
    norm = torch.sum(torch.stack([torch.sum(g * g) for _, g in tree_util.leaves(grads)]))
    norm_sq = lambda _: norm  # noqa: E731  (one clip for both)
    step = int(after["step"])
    want = adam.update(opt, grads, after["opt"], after["params"], step, norm_sq=norm_sq)
    local = steps.shard_state(after, specs, mesh)
    got = adam.update(opt, steps.shard_state(grads, specs["params"], mesh), local["opt"],
                      local["params"], step, norm_sq=norm_sq,
                      shards=steps.opt_shards(cfg, mesh))
    sizes, c = mesh.shape, mesh.coords()
    checked, differ = 0, []
    for tree, spec_tree, mine, name in ((want[0], specs["params"], got[0], "params"),
                                        (want[1], specs["opt"], got[1], "opt")):
        for path, leaf in tree_util.leaves(tree):
            cut = local_shard(leaf, tree_util.get(spec_tree, path), sizes, c)
            have = tree_util.get(mine, path)
            pairs = zip(cut, have) if isinstance(cut, tuple) else [(cut, have)]
            checked += 1
            if not all(torch.equal(x, y) for x, y in pairs):
                differ.append((name,) + path)
    out["update"] = {"leaves": checked, "differ": differ}
    out["scale_lengths"] = sorted({int(q.scale.numel()) for _, q in tree_util.leaves(
        got[1]["m"])})

    # checkpoints: the reference's state after its step; a restart
    ckpt = Checkpointer(ckpt_dir, keep=4, async_save=False)
    ckpt.save(1, steps.shard_state(after, specs, mesh), specs=specs, mesh=mesh)
    out["ckpt"] = _restart(ckpt, cfg, opt, fed, mesh, after, batches[::-1], device, a)
    return out


def fail_on_rank_3(rank, world, device):
    """Rank 3 raises; the others wait in a barrier until the world stops."""
    import torch.distributed as dist

    if rank == 3:
        raise ValueError("rank 3 fails")
    dist.barrier()


def family_batch(cfg):
    """The 16 rows of a smoke model's train batch the in-pod tests take, on
    the CPU: the token data's 16 x 32 (seed 7's first batch); the VLM's 24
    text tokens after 8 patch embeddings, with M-RoPE streams (t; h and w
    over a 2 x 4 patch grid, then the text's shared positions); Whisper's
    24 frames and 12 text tokens."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import TokenDataset

    if cfg.family not in ("vlm", "audio"):
        return TokenDataset(cfg.vocab_size, batch=16, seq=32, seed=7).get_batch(0, device="cpu")
    rng = np.random.default_rng(11)
    b, st, extra = (16, 24, 8) if cfg.family == "vlm" else (16, 12, 24)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, st)),
             "labels": rng.integers(0, cfg.vocab_size, (b, st))}
    rows = (rng.normal(size=(b, extra, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rows
    else:
        batch["patches"] = rows
        text = np.arange(st) + 4
        streams = np.stack([np.r_[np.zeros(extra), text], np.r_[np.arange(extra) // 4, text],
                            np.r_[np.arange(extra) % 4, text]]).astype(np.int64)
        batch["positions"] = np.broadcast_to(streams[:, None], (3, b, extra + st))
    return {k: torch.tensor(np.array(v, np.int64 if v.dtype.kind in "iu" else np.float32))
            for k, v in batch.items()}


def one_step(rank, world, device, impl, fed_kw, arch="qwen3-0.6b", state_dtype="float32"):
    """One step of ``arch``'s smoke model on the (2, 2, 2) mesh from seed
    0's state (``fed_kw`` None: the baseline; ``state_dtype``: Adam's
    moments) on :func:`family_batch`: the loss, this rank's residual, the
    gradient rows it sent and the encoder launches on the host, rank 0's
    gathered parameters."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.kernels import bqcs_encode_fused
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.adam import OptConfig
    from repro_torch.runtime import steps

    cfg = smoke_config(arch)
    opt = OptConfig(lr=3e-3, warmup_steps=2, decay_steps=100, state_dtype=state_dtype)
    fed = None if fed_kw is None else FedQCSConfig(**fed_kw)
    mesh = make_debug_mesh(2, 2, 2)
    state = steps.init_train_state(cfg, opt, fed, 0, mesh=mesh, impl=impl, device=device)
    fn = steps.make_train_step(cfg, opt, fed, mesh, impl=impl, device=device)
    bqcs_encode_fused.launches = 0
    seen, pod_allreduce = {}, steps.fedqcs_pod_allreduce

    def capture(blocks, residual, *args, **kw):
        seen["blocks"] = blocks + residual
        return pod_allreduce(blocks, residual, *args, **kw)

    steps.fedqcs_pod_allreduce = capture
    try:
        new, m = fn(state, {k: v.to(device) for k, v in family_batch(cfg).items()})
    finally:
        steps.fedqcs_pod_allreduce = pod_allreduce
    params = steps.gather_state(new["params"], steps.state_specs(cfg, opt, fed, mesh, impl)[1]
                                ["params"], mesh)
    to_host = lambda t: None if t is None else t.cpu()
    return {"loss": float(m["loss"]), "residual": to_host(new.get("residual")),
            "blocks": to_host(seen.get("blocks")), "launches": bqcs_encode_fused.launches,
            "params": _host_tree(params) if rank == 0 else None}


def _host_tree(tree):
    from repro_torch import tree as tree_util

    return tree_util.unflatten((p, v.cpu()) for p, v in tree_util.leaves_in_order(tree))


SERVE_B, SERVE_S, SERVE_SMAX, SERVE_STEPS = 8, 6, 16, 5  # decode at slots 6..10 of 16


def serve_batch(cfg):
    """The serve tests' prompt of a smoke model: 8 rows of 6 positions
    (two rows a rank over (pod, data)), token ids from a seed; the VLM's 2
    patch embeddings before 4 text tokens, with M-RoPE streams (t; h and w
    over a 1 x 2 patch grid, then the text's shared positions)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    sv = 2 if cfg.family == "vlm" else 0
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_S - sv)))}
    if sv:
        batch["patches"] = torch.tensor(
            (rng.normal(size=(SERVE_B, sv, cfg.d_model)) * 0.02).astype(np.float32))
        text = np.arange(SERVE_S - sv) + 1
        streams = np.stack([np.r_[np.zeros(sv), text], np.r_[np.zeros(sv), text],
                            np.r_[np.arange(sv), text]]).astype(np.int64)
        batch["positions"] = torch.tensor(np.broadcast_to(
            streams[:, None], (3, SERVE_B, SERVE_S)).copy())
    return batch


def serve(arch, mesh, device):
    """The rank's serve run of ``arch``'s smoke model (see the module
    docstring)."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import model as model_api
    from repro_torch.models.sharding import cache_specs, gather_cache, gather_leaf
    from repro_torch.optim.adam import OptConfig
    from repro_torch.runtime import steps

    cfg = smoke_config(arch)
    _, specs = steps.state_specs(cfg, OptConfig(), None, mesh)
    params = steps.shard_state(model_api.init_params(cfg, 0, device), specs["params"], mesh)
    batch = {k: v.to(device) for k, v in serve_batch(cfg).items()}
    logits, cache = steps.make_prefill_step(cfg, mesh)(params, batch, SERVE_SMAX)
    clone = lambda c: tree_util.tree_map(torch.clone, c)  # noqa: E731
    specs = cache_specs(model_api.init_cache(cfg, SERVE_B, SERVE_SMAX, "meta"), mesh.shape)
    out = {"logits": logits, "cache": clone(cache), "steps": [],
           "whole_cache": gather_cache(cache, specs, mesh)}
    decode = steps.make_decode_step(cfg, mesh)
    keep = steps.make_decode_step(cfg, mesh, donate=False)
    spec = steps.serve_specs(cfg, mesh, "prefill")["logits"]
    tok = torch.argmax(gather_leaf(logits, spec, mesh)[:, -1], dim=-1)[:, None]
    for t in range(SERVE_STEPS):
        pos = SERVE_S + t
        if t == 0:
            before = clone(cache)
            _, _, kept = keep(params, cache, tok, pos)
            out["kept_left_cache"] = all(torch.equal(cache[k], before[k]) for k in cache)
        nxt, logits, new = decode(params, cache, tok, pos)
        if t == 0:
            out["donated_in_place"] = all(new[k] is cache[k] for k in cache)
            out["kept_equals_donated"] = all(torch.equal(kept[k], new[k]) for k in new)
        cache = new
        out["steps"].append({"next_tok": nxt, "logits": logits, "cache": clone(cache)})
        tok = gather_leaf(nxt, steps.serve_specs(cfg, mesh, "decode")["next_tok"], mesh)
    return out


def greedy_ties(mesh):
    """``sharding.greedy_tokens`` over this rank's 8 vocabulary columns of
    16: row 0's best value sits at local column 3 of both ``model`` ranks
    (global 3 and 11), row 1's best on rank 1 only (global 13), row 2
    ties within rank 1 (global 9 and 10): returns the ids on this rank."""
    import torch

    from repro_torch.models.sharding import InPod, greedy_tokens, use_inpod

    m = mesh.coords()["model"]
    logits = torch.zeros(3, 8)
    logits[0, 3] = 2.0
    logits[1, 5] = 1.0 + m
    if m:
        logits[2, 1] = logits[2, 2] = 4.0
    with use_inpod(InPod(mesh, False, ("data",))):
        return greedy_tokens(logits).tolist()


def serve_world(rank, world, device, arch):
    """:func:`serve` of ``arch`` on the (2, 2, 2) mesh as a world's rank
    body, its tensors moved to the host, with the rank's coordinates."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(2, 2, 2)

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, list):
            return [host(v) for v in x]
        return x.cpu() if isinstance(x, torch.Tensor) else x

    return dict(host(serve(arch, mesh, device)), coords=mesh.coords())
