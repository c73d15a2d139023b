"""Port parity: the dense transformer, its configs, data and sharding rules,
nested parameter trees through the block layout and Adam, the train step's
single-process impls, the checkpointer and the launcher, on the CPU.

The model is the reference's system-test model, ``smoke_config("qwen3-0.6b")``
(2 layers, d_model 64, vocab 256, fp32), with its FedQCS point ``FED``
(N = 256, R = 2, Q = 4, S = 20, 15 scalar-variance GAMP iterations) and
``OptConfig(lr=3e-3, warmup_steps=2, decay_steps=100)``.  The reference's
parameters, sensing matrix and ``TokenDataset`` batches are carried across
(the port draws from torch generators, not threefry: ROADMAP.md item 12).
The reference runs on its single-device mesh with two pods in the state
(its ``test_checkpoint_elastic_resharding`` path), never its 2 x 2 x 2
``impl="shard_map"`` (that aborts inside XLA's SPMD partitioner).

Contracts:
  * loss within 1e-5, every gradient leaf rtol 1e-4 / atol 1e-6;
  * block rows of a nested tree bit-identical (monolithic and per-tensor);
  * a train step from the reference's state before it: loss within 1e-5,
    residual atol 1e-5, parameters within 2 lr (the reference's own
    contract between its impls: one Adam step turns any difference in the
    decoded aggregate's sign into up to 2 lr), for each of three steps.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core.layout import GradientLayout as JLayout  # noqa: E402
from repro.data.synthetic import TokenDataset as JDataset  # noqa: E402
from repro.launch.mesh import make_single_device_mesh as j_single_mesh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import sharding as jshard  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import from_reference, state_from_reference  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core.layout import GradientLayout  # noqa: E402
from repro_torch.data.synthetic import TokenDataset  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import sharding as tshard  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

ARCH = "qwen3-0.6b"
FED_KW = dict(block_size=256, reduction_ratio=2, bits=4, s_ratio=0.08, gamp_iters=15,
              gamp_variance_mode="scalar")
OPT_KW = dict(lr=3e-3, warmup_steps=2, decay_steps=100)
LR = OPT_KW["lr"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    """{key path: leaf} of a reference tree (QLeafs kept whole)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jadam.QLeaf))[0]
    return {tuple(getattr(k, "key", k) for k in p): v for p, v in flat}


def _batch(b):
    return {k: torch.tensor(np.asarray(v, np.int64)) for k, v in b.items()}


def _port_state(ref_state):
    state = state_from_reference(_np(ref_state))
    state["step"] = state["step"].to(torch.int32)
    return state


def _check_step(got_state, got_loss, want_state, want_loss):
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5
    if "residual" in want_state:
        np.testing.assert_allclose(got_state["residual"].numpy(),
                                   np.asarray(want_state["residual"]), rtol=0, atol=1e-5)
    want = _paths(want_state["params"])
    worst = max(float(np.max(np.abs(p.float().numpy() - np.asarray(want[path], np.float32))))
                for path, p in tree_util.leaves(got_state["params"]))
    assert worst <= 2 * LR, worst


@pytest.fixture(scope="module")
def ref():
    """The reference's model, FedQCS and optimizer configs, initial state
    (two pods), first three batches and sensing matrix."""
    cfg = jreg.smoke_config(ARCH)
    fed = jcomp.FedQCSConfig(**FED_KW)
    opt = jadam.OptConfig(**OPT_KW)
    ds = JDataset(cfg.vocab_size, batch=16, seq=32, seed=7)
    state = _ref_init(cfg, opt, fed, j_single_mesh(), "auto")
    return {"cfg": cfg, "fed": fed, "opt": opt, "state": _np(state),
            "batches": [_np(ds.get_batch(i)) for i in range(3)],
            "a": np.asarray(jcomp.BQCSCodec(fed).a)}


@pytest.fixture(scope="module")
def ref_auto(ref):
    """The reference's impl="auto" run: the state after each of 3 steps."""
    fn = jsteps.make_train_step(ref["cfg"], ref["opt"], ref["fed"], j_single_mesh(),
                                donate=False)
    out, state = [], ref["state"]
    for b in ref["batches"]:
        state, m = fn(state, b)
        state = _np(state)
        out.append((state, float(m["loss"])))
    return out


def _ref_init(cfg, opt, fed, mesh, impl):
    """The reference's initial state (two pods), built under one jit."""
    return _np(jax.jit(lambda k: jsteps.init_train_state(cfg, opt, fed, k, n_pods=2, mesh=mesh,
                                                         impl=impl))(jax.random.PRNGKey(0)))


def _port_step(ref, fed_kw=None, opt_kw=None, impl="auto", fed=True):
    cfg = registry.smoke_config(ARCH)
    fed_cfg = tcomp.FedQCSConfig(**{**FED_KW, **(fed_kw or {})}) if fed else None
    opt = tadam.OptConfig(**{**OPT_KW, **(opt_kw or {})})
    return steps.make_train_step(cfg, opt, fed_cfg, tmesh.make_single_device_mesh(),
                                 impl=impl, device="cpu", a=torch.tensor(ref["a"]))


# ---------------------------------------------------------------------------
# configs, parameter trees, data, sharding rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_config_matches_reference(arch):
    assert dataclasses.asdict(registry.get_config(arch)) == dataclasses.asdict(
        jreg.get_config(arch))
    assert dataclasses.asdict(registry.smoke_config(arch)) == dataclasses.asdict(
        jreg.smoke_config(arch))
    assert registry.get_config(arch).param_count() == jreg.get_config(arch).param_count()
    if arch == ARCH:
        assert registry.get_config(arch).param_count() == 595_984_384


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_param_tree_matches_reference(full):
    """Paths, shapes and dtypes of init_params (the full width as meta
    tensors, allocating nothing)."""
    jcfg = jreg.get_config(ARCH) if full else jreg.smoke_config(ARCH)
    tcfg = registry.get_config(ARCH) if full else registry.smoke_config(ARCH)
    want = _paths(jax.eval_shape(lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0)))
    got = tree_util.leaves(tmodel.init_params(tcfg, device="meta" if full else "cpu"))
    assert [p for p, _ in got] == list(want)
    for path, leaf in got:
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).replace("torch.", "") == str(want[path].dtype), path
    if full:
        rows = steps.block_rows(tcfg, tcomp.FedQCSConfig(block_size=255, reduction_ratio=3,
                                                         bits=3, s_ratio=0.05))
        assert rows == 2_337_792  # 596,114,432 scalars / 255, padded to 512


def test_loss_and_gradients_match_reference(ref):
    params = ref["state"]["params"]
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, b, ref["cfg"])))(params, ref["batches"][0])
    loss_t, grads_t = steps.value_and_grad(from_reference(params)[0],
                                           _batch(ref["batches"][0]),
                                           registry.smoke_config(ARCH))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5
    want = _paths(grads_j)
    for path, g in tree_util.leaves(grads_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]), rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))


def _random_like_params(seed=0):
    cfg = jreg.smoke_config(ARCH)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(cfg, k), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def test_nested_layout_block_rows_are_bit_identical():
    """One gradient tree through both packages' monolithic (rows padded to
    512) and per-tensor layouts: the same rows, the same segment names, and
    the inverse gives the tree back."""
    tree_np = _random_like_params()
    tree_t = from_reference(tree_np)[0]
    blocks_j, jl, _ = jcomp.flatten_to_blocks(
        jax.tree_util.tree_map(jnp.asarray, tree_np), 256, row_multiple=512)
    blocks_t, tl, _ = tcomp.flatten_to_blocks(tree_t, 256, row_multiple=512)
    assert tl.rows == jl.rows == 512
    assert np.array_equal(blocks_t.numpy(), np.asarray(blocks_j))
    back = tcomp.blocks_to_tree(blocks_t, tl)
    assert all(torch.equal(a, tree_util.get(back, p)) for p, a in tree_util.leaves(tree_t))
    jpt = JLayout.per_tensor(jax.tree_util.tree_map(jnp.asarray, tree_np), 256, group_scalars=500)
    tpt = GradientLayout.per_tensor(tree_t, 256, group_scalars=500)
    assert [s.name for s in tpt.segments] == [s.name for s in jpt.segments]
    assert "['layers']['attn']['wq']" in {s.name for s in tpt.segments}
    assert np.array_equal(tpt.to_blocks(tree_t).numpy(),
                          np.asarray(jpt.to_blocks(jax.tree_util.tree_map(jnp.asarray, tree_np))))
    batched = {"a": {"b": torch.ones(2, 3), "c": torch.zeros(2, 5)}}
    bb, bl, _ = tcomp.flatten_to_blocks_batched(batched, 4)
    assert bb.shape == (2, 2, 4) and bl.treedef == (("a", "b"), ("a", "c"))


def test_param_specs_match_reference():
    cfg = jreg.smoke_config(ARCH)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(cfg, k), jax.random.PRNGKey(0))
    sizes = {"pod": 2, "data": 2, "model": 2}
    want = _paths(jshard.param_specs(shapes, axis_sizes=sizes))
    got = tshard.param_specs(tmodel.init_params(registry.smoke_config(ARCH), device="meta"),
                             axis_sizes=sizes)
    for path, spec in tree_util.leaves(got):
        assert spec == tuple(want[path]), path
    # the train state's specs on a (2, 2, 2) mesh, against the reference's
    # shardings' specs (a mesh object made outside its world holds the axis
    # sizes alone)
    jmesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    jstate = jax.eval_shape(lambda k: jsteps.init_train_state(
        cfg, jadam.OptConfig(**OPT_KW), jcomp.FedQCSConfig(**FED_KW), k, n_pods=2),
        jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(
        jsteps.train_state_shardings(jstate, jmesh, fed=True),
        is_leaf=lambda x: hasattr(x, "spec"))[0]
    want = {tuple(getattr(k, "key", getattr(k, "name", k)) for k in p): tuple(v.spec)
            for p, v in flat}
    tstate = steps.init_train_state(registry.smoke_config(ARCH), tadam.OptConfig(**OPT_KW),
                                    tcomp.FedQCSConfig(**FED_KW), n_pods=2, abstract=True)
    got = steps.train_state_shardings(tstate, tmesh.Mesh(sizes), fed=True)
    for path, spec in tree_util.leaves(got):
        assert tuple(spec) == want[path], path
    # the logical activation rules (identity constraints on one card a pod)
    trules = tshard.ShardingRules(axis_sizes=sizes)
    jrules = jshard.ShardingRules(axis_sizes=sizes)
    for logical, dims in ((("batch", "seq", "heads"), (8, 5, 6)), (("blocks", None), (12, 3)),
                          (("vocab", "ff"), (7, 4))):
        assert trules.spec(*logical, dims=dims) == tuple(jrules.spec(*logical, dims=dims))
    with tshard.use_rules(trules):
        assert tshard.current_rules() is trules
        x = torch.ones(3)
        assert tshard.cs(x, "batch") is x
    assert tshard.current_rules() is None
    mesh = tmesh.make_single_device_mesh()
    assert steps.sanitize_spec(("data", None), (7, 3), mesh) == ("data", None)
    nb_local, nbar, local_shapes, _ = steps.shard_block_geometry(
        registry.smoke_config(ARCH), tcomp.FedQCSConfig(**FED_KW), mesh)
    assert nbar == sum(int(np.prod(s)) for s in local_shapes) and nb_local == -(-nbar // 256)


def test_token_dataset_is_a_pure_function_and_follows_the_rule():
    """A batch is a function of (seed, step, shard) alone; with no noise
    every sequence follows (start * 31**(i % 8) + 17 i) % V in int32
    arithmetic, computed here with the reference's jnp int32 ops."""
    ds = TokenDataset(151_936, batch=4, seq=12, seed=3)
    a, b = (ds.get_batch(5, shard=1, n_shards=2, device="cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a) and a["tokens"].shape == (2, 12)
    assert not torch.equal(ds.get_batch(6, device="cpu")["tokens"],
                           ds.get_batch(5, device="cpu")["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    batch = tmodel.make_batch(registry.smoke_config(ARCH), "train_4k", seed=2, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: ((256, 4096), torch.int64) for k in ("tokens", "labels")}
    assert int(batch["tokens"].max()) < 256
    clean = TokenDataset(151_936, batch=8, seq=20, seed=1, noise=0.0).get_batch(0, device="cpu")
    start = jnp.asarray(clean["tokens"][:, :1].numpy(), jnp.int32)
    idx = jnp.arange(21)
    rule = (start * jnp.power(31, idx % 8) + 17 * idx) % 151_936
    seqs = torch.cat([clean["tokens"], clean["labels"][:, -1:]], dim=1)
    assert np.array_equal(seqs.numpy(), np.asarray(rule))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adam_on_a_nested_tree_matches_reference(state_dtype):
    params_np, grads_np = _random_like_params(1), _random_like_params(2)
    jcfg = jadam.OptConfig(**OPT_KW, state_dtype=state_dtype)
    tcfg = tadam.OptConfig(**OPT_KW, state_dtype=state_dtype)
    pj = jax.tree_util.tree_map(jnp.asarray, params_np)
    gj = jax.tree_util.tree_map(jnp.asarray, grads_np)
    sj = jadam.init_state(jcfg, pj)
    pt, gt = from_reference(params_np)[0], from_reference(grads_np)[0]
    st = tadam.init_state(tcfg, pt)
    upd = jax.jit(lambda g, s, p: jadam.update(jcfg, g, s, p, 3))
    for _ in range(2):
        pj, sj = upd(gj, sj, pj)
        pt, st = tadam.update(tcfg, gt, st, pt, 3)
    want = _paths(pj)
    for path, p in tree_util.leaves(pt):
        np.testing.assert_allclose(p.numpy(), np.asarray(want[path]), rtol=1e-6, atol=1e-7)
    want_m = _paths(sj["m"])
    for path, m in tree_util.leaves(st["m"]):
        if state_dtype == "int8":
            assert m.q.dtype == torch.int8
            assert np.abs(m.q.numpy().astype(int) - np.asarray(want_m[path].q)).max() <= 1
        else:
            np.testing.assert_allclose(m.numpy(), np.asarray(want_m[path]), rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 2])
def test_auto_step_matches_reference(step, ref, ref_auto):
    """impl="auto" from the reference's state before each step."""
    before = ref["state"] if step == 0 else ref_auto[step - 1][0]
    state, m = _port_step(ref)(_port_state(before), _batch(ref["batches"][step]))
    _check_step(state, m["loss"], *ref_auto[step])


@pytest.mark.parametrize("impl,fed_kw,opt_kw", [
    pytest.param("auto", dict(recon_mode="ea", use_kernels=True), None, id="ea-kernel-route"),
    pytest.param("auto_sharded", None, None, id="auto_sharded"),
    pytest.param("auto", None, dict(state_dtype="int8"), id="int8-adam"),
    pytest.param("baseline", None, None, id="baseline"),
])
def test_step_variant_matches_reference(impl, fed_kw, opt_kw, ref):
    """One step of the EA decode on the kernel route (the port's plain
    versions, the reference's interpret-mode kernels), the per-shard
    blocking, int8 Adam states and the baseline (no FedQCS)."""
    fed = None if impl == "baseline" else dataclasses.replace(ref["fed"], **(fed_kw or {}))
    opt = dataclasses.replace(ref["opt"], **(opt_kw or {}))
    j_impl = "auto" if impl == "baseline" else impl
    mesh = j_single_mesh()
    jstate = dict(ref["state"])  # the initial state, reshaped for the variant
    if impl == "baseline":
        del jstate["residual"], jstate["participating"]
    if impl == "auto_sharded":
        nb_local = jsteps.shard_block_geometry(ref["cfg"], fed, mesh)[0]
        jstate["residual"] = np.zeros((2, nb_local, 256), np.float32)
    if opt_kw:
        jstate["opt"] = _np(jax.jit(lambda p: jadam.init_state(opt, p))(jstate["params"]))
    jfn = jsteps.make_train_step(ref["cfg"], opt, fed, mesh, donate=False, impl=j_impl)
    want, m = jfn(jstate, ref["batches"][0])
    fn = _port_step(ref, fed_kw, opt_kw, impl=j_impl, fed=impl != "baseline")
    got, gm = fn(_port_state(jstate), _batch(ref["batches"][0]))
    _check_step(got, gm["loss"], _np(want), float(m["loss"]))
    if opt_kw:
        leaves = tree_util.leaves(got["opt"]["m"])
        assert all(isinstance(q, tadam.QLeaf) and q.q.dtype == torch.int8 for _, q in leaves)
    if impl == "baseline":
        assert set(got) == {"params", "opt", "step"}


def test_partial_participation_moves_the_parameters(ref):
    """Pod 1 dead: the step runs on pod 0's payload, the parameters move,
    and pod 1's residual is its full carry (here its gradient blocks)."""
    state = _port_state(ref["state"])
    state["participating"] = torch.tensor([1.0, 0.0])
    new, m = _port_step(ref)(state, _batch(ref["batches"][0]))
    assert np.isfinite(float(m["loss"]))
    moved = sum(float(torch.sum(torch.abs(a - tree_util.get(state["params"], p))))
                for p, a in tree_util.leaves(new["params"]))
    assert moved > 0
    _, grads = steps.value_and_grad(
        state["params"], {k: v[8:] for k, v in _batch(ref["batches"][0]).items()},
        registry.smoke_config(ARCH))
    blocks, _, _ = tcomp.flatten_to_blocks(grads, 256, row_multiple=512)
    assert torch.equal(new["residual"][1], blocks)


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------


def test_init_train_state_holds_given_params():
    """``params=`` puts a given tree in the state in place of a fresh draw:
    the rest of the state is the one the seed's draw gets."""
    cfg, opt = registry.smoke_config(ARCH), tadam.OptConfig(**OPT_KW)
    fed = tcomp.FedQCSConfig(**FED_KW)
    drawn = steps.init_train_state(cfg, opt, fed, seed=3, n_pods=2, device="cpu")
    params = tmodel.init_params(cfg, seed=3, device="cpu")
    held = steps.init_train_state(cfg, opt, fed, n_pods=2, device="cpu", params=params)
    assert held["params"] is params
    for path, leaf in tree_util.leaves(drawn):
        assert torch.equal(tree_util.get(held, path), leaf), path
    with pytest.raises(ValueError, match="lies on meta"):
        steps.init_train_state(cfg, opt, fed, device="cpu",
                               params=tmodel.init_params(cfg, device="meta"))


def test_checkpoint_replay_is_exact(ref, tmp_path):
    """Save after 2 steps, go on 2; restore and replay the 2: identical
    parameters, optimizer state and residual (the batch is a function of
    the step)."""
    fn = _port_step(ref)
    ds = TokenDataset(256, batch=16, seq=32, seed=7)
    state = _port_state(ref["state"])
    for t in range(2):
        state, _ = fn(state, ds.get_batch(t, device="cpu"))
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(2, state)
    cont = state
    for t in range(2, 4):
        cont, _ = fn(cont, ds.get_batch(t, device="cpu"))
    template = steps.init_train_state(registry.smoke_config(ARCH), tadam.OptConfig(**OPT_KW),
                                      tcomp.FedQCSConfig(**FED_KW), n_pods=2, abstract=True)
    restored, step = ckpt.restore(template, device="cpu")
    assert step == 2
    for t in range(2, 4):
        restored, _ = fn(restored, ds.get_batch(t, device="cpu"))
    for (pa, a), (pb, b) in zip(tree_util.leaves(cont), tree_util.leaves(restored)):
        assert pa == pb and torch.equal(a, b), pa


def test_reference_checkpoint_restores_into_the_port(ref, ref_auto, tmp_path):
    """The reference's checkpoint after step 1 restores into the port's
    template entry for entry, and the port's step from it matches the
    reference's step 2."""
    JCheckpointer(str(tmp_path), async_save=False).save(1, ref_auto[0][0])
    template = _port_state(ref["state"])
    restored, step = Checkpointer(str(tmp_path)).restore(template)
    assert step == 1
    want = _paths(ref_auto[0][0])
    for path, leaf in tree_util.leaves(restored):
        assert np.array_equal(leaf.numpy(), np.asarray(want[path])), path
    state, m = _port_step(ref)(restored, _batch(ref["batches"][1]))
    _check_step(state, m["loss"], *ref_auto[1])


def test_checkpoint_keeps_bfloat16_and_int8_states(tmp_path, monkeypatch):
    """bf16 parameters (stored as their bits) and int8 QLeaf moments restore
    bit for bit; a failed write in the save thread raises in wait()."""
    cfg = dataclasses.replace(registry.smoke_config(ARCH), dtype="bfloat16")
    opt = tadam.OptConfig(**OPT_KW, state_dtype="int8")
    state = steps.init_train_state(cfg, opt, None, seed=4, device="cpu")
    state["opt"] = tadam.update(opt, state["params"], state["opt"], state["params"], 0)[1]
    ckpt = Checkpointer(str(tmp_path), keep=1)
    ckpt.save(7, state)
    ckpt.wait()
    back, _ = ckpt.restore(steps.init_train_state(cfg, opt, None, abstract=True), device="cpu")
    for (p, a), (_, b) in zip(tree_util.leaves(state), tree_util.leaves(back)):
        if isinstance(a, tadam.QLeaf):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), p
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), p
    assert back["params"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    # a bf16 entry the reference wrote (numpy stores it as 2-byte voids)
    w = jnp.asarray(np.random.default_rng(0).normal(size=(3, 4)), jnp.bfloat16)
    JCheckpointer(str(tmp_path / "ref"), async_save=False).save(1, {"a": {"w": w}})
    got, _ = Checkpointer(str(tmp_path / "ref")).restore(
        {"a": {"w": torch.zeros((3, 4), dtype=torch.bfloat16)}})
    assert np.array_equal(got["a"]["w"].float().numpy(), np.asarray(w, np.float32))
    from repro_torch.checkpoint import checkpointer

    def disk_full(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(checkpointer.np, "savez", disk_full)
    ckpt.save(8, state)
    with pytest.raises(OSError, match="no space"):
        ckpt.wait()


def test_launcher_runs_three_steps_on_the_cpu(tmp_path, capfd):
    """The dense family's pod mode: the reference's (2, 2, 2) mesh, eight
    spawned ranks (rank 0 prints: its lines reach the file descriptor)."""
    args = ["--arch", ARCH, "--smoke", "--fedqcs", "--pods", "2", "--device", "cpu",
            "--steps", "3", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    tlaunch.main(args)
    out = capfd.readouterr().out
    assert "[train] done" in out and out.count("loss") == 3
    assert "mesh={'pod': 2, 'data': 2, 'model': 2}" in out
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    tlaunch.main(args)  # resumes from the last checkpoint
    assert "resumed from step 2" in capfd.readouterr().out


# ---------------------------------------------------------------------------
# routes outside the slice; import hygiene
# ---------------------------------------------------------------------------


_MOE = registry.smoke_config("qwen3-moe-235b-a22b")


def _serve_dense(step: str):
    """Prefill 6 tokens of the dense smoke model, then (``decode``) one
    decode step into a cache of 8 slots."""
    cfg = registry.smoke_config(ARCH)
    params = tmodel.init_params(cfg, seed=1, device="cpu")
    tokens = torch.arange(12).reshape(2, 6)
    logits, cache = steps.make_prefill_step(cfg, None)(params, {"tokens": tokens})
    if step == "prefill":
        return logits, cache["k"].shape == (2, 2, 6, 2, 16)
    full = tmodel.init_cache(cfg, 2, 8, device="cpu")
    full["k"][:, :, :6], full["v"][:, :, :6] = cache["k"], cache["v"]
    nxt, logits, full = steps.make_decode_step(cfg, None)(params, full, tokens[:, -1:], 6)
    return logits, nxt.shape == (2, 1) and bool((full["k"][:, :, 6] != 0).any())


def _prefill_family(arch: str):
    """Prefill 6 tokens of ``arch``'s smoke model (the SSM family: its
    per-layer conv window and SSD state)."""
    cfg = registry.smoke_config(arch)
    params = tmodel.init_params(cfg, seed=1, device="cpu")
    logits, cache = steps.make_prefill_step(cfg, None)(params, {"tokens": torch.arange(12)
                                                                .reshape(2, 6)})
    return logits, (cache["conv"].shape == (2, 2, 3, 160)
                    and cache["ssm"].shape == (2, 2, 8, 16, 16))


@pytest.mark.parametrize("route", [
    pytest.param(lambda: _prefill_family("mamba2-1.3b"), id="ssm-family"),
    pytest.param(lambda: (None, set(tree_util.get(tmodel.init_params(_MOE, device="cpu"),
                                                  ("layers", "ffn"))) == {"experts", "router"}),
                 id="moe-family"),
    pytest.param(lambda: (None, tmodel.init_cache(registry.smoke_config(ARCH), 1, 8,
                                                  device="cpu")["k"].shape == (2, 1, 8, 2, 16)),
                 id="serve-cache"),
    pytest.param(lambda: _serve_dense("prefill"), id="prefill-step"),
    pytest.param(lambda: _serve_dense("decode"), id="decode-step"),
])
def test_routes_now_in_the_slice_run(route):
    """The routes that raised until the serve steps and the MoE, SSM,
    hybrid and audio families were ported: each runs on the CPU and gives
    what it should (its logits finite)."""
    logits, ok = route()
    assert ok and (logits is None or bool(torch.isfinite(logits).all()))


@pytest.mark.parametrize("route,item", [
    pytest.param(lambda: steps.batch_shardings(registry.smoke_config(ARCH), "train_4k",
                                               tmesh.make_single_device_mesh()), None,
                 id="batch-shardings"),
    pytest.param(lambda: tmesh.make_debug_mesh(2, 2, 2).inpod, None, id="in-pod-parallelism"),
    pytest.param(lambda: tmesh.make_production_mesh(multi_pod=True), "item 10g",
                 id="production-mesh"),
    pytest.param(lambda: tlaunch.main(["--arch", ARCH, "--smoke", "--fed-cohort",
                                       "--interleave", "2", "--clients", "4", "--steps", "1",
                                       "--seq", "16", "--device", "cpu"]).round == 1,
                 None, id="fed-cohort"),
    pytest.param(lambda: tlaunch.main(["--arch", ARCH, "--smoke", "--interleave", "2"]),
                 (ValueError, "--fed-cohort"), id="interleave"),
])
def test_routes_outside_the_slice_raise(route, item):
    """The routes outside the slice raise ``NotImplementedError`` naming
    their ROADMAP.md item.  Since the interleaved producer was ported, the
    cohort mode's ``--interleave`` runs (``item`` None) and pod mode rejects
    the flag with a ``ValueError`` naming ``--fed-cohort`` (the reference's
    pod mode ignores it).  Since the in-pod mesh was ported,
    ``batch_shardings`` gives the input specs and ``make_debug_mesh(2, 2,
    2)`` an in-pod mesh (``item`` None; ``tests/test_torch_inpod.py`` holds
    both against the reference)."""
    if item is None:
        assert route()
        return
    err, match = item if isinstance(item, tuple) else (NotImplementedError, item)
    with pytest.raises(err, match=match):
        route()


@pytest.mark.parametrize("entry", [
    pytest.param(lambda: tmodel.init_params(registry.smoke_config(ARCH)), id="init_params"),
    pytest.param(lambda: ttransformer.init_params(registry.smoke_config(ARCH)),
                 id="transformer-init_params"),
    pytest.param(lambda: tmodel.make_batch(registry.smoke_config(ARCH), "train_4k"),
                 id="make_batch"),
    pytest.param(lambda: tmodel.make_batch(registry.smoke_config("qwen2-vl-7b"), "train_4k"),
                 id="make_batch-vlm"),
    pytest.param(lambda: TokenDataset(256, batch=2, seq=4).get_batch(0), id="get_batch"),
    pytest.param(lambda: steps.init_train_state(registry.smoke_config(ARCH), tadam.OptConfig(),
                                                None), id="init_train_state"),
])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Entry points default to ``device="cuda"``, which raises with no card
    (there is no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        entry()


def test_repro_torch_imports_neither_jax_nor_repro():
    """Every module of the port, imported in a fresh interpreter: neither
    ``jax`` nor ``repro`` gets loaded."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')\n"
        "        if not m.name.endswith('.__main__')]  # entry points run when imported\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 60
