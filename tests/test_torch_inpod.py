"""Port parity: the in-pod program (one process per device of the
reference's ``make_debug_mesh(2, 2, 2)``: batch over data; heads, ff and
vocab over model; every weight's d_model over data) against the
reference's 2 x 2 x 2 runs, on the CPU.

The model is the reference's system-test model, ``smoke_config
("qwen3-0.6b")`` (2 layers, d_model 64, 4 heads and 2 KV heads, vocab 256,
fp32), with ``tests/test_system.py``'s FedQCS point (N = 256, R = 2, Q =
4, S = 20, 15 scalar-variance GAMP iterations), optimizer and data.  The
reference runs its jitted steps on its 8 host devices once a pytest run
(shared by the xdist workers); the port's eight ``gloo`` ranks run once
too (``tests/torch_inpod_worker.py``, spawned by
``repro_torch.launch.spawn.run_world``), every scenario in one world, each
step from the reference's state before it.  The reference's
``impl="shard_map"`` on this mesh aborts in XLA's SPMD partitioner, so the
port's is held against the port's ``impl="auto"``.

Contracts (``tests/test_torch_models.py``'s): loss within 1e-5; each
rank's residual equal to its shard of the reference's within atol 1e-5;
the gathered parameters within 2 lr; the pod's gradient rtol 1e-4 / atol
1e-6; a restart bit-identical.
"""

import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_inpod_worker  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.data.synthetic import TokenDataset as JDataset  # noqa: E402
from repro.launch.mesh import make_debug_mesh as j_debug_mesh  # noqa: E402
from repro.launch.mesh import make_single_device_mesh as j_single_mesh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.core.compression import FedQCSConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.spawn import run_world  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim.adam import OptConfig  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from torch_shared import shared  # noqa: E402

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 simulated devices")

ARCH = "qwen3-0.6b"
FED_KW = dict(block_size=256, reduction_ratio=2, bits=4, s_ratio=0.08, gamp_iters=15,
              gamp_variance_mode="scalar")
OPT_KW = dict(lr=3e-3, warmup_steps=2, decay_steps=100)
LR = OPT_KW["lr"]
MESH = {"pod": 2, "data": 2, "model": 2}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", k) for k in p): v for p, v in flat}


def _port_state(ref_state):
    state = state_from_reference(_np(ref_state))
    state["step"] = state["step"].to(torch.int32)
    return state


def _reference():
    """The reference's 2 x 2 x 2 runs: each scenario's step from its state
    before it, the pods' gradients, and the single-device step the elastic
    restore is held against."""
    cfg, fed = jreg.smoke_config(ARCH), jcomp.FedQCSConfig(**FED_KW)
    opt = jadam.OptConfig(**OPT_KW)
    ds = JDataset(cfg.vocab_size, batch=16, seq=32, seed=7)
    batches = [ds.get_batch(i) for i in range(2)]
    mesh = j_debug_mesh(2, 2, 2)
    init = jsteps.init_train_state(cfg, opt, fed, jax.random.PRNGKey(0), n_pods=2)

    def step(state, batch, fed_cfg=fed, impl="auto", on=mesh):
        fn = jsteps.make_train_step(cfg, opt, fed_cfg, on, donate=False, impl=impl)
        new, m = fn(state, batch)
        return _np(new), float(m["loss"])

    out = {"init": _np(init), "batches": [_np(b) for b in batches],
           "devices": np.vectorize(lambda d: d.id)(mesh.devices).tolist(),
           "a": np.asarray(jcomp.BQCSCodec(fed).a)}
    out["auto"] = step(init, batches[0])
    out["ea"] = step(init, batches[0], dataclasses.replace(fed, recon_mode="ea",
                                                           use_kernels=True))
    out["partial"] = step(dict(init, participating=jax.numpy.asarray([1.0, 0.0])), batches[0])
    base = {k: v for k, v in init.items() if k not in ("residual", "participating")}
    out["baseline"] = step(base, batches[0], None)
    sharded = jsteps.init_train_state(cfg, opt, fed, jax.random.PRNGKey(0), n_pods=2,
                                      mesh=mesh, impl="auto_sharded")
    out["sharded_init"] = _np(sharded)
    out["sharded0"] = step(sharded, batches[0], impl="auto_sharded")
    out["sharded1"] = step(out["sharded0"][0], batches[1], impl="auto_sharded")
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jmodel.train_loss(p, b, cfg)))
    out["grads"] = [_np(grad_fn(init["params"], {k: v[8 * p:8 * p + 8]
                                                 for k, v in batches[0].items()}))
                    for p in range(2)]
    out["elastic"] = step(out["auto"][0], batches[1], on=j_single_mesh())
    return out


def _port(ref):
    """The port's eight ranks over every scenario, then the elastic restore
    of their checkpoint onto one device and a step there."""
    t = lambda b: {k: torch.tensor(np.asarray(v, np.int64)) for k, v in b.items()}
    inp = {"fed_kw": FED_KW, "opt_kw": OPT_KW, "a": torch.tensor(ref["a"]),
           "init": _port_state(ref["init"]), "batches": [t(b) for b in ref["batches"]],
           "sharded_init": _port_state(ref["sharded_init"]),
           "sharded_after": _port_state(ref["sharded0"][0]),
           "auto_after": _port_state(ref["auto"][0])}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ranks = run_world(torch_inpod_worker.run, 8, args=(inp, ckpt_dir), device="cpu",
                          timeout_s=300)
        cfg = registry.smoke_config(ARCH)
        fed, opt = FedQCSConfig(**FED_KW), OptConfig(**OPT_KW)
        single = tmesh.make_single_device_mesh()
        template = steps.init_train_state(cfg, opt, fed, n_pods=2, abstract=True)
        restored, step = Checkpointer(ckpt_dir).restore(template, step=1, device="cpu")
    fn = steps.make_train_step(cfg, opt, fed, single, device="cpu", a=inp["a"])
    new, m = fn(restored, inp["batches"][1])
    return {"ranks": ranks, "restored": restored, "restored_step": step,
            "elastic": (new, float(m["loss"]))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref = shared(tmp_path_factory, "inpod_reference", _reference)
    return ref, shared(tmp_path_factory, "inpod_port", lambda: _port(ref))


def _check(got_state, got_loss, want_state, want_loss):
    assert abs(got_loss - want_loss) <= 1e-5
    want = _paths(want_state["params"])
    worst = max(float(np.max(np.abs(p.float().numpy() - np.asarray(want[path], np.float32))))
                for path, p in tree_util.leaves(got_state["params"]))
    assert worst <= 2 * LR, worst


# ---------------------------------------------------------------------------
# the world against the reference
# ---------------------------------------------------------------------------


def test_rank_order_is_the_reference_meshs(runs):
    """Rank r sits at the position of device r in the reference's
    ``make_debug_mesh(2, 2, 2).devices``."""
    ref, port = runs
    devices = np.asarray(ref["devices"])
    for rank, out in enumerate(port["ranks"]):
        c = out["coords"]
        assert devices[c["pod"], c["data"], c["model"]] == rank
        assert tmesh.Mesh(MESH).coords(rank) == c


def test_pod_gradient_matches_reference(runs):
    """Each pod's loss and gradient, gathered from its four ranks: the
    qk-norm scales summed over the heads' ranks, the MLP's replicated wi/wg
    over their column ranks, every replicated leaf over the data ranks."""
    ref, port = runs
    for pod, rank in ((0, 0), (1, 4)):
        want_loss, want_grads = ref["grads"][pod]
        got = port["ranks"][rank]["grads"]
        assert abs(got["loss"] - float(want_loss)) <= 1e-5
        want = _paths(want_grads)
        for path, g in tree_util.leaves(got["grads"]):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[path]), rtol=1e-4,
                                       atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("name", ["auto", "ea", "partial", "baseline", "sharded0", "sharded1"])
def test_step_matches_reference(name, runs):
    """One step of ``impl="auto"`` AE and EA (kernel route: the plain
    versions here, the reference's interpret-mode kernels), a dead pod,
    the baseline and two ``auto_sharded`` steps: the loss, each rank's
    residual against its shard of the reference's ``P("pod", ("data",
    "model"), None)`` residual, the gathered parameters."""
    ref, port = runs
    want_state, want_loss = ref[name]
    ranks = port["ranks"]
    assert all(out[name]["loss"] == ranks[0][name]["loss"] for out in ranks)
    _check(ranks[0][name]["state"], ranks[0][name]["loss"], want_state, want_loss)
    if name == "baseline":
        assert "residual" not in want_state and ranks[0][name]["residual"] is None
        return
    want = np.asarray(want_state["residual"])
    for out in ranks:
        c, got = out["coords"], out[name]["residual"].numpy()
        rows = got.shape[1]
        r = c["data"] * MESH["model"] + c["model"]
        np.testing.assert_allclose(got[0], want[c["pod"], r * rows:(r + 1) * rows],
                                   rtol=0, atol=1e-5)
    if name == "partial":  # the dead pod keeps its full carry: its gradient blocks
        assert float(np.abs(want[1]).max()) > 0


def test_shard_map_matches_auto(runs):
    """``impl="shard_map"`` (the packed words gathered over the pod peers)
    against ``impl="auto"`` (their dequantized sums) from one state."""
    _, port = runs
    for out in port["ranks"]:
        got, want = out["shard_map"], out["auto"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5
        np.testing.assert_allclose(got["residual"].numpy(), want["residual"].numpy(),
                                   rtol=0, atol=1e-5)
    got, want = port["ranks"][0]["shard_map"]["state"], port["ranks"][0]["auto"]["state"]
    for path, p in tree_util.leaves(got["params"]):
        assert float((p - tree_util.get(want["params"], path)).abs().max()) <= 2 * LR, path


def test_remat_recomputes_the_collectives_alike(runs):
    """The layers recomputed in the backward (their gathers and reductions
    run again, in one order on every rank): the step is bit-identical."""
    _, port = runs
    for out in port["ranks"]:
        assert out["remat"]["loss"] == out["sharded0"]["loss"]
        assert torch.equal(out["remat"]["residual"], out["sharded0"]["residual"])
    got, want = port["ranks"][0]["remat"]["state"], port["ranks"][0]["sharded0"]["state"]
    for path, leaf in tree_util.leaves(got):
        assert torch.equal(leaf, tree_util.get(want, path)), path


def test_checkpoint_restart_is_exact(runs):
    """Saved from the shards after a step, restored into the world's
    shards and replayed: bit-identical to the run that went on."""
    _, port = runs
    assert all(out["ckpt"] == {"step": 2, "same": True} for out in port["ranks"])


def test_checkpoint_restores_onto_one_device(runs):
    """The world's checkpoint of the reference's state after its first step
    restores onto ``make_single_device_mesh`` entry for entry; the step
    there matches the reference's on its single-device mesh."""
    ref, port = runs
    want = _paths(ref["auto"][0])
    assert port["restored_step"] == 1
    for path, leaf in tree_util.leaves(port["restored"]):
        assert np.array_equal(leaf.numpy(), np.asarray(want[path])), path
    (got, loss), (want_state, want_loss) = port["elastic"], ref["elastic"]
    _check(got, loss, want_state, want_loss)
    np.testing.assert_allclose(got["residual"].numpy(), np.asarray(want_state["residual"]),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# specs and geometry against the reference; the routes outside the slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_specs_and_geometry_match_reference(arch):
    """``batch_shardings`` (a decode cache by ``_cache_spec``) for every
    shape of ``input_specs``, and ``shard_block_geometry``, on the 2 x 2 x 2
    mesh."""
    jmesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    mesh = tmesh.Mesh(MESH)
    jcfg, tcfg = jreg.get_config(arch), registry.get_config(arch)
    for shape in tmodel.SHAPES:
        want = jax.tree_util.tree_flatten_with_path(
            jsteps.batch_shardings(jcfg, shape, jmesh), is_leaf=lambda x: hasattr(x, "spec"))[0]
        want = {tuple(str(getattr(k, "key", k)) for k in p): tuple(v.spec) for p, v in want}
        got = dict(tree_util.leaves(steps.batch_shardings(tcfg, shape, mesh)))
        assert got == want, (arch, shape)
    fed = jcomp.FedQCSConfig(block_size=255)
    jnb, jnbar, jshapes, jspecs = jsteps.shard_block_geometry(jcfg, fed, jmesh)
    nb, nbar, shapes, specs = steps.shard_block_geometry(tcfg, FedQCSConfig(block_size=255),
                                                         mesh)
    assert (nb, nbar, [tuple(s) for s in shapes]) == (jnb, jnbar,
                                                       [tuple(s) for s in jshapes])
    want = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert dict(tree_util.leaves(specs)) == {tuple(k.key for k in p): tuple(s)
                                             for p, s in want}


def test_local_batch_is_the_references_split():
    """Rank (pod, d, m)'s share of a batch: pod p's half as the reference's
    ``impl="auto"`` splits it, then its d-th half over data (the VLM's
    (3, B, S) positions split along B)."""
    mesh = tmesh.Mesh(MESH, rank=0)
    batch = {"tokens": torch.arange(16 * 3).reshape(16, 3),
             "positions": torch.arange(3 * 16 * 2).reshape(3, 16, 2)}
    for rank in range(8):
        mesh.rank = rank
        c = mesh.coords()
        got = steps.local_batch(batch, mesh)
        lo = 8 * c["pod"] + 4 * c["data"]
        assert torch.equal(got["tokens"], batch["tokens"][lo:lo + 4])
        assert torch.equal(got["positions"], batch["positions"][:, lo:lo + 4])


_CFG, _OPT, _FED = registry.smoke_config(ARCH), OptConfig(**OPT_KW), FedQCSConfig(**FED_KW)


@pytest.mark.parametrize("route,item", [
    pytest.param(lambda: steps.init_train_state(registry.smoke_config("qwen3-moe-235b-a22b"),
                                                _OPT, _FED, mesh=tmesh.Mesh(MESH)),
                 "item 10d", id="moe-family"),
    pytest.param(lambda: steps.make_train_step(registry.smoke_config("mamba2-1.3b"), _OPT,
                                               _FED, tmesh.Mesh(MESH)), "item 10d",
                 id="ssm-family"),
    pytest.param(lambda: steps.init_train_state(
        _CFG, dataclasses.replace(_OPT, state_dtype="int8"), _FED, mesh=tmesh.Mesh(MESH)),
        "item 10e", id="int8-adam"),
    pytest.param(lambda: steps.make_decode_step(_CFG, tmesh.Mesh(MESH)), "item 10c",
                 id="decode-step"),
    pytest.param(lambda: steps.make_prefill_step(_CFG, tmesh.Mesh(MESH)), "item 10c",
                 id="prefill-step"),
    pytest.param(lambda: tmesh.make_production_mesh(multi_pod=True), "item 10g",
                 id="production-mesh"),
    pytest.param(lambda: steps.make_train_step(_CFG, _OPT, _FED, tmesh.Mesh(MESH)),
                 (RuntimeError, "run_world"), id="mesh-without-its-world"),
])
def test_routes_outside_the_slice_raise(route, item):
    """Each route the in-pod slice does not run raises
    ``NotImplementedError`` naming its ROADMAP.md item; an in-pod mesh made
    outside its world has no groups and says how to start one."""
    err, match = item if isinstance(item, tuple) else (NotImplementedError, item)
    with pytest.raises(err, match=match):
        route()


def test_spawned_rank_that_raises_makes_the_parent_raise():
    """A rank's exception stops the world and reaches the caller."""
    with pytest.raises(Exception, match="rank 3 fails"):
        run_world(torch_inpod_worker.fail_on_rank_3, 4, device="cpu", timeout_s=60)
