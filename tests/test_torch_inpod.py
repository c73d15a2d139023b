"""Port parity: the in-pod program (one process per device of the
reference's ``make_debug_mesh(2, 2, 2)``: batch over data; heads, ff and
vocab over model; every weight's d_model over data) against the
reference's 2 x 2 x 2 runs, on the CPU.

The model is the reference's system-test model, ``smoke_config
("qwen3-0.6b")`` (2 layers, d_model 64, 4 heads and 2 KV heads, vocab 256,
fp32), with ``tests/test_system.py``'s FedQCS point (N = 256, R = 2, Q =
4, S = 20, 15 scalar-variance GAMP iterations), optimizer and data; the
SSM and hybrid families' smoke models (``smoke_config("mamba2-1.3b")``: 2
layers of 8 SSM heads; ``smoke_config("zamba2-2.7b")``: 4 layers in two
groups, so the shared attention block runs twice) at the same point; and
the dense model with int8 Adam states (the reference's
``test_int8_optimizer_states``).  The
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
1e-6 (Zamba2's leaves that the reference's own fp32 gradient misses by
more: against its float64 gradient, as ``tests/test_torch_families.py``
holds them); a restart bit-identical.  int8: each rank's ``QLeaf``s and
parameters bit-identical to their shards of Adam's update on the whole
leaves; the world's codes within one step of the reference's and its
scales rtol 1e-5 (a moment that near a rounding boundary of its code
may round the other way: the two packages' aggregates differ in the last
bits); a restart bit-identical, and its restore onto one device the
reference's state entry for entry.
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
from repro_torch.models import sharding as tshard  # noqa: E402
from repro_torch.models.sharding import local_shard  # noqa: E402
from repro_torch.optim.adam import OptConfig  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from test_torch_families import _assert_grads_close, _grads64  # noqa: E402
from torch_shared import shared, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 simulated devices")

ARCH = "qwen3-0.6b"
FED_KW = dict(block_size=256, reduction_ratio=2, bits=4, s_ratio=0.08, gamp_iters=15,
              gamp_variance_mode="scalar")
OPT_KW = dict(lr=3e-3, warmup_steps=2, decay_steps=100)
LR = OPT_KW["lr"]
MESH = {"pod": 2, "data": 2, "model": 2}
STEPS = ("auto", "ea", "partial", "baseline", "sharded0")
MOE = "qwen3-moe-235b-a22b"
# label -> (arch, the smoke config's changes, the world's scenarios: each
# held against the reference's step, but shard_map (against the world's
# auto) and ckpt (a restart))
RUNS = {
    "mamba2-1.3b": ("mamba2-1.3b", {}, STEPS + ("shard_map",)),
    "zamba2-2.7b": ("zamba2-2.7b", {}, STEPS + ("shard_map",)),
    MOE: (MOE, {}, STEPS + ("int8", "shard_map", "ckpt")),
    # experts overflow: the pod's dispatch keeps other pairs than a rank's alone
    "moe-capacity-0.5": (MOE, {"capacity_factor": 0.5}, ("auto",)),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}, ("auto", "ea")),
    "qwen2-vl-7b": ("qwen2-vl-7b", {}, ("auto", "ea")),
    "whisper-base": ("whisper-base", {}, ("auto", "ea")),
    # an odd vocabulary: the tied embedding held whole over model
    "whisper-vocab-257": ("whisper-base", {"vocab_size": 257}, ("auto",)),
}
FAMILIES = ("mamba2-1.3b", "zamba2-2.7b")
SERVE = (ARCH, MOE, "deepseek-v3-671b", "qwen2-vl-7b")  # the in-pod serve steps' families
LATER = tuple(label for label in RUNS if label not in FAMILIES)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    """path -> leaf (a QLeaf's fields as ``q`` and ``scale`` after its path)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", getattr(k, "name", k)) for k in p): v for p, v in flat}


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
    step = _stepper(cfg, opt, mesh, fed)
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


def _reference_int8():
    """The reference's 2 x 2 x 2 step of the dense model with int8 Adam
    states (its ``test_int8_optimizer_states``): the state before and after."""
    cfg, fed = jreg.smoke_config(ARCH), jcomp.FedQCSConfig(**FED_KW)
    opt8 = jadam.OptConfig(**OPT_KW, state_dtype="int8")
    init8 = jsteps.init_train_state(cfg, opt8, fed, jax.random.PRNGKey(0), n_pods=2)
    fn8 = jsteps.make_train_step(cfg, opt8, fed, j_debug_mesh(2, 2, 2), donate=False)
    new8, m8 = fn8(init8, JDataset(cfg.vocab_size, batch=16, seq=32, seed=7).get_batch(0))
    return {"init": _np(init8), "step": (_np(new8), float(m8["loss"]))}


def _stepper(cfg, opt, mesh, fed):
    """``step(state, batch, fed_cfg=fed, impl="auto", on=mesh)`` -> (the
    reference's new state, loss); each (config, impl, mesh) is jitted once."""
    fns = {}

    def step(state, batch, fed_cfg=fed, impl="auto", on=mesh):
        key = (fed_cfg, impl, id(on))
        if key not in fns:
            fns[key] = jsteps.make_train_step(cfg, opt, fed_cfg, on, donate=False, impl=impl)
        new, m = fns[key](state, batch)
        return _np(new), float(m["loss"])

    return step


def _config(label, package=jreg):
    arch, overrides, _ = RUNS[label]
    return dataclasses.replace(package.smoke_config(arch), **overrides)


def _batch(label):
    """The label's batch for the reference (``torch_inpod_worker.family_batch``,
    its ids as int32)."""
    batch = torch_inpod_worker.family_batch(_config(label, registry))
    return {k: v.numpy().astype(np.int32 if v.dtype == torch.int64 else np.float32)
            for k, v in batch.items()}


def _pod_share(batch, pod):
    """Pod ``pod``'s 8 rows (the VLM's (3, B, S) positions along B)."""
    return {k: v[:, 8 * pod:8 * pod + 8] if k == "positions" else v[8 * pod:8 * pod + 8]
            for k, v in batch.items()}


def _family_init(label, name="auto"):
    """The reference's initial state of the label's smoke model that
    scenario ``name`` starts from: ``impl="auto"``'s, ``"auto_sharded"``'s
    (``sharded0``) or the int8 moments' (``int8``)."""
    cfg, fed = _config(label), jcomp.FedQCSConfig(**FED_KW)
    opt = jadam.OptConfig(**OPT_KW)
    if name == "sharded0":
        return jsteps.init_train_state(cfg, opt, fed, jax.random.PRNGKey(0), n_pods=2,
                                       mesh=j_debug_mesh(2, 2, 2), impl="auto_sharded")
    if name == "int8":
        opt = dataclasses.replace(opt, state_dtype="int8")
    return jsteps.init_train_state(cfg, opt, fed, jax.random.PRNGKey(0), n_pods=2)


def _reference_step(label, name):
    """The reference's 2 x 2 x 2 step ``name`` of the label's smoke model
    from its initial state: (the new state, the loss)."""
    cfg, fed = _config(label), jcomp.FedQCSConfig(**FED_KW)
    opt = jadam.OptConfig(**OPT_KW)
    init = _family_init(label, name)
    kw = {}
    if name == "ea":
        fed = dataclasses.replace(fed, recon_mode="ea", use_kernels=True)
    elif name == "partial":
        init = dict(init, participating=jax.numpy.asarray([1.0, 0.0]))
    elif name == "baseline":
        init, fed = {k: v for k, v in init.items() if k not in ("residual", "participating")}, None
    elif name == "sharded0":
        kw["impl"] = "auto_sharded"
    elif name == "int8":
        opt = dataclasses.replace(opt, state_dtype="int8")
    return _stepper(cfg, opt, j_debug_mesh(2, 2, 2), fed)(init, _batch(label), **kw)


def _reference_grads(label):
    """The label's smoke model's initial parameters, pods' batches and pod
    gradients (the reference's, jitted)."""
    cfg = _config(label)
    init = _family_init(label)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jmodel.train_loss(p, b, cfg)))
    pods = [_pod_share(_batch(label), p) for p in range(2)]
    return {"init": _np(init), "pods": pods,
            "grads": [_np(grad_fn(init["params"], b)) for b in pods]}


def _port(ref, ref8):
    """The port's eight ranks over every scenario, then the elastic restore
    of their checkpoint onto one device and a step there, and the restore
    of their int8 checkpoint.  The families' scenarios start from the
    reference's initial states (their steps are held against
    :func:`_reference_step`'s, computed apart)."""
    t = lambda b: {k: torch.tensor(np.asarray(v, np.int64)) for k, v in b.items()}
    inp = {"fed_kw": FED_KW, "opt_kw": OPT_KW, "a": torch.tensor(ref["a"]),
           "init": _port_state(ref["init"]), "batches": [t(b) for b in ref["batches"]],
           "sharded_init": _port_state(ref["sharded_init"]),
           "sharded_after": _port_state(ref["sharded0"][0]),
           "auto_after": _port_state(ref["auto"][0]),
           "families": {label: _port_family(label) for label in RUNS},
           "int8_init": _port_state(ref8["init"]),
           "int8_after": _port_state(ref8["step"][0]),
           "serve": SERVE}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ranks = run_world(torch_inpod_worker.run, 8, args=(inp, ckpt_dir), device="cpu",
                          timeout_s=300)
        cfg = registry.smoke_config(ARCH)
        fed, opt = FedQCSConfig(**FED_KW), OptConfig(**OPT_KW)
        single = tmesh.make_single_device_mesh()
        template = steps.init_train_state(cfg, opt, fed, n_pods=2, abstract=True)
        restored, step = Checkpointer(ckpt_dir).restore(template, step=1, device="cpu")
        opt8 = dataclasses.replace(opt, state_dtype="int8")
        template8 = steps.init_train_state(cfg, opt8, fed, n_pods=2, abstract=True)
        int8 = Checkpointer(f"{ckpt_dir}/int8").restore(template8, step=1, device="cpu")
    fn = steps.make_train_step(cfg, opt, fed, single, device="cpu", a=inp["a"])
    new, m = fn(restored, inp["batches"][1])
    return {"ranks": ranks, "restored": restored, "restored_step": step,
            "elastic": (new, float(m["loss"])), "int8_restored": int8}


def _port_family(label):
    """The world's input for the label: its arch, config changes, batch,
    scenarios and the reference's initial states."""
    arch, overrides, names = RUNS[label]
    fam = {"arch": arch, "overrides": overrides, "scenarios": names,
           "batch": torch_inpod_worker.family_batch(_config(label, registry)),
           "init": _port_state(_np(_family_init(label)))}
    for name, key in (("sharded0", "sharded_init"), ("int8", "int8_init")):
        if name in names:
            fam[key] = _port_state(_np(_family_init(label, name)))
    return fam


# Each reference run is shared on its own, so that the xdist workers that
# reach this module compute them side by side; the world waits for the
# dense and int8 ones (it replays their states).


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return shared(tmp_path_factory, "inpod_reference", _reference)


@pytest.fixture(scope="module")
def reference_int8(tmp_path_factory):
    return shared(tmp_path_factory, "inpod_reference_int8", _reference_int8)


def _family_reference(tmp_path_factory, label, name=None):
    """The reference's step ``name`` of the label (without one: its pod
    gradients), each shared on its own, so that the workers compute a
    label's runs side by side."""
    if name is None:
        return shared(tmp_path_factory, f"inpod_reference_{label}_grads",
                      lambda: _reference_grads(label))
    return shared(tmp_path_factory, f"inpod_reference_{label}_{name}",
                  lambda: _reference_step(label, name))


@pytest.fixture(scope="module")
def port(tmp_path_factory, reference, reference_int8):
    return shared(tmp_path_factory, "inpod_port", lambda: _port(reference, reference_int8))


@pytest.fixture(scope="module")
def runs(reference, port):
    return reference, port


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


def _check_world_step(name, want_state, want_loss, recs, coords, beyond_gap=False):
    """The ranks' records of one step (``recs[r]``) against the reference's:
    one loss on every rank, rank 0's gathered state, each rank's residual
    against its shard of the reference's ``P("pod", ("data", "model"),
    None)`` residual within atol 1e-5.  ``beyond_gap``
    (``tests/test_torch_families.py``'s contract for the SSM and hybrid
    families): the kept sets agree (the residuals' zeros), and each unkept
    entry is within atol 1e-5 of the reference's beyond the two packages'
    gap in that gradient entry (the rows the rank sent against the
    reference's residual, which is the reference's gradient there)."""
    assert all(rec["loss"] == recs[0]["loss"] for rec in recs)
    _check(recs[0]["state"], recs[0]["loss"], want_state, want_loss)
    if name == "baseline":
        assert "residual" not in want_state and recs[0]["residual"] is None
        return
    want = np.asarray(want_state["residual"])
    for c, rec in zip(coords, recs):
        got = rec["residual"].numpy()
        rows = got.shape[1]
        r = c["data"] * MESH["model"] + c["model"]
        mine = want[c["pod"], r * rows:(r + 1) * rows]
        if not beyond_gap:
            np.testing.assert_allclose(got[0], mine, rtol=0, atol=1e-5)
            continue
        assert np.array_equal(got[0] == 0, mine == 0)
        gap = np.abs(rec["blocks"].numpy() - mine)
        assert np.all(np.abs(got[0] - mine)[mine != 0] <= 1e-5 + gap[mine != 0])
    if name == "partial":  # the dead pod keeps its full carry: its gradient blocks
        assert float(np.abs(want[1]).max()) > 0


def _check_shard_map(recs):
    """``impl="shard_map"`` against ``impl="auto"``: records of the ranks."""
    for rec in recs:
        got, want = rec["shard_map"], rec["auto"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5
        np.testing.assert_allclose(got["residual"].numpy(), want["residual"].numpy(),
                                   rtol=0, atol=1e-5)
    got, want = recs[0]["shard_map"]["state"], recs[0]["auto"]["state"]
    for path, p in tree_util.leaves(got["params"]):
        assert float((p - tree_util.get(want["params"], path)).abs().max()) <= 2 * LR, path


@pytest.mark.parametrize("name", ["auto", "ea", "partial", "baseline", "sharded0", "sharded1"])
def test_step_matches_reference(name, runs):
    """One step of ``impl="auto"`` AE and EA (kernel route: the plain
    versions here, the reference's interpret-mode kernels), a dead pod,
    the baseline and two ``auto_sharded`` steps: the loss, each rank's
    residual against its shard of the reference's ``P("pod", ("data",
    "model"), None)`` residual, the gathered parameters."""
    ref, port = runs
    ranks = port["ranks"]
    _check_world_step(name, *ref[name], [out[name] for out in ranks],
                      [out["coords"] for out in ranks])


def test_shard_map_matches_auto(runs):
    """``impl="shard_map"`` (the packed words gathered over the pod peers)
    against ``impl="auto"`` (their dequantized sums) from one state."""
    _check_shard_map(runs[1]["ranks"])


# ---------------------------------------------------------------------------
# the SSM and hybrid families
# ---------------------------------------------------------------------------


@pytest.fixture(params=FAMILIES)
def family(request):
    return request.param


def _family_runs(label, tmp_path_factory, request, name=None):
    """(the reference's step ``name`` of the label -- without one, its pod
    gradients --, the world's ranks' records of the label, their
    coordinates); the reference first, so that workers compute the labels'
    runs side by side."""
    want = _family_reference(tmp_path_factory, label, name)
    return (want,) + _records(request, label)


def _records(request, label):
    ranks = request.getfixturevalue("port")["ranks"]
    return [out["families"][label] for out in ranks], [out["coords"] for out in ranks]


def test_family_pod_gradient_matches_reference(family, tmp_path_factory, request):
    """Each pod's loss and gradient, gathered from its four ranks: the
    Mamba blocks run on each rank's SSM heads (the projections onto its
    in_proj columns gathered over ``model``, conv_w gathered whole, the
    shared B/C group's gradient summed over the heads' ranks, the gated
    norm over every head), Zamba2's shared block once a group."""
    ref, recs, _ = _family_runs(family, tmp_path_factory, request)
    cfg = jreg.smoke_config(family)
    for pod, rank in ((0, 0), (1, 4)):
        want_loss, want_grads = ref["grads"][pod]
        got = recs[rank]["grads"]
        assert abs(got["loss"] - float(want_loss)) <= 1e-5
        exact = lambda: shared(  # noqa: E731
            tmp_path_factory, f"inpod_grads64_{family}_{pod}",
            lambda: _grads64(cfg, ref["init"]["params"], ref["pods"][pod]))
        _assert_grads_close(got["grads"], want_grads, exact)


@pytest.mark.parametrize("name", STEPS)
def test_family_step_matches_reference(family, name, tmp_path_factory, request):
    """The SSM and hybrid smoke models' ``auto`` AE and EA, dead-pod,
    baseline and ``auto_sharded`` steps on the world, to the dense
    family's contracts, the residual to ``tests/test_torch_families.py``'s
    (Zamba2's gradient sits on fp32's floor: its leaves differ from the
    reference's by more than 1e-5 where they are large)."""
    (want_state, want_loss), recs, coords = _family_runs(family, tmp_path_factory, request, name)
    _check_world_step(name, want_state, want_loss, [rec[name] for rec in recs], coords,
                      beyond_gap=True)


def test_family_shard_map_matches_auto(family, request):
    _check_shard_map(_records(request, family)[0])


# ---------------------------------------------------------------------------
# the MoE (with MLA and MTP), VLM and audio families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", LATER)
def test_later_family_pod_gradient_matches_reference(label, tmp_path_factory, request):
    """Each pod's loss and gradient, gathered from its four ranks, to the
    dense family's contract (rtol 1e-4 / atol 1e-6): the MoE's router
    gathered over ``data``, the pod's (token, choice) pairs dispatched on
    every rank with the pod's capacity, the rank's experts (their ``wo``
    gathered whole over ``model``), the shared expert and DeepSeek's
    first dense layer; MLA's latents on the rank's heads, MTP's block;
    Qwen2-VL's M-RoPE streams, patch prefix and qkv biases; Whisper's
    encoder, cross-attention on the rank's heads and its tied embedding
    (held whole over ``model`` at vocab 257)."""
    ref, recs, _ = _family_runs(label, tmp_path_factory, request)
    for pod, rank in ((0, 0), (1, 4)):
        want_loss, want_grads = ref["grads"][pod]
        got = recs[rank]["grads"]
        assert abs(got["loss"] - float(want_loss)) <= 1e-5
        _assert_grads_close(got["grads"], want_grads, None)


@pytest.mark.parametrize("label,name", [
    pytest.param(label, name, id=f"{label}-{name}") for label in LATER
    for name in RUNS[label][2] if name not in ("shard_map", "ckpt")])
def test_later_family_step_matches_reference(label, name, tmp_path_factory, request):
    """The labels' steps on the world against the reference's 2 x 2 x 2
    steps, to the dense family's contracts: the loss within 1e-5, each
    rank's residual against its shard of the reference's within atol 1e-5,
    the gathered parameters within 2 lr (int8: the moments' codes within
    one step of the reference's, their scales rtol 1e-5).  The MoE's
    combine sums a token's experts over ``model`` in another order than
    the reference's scatter-add: the same sum at k = 2 in fp32."""
    (want_state, want_loss), recs, coords = _family_runs(label, tmp_path_factory, request, name)
    _check_world_step(name, want_state, want_loss, [rec[name] for rec in recs], coords)
    if name == "int8":
        _check_qleafs(recs[0][name]["state"]["opt"], want_state["opt"])


def test_moe_shard_map_matches_auto(request):
    _check_shard_map(_records(request, MOE)[0])


def test_moe_checkpoint_restart_is_exact(port):
    """The MoE smoke model's state saved from the shards after a step (the
    expert stacks gathered), restored into the shards and replayed:
    bit-identical to the run that went on."""
    assert all(out["families"][MOE]["ckpt"] == {"step": 2, "same": True}
               for out in port["ranks"])


def test_capacity_half_overflows_so_a_rank_local_dispatch_would_differ(monkeypatch):
    """The overflow case's premise: at capacity_factor 0.5 a pod's dispatch
    drops (token, choice) pairs in every MoE layer, and each data rank's
    half of the pod's tokens dispatched alone (its capacity from its own
    tokens) would keep another set of pairs."""
    from repro_torch.models import moe

    cfg = _config("moe-capacity-0.5", registry)
    seen, dispatch = [], moe.dispatch
    monkeypatch.setattr(moe, "dispatch", lambda topi, cap, e: seen.append((topi, cap)) or
                        dispatch(topi, cap, e))
    batch = torch_inpod_worker.family_batch(cfg)
    with torch.no_grad():
        tmodel.train_loss(tmodel.init_params(cfg, 0, "cpu"), steps._pod_batch(batch, 2, 0), cfg)

    def kept(topi, cap, first=0):
        _, se, st, dest = dispatch(topi, cap, cfg.n_experts)
        return {(int(t) + first, int(x)) for t, x, d in zip(st, se, dest)
                if d < cfg.n_experts * cap}

    assert len(seen) == cfg.n_layers
    for topi, cap in seen:
        pod = kept(topi, cap)
        assert len(pod) < topi.numel()
        half = topi.shape[0] // 2
        alone = set().union(*(kept(topi[h * half:(h + 1) * half], moe.capacity(half, cfg),
                                   h * half) for h in range(2)))
        assert alone != pod


# ---------------------------------------------------------------------------
# int8 Adam states on the shards
# ---------------------------------------------------------------------------


def _qleaves(tree):
    return [(path, q) for path, q in tree_util.leaves(tree)]


def test_int8_step_matches_reference(reference_int8, port):
    """One ``auto`` step of the dense model with int8 moments: the loss,
    residuals and parameters as an fp32 step's; the gathered moments'
    codes within one step of the reference's, their scales rtol 1e-5."""
    ranks = port["ranks"]
    want_state, want_loss = reference_int8["step"]
    _check_world_step("auto", want_state, want_loss, [out["int8"]["step"] for out in ranks],
                      [out["coords"] for out in ranks])
    _check_qleafs(ranks[0]["int8"]["step"]["state"]["opt"], want_state["opt"])


def _check_qleafs(got, want):
    """The gathered int8 moments ``got`` against the reference's ``want``:
    codes within one step, scales rtol 1e-5, some codes moved."""
    want = _paths(want)
    moved = 0
    for path, q in _qleaves(got):
        wq, ws = np.asarray(want[path + ("q",)]), np.asarray(want[path + ("scale",)])
        assert q.q.dtype == torch.int8 and q.q.shape == wq.shape, path
        assert q.scale.shape == ws.shape, path
        np.testing.assert_allclose(q.scale.numpy(), ws, rtol=1e-5, atol=0, err_msg=str(path))
        assert int(np.abs(q.q.numpy().astype(np.int32) - wq).max()) <= 1, path
        moved += int(np.count_nonzero(wq))
    assert moved > 0


def test_int8_qleafs_are_the_whole_leafs_shards(port):
    """Adam on each rank's shards (block maxima over the whole leaf's
    256-entry blocks, all-reduced over the leaf's ranks) against Adam on
    the whole leaves, from the reference's int8 state after a step: every
    rank's QLeafs and parameters are their shards of the whole's, bit for
    bit, and every QLeaf holds the whole leaf's ceil(size / 256) scales."""
    cfg = registry.smoke_config(ARCH)
    whole = {-(-int(leaf.numel()) // 256) for _, leaf in tree_util.leaves(
        tmodel.init_params(cfg, device="meta"))}
    for out in port["ranks"]:
        assert out["int8"]["update"]["leaves"] > 0
        assert out["int8"]["update"]["differ"] == [], out["coords"]
        assert set(out["int8"]["scale_lengths"]) == whole


def test_int8_checkpoint_restart_is_exact(port):
    """An int8 state saved from the shards after a step (each moment's
    codes gathered, its one scale vector), restored into the world's
    shards and replayed: bit-identical to the run that went on."""
    assert all(out["int8"]["ckpt"] == {"step": 2, "same": True} for out in port["ranks"])


def test_int8_checkpoint_restores_onto_one_device(reference_int8, port):
    """The world's int8 checkpoint of the reference's state after its step
    restores onto one device entry for entry (``<path>.q``, ``.scale``)."""
    restored, step = port["int8_restored"]
    assert step == 1
    want = _paths(reference_int8["step"][0])
    for path, leaf in tree_util.leaves(restored):
        if isinstance(leaf, tuple):
            for field in ("q", "scale"):
                got = getattr(leaf, field).numpy()
                assert np.array_equal(got, np.asarray(want[path + (field,)])), path
        else:
            assert np.array_equal(leaf.numpy(), np.asarray(want[path])), path


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
# the serve steps on the mesh (the transformer family)
# ---------------------------------------------------------------------------


def _serve_reference(arch):
    """The reference's serve run of ``arch``'s smoke model on its 2 x 2 x 2
    mesh: seed 0's parameters (eager, as the port draws them) placed by
    ``sane_param_shardings``, the prompt over (pod, data), its prefill;
    the prompt's cache grown to ``SERVE_SMAX`` slots and placed by
    ``_cache_spec``, then ``SERVE_STEPS`` greedy decode steps (the tokens
    replicated): the tokens fed, the logits and the cache after each."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    w = torch_inpod_worker
    cfg = jreg.smoke_config(arch)
    mesh = j_debug_mesh(2, 2, 2)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    params = jax.device_put(params, jsteps.sane_param_shardings(params, mesh))
    rows = ("pod", "data")
    place = {"tokens": P(rows, None), "patches": P(rows, None, None),
             "positions": P(None, rows, None)}
    batch = {k: jax.device_put(v.numpy().astype(np.int32 if k != "patches" else np.float32),
                               NamedSharding(mesh, place[k]))
             for k, v in w.serve_batch(registry.smoke_config(arch)).items()}
    logits, cache = jsteps.make_prefill_step(cfg, mesh)(params, batch)
    out = {"logits": np.asarray(logits), "steps": []}
    grown = {k: np.pad(np.asarray(v), [(0, 0), (0, 0), (0, w.SERVE_SMAX - v.shape[2])]
                       + [(0, 0)] * (v.ndim - 3)) for k, v in cache.items()}
    out["cache"] = grown
    c = {k: jax.device_put(v, NamedSharding(mesh, jsteps._cache_spec(f"cache/{k}", v.shape,
                                                                      mesh)))
         for k, v in grown.items()}
    decode = jsteps.make_decode_step(cfg, mesh, donate=False)
    tok = np.argmax(out["logits"][:, -1], axis=-1).astype(np.int32)[:, None]
    for t in range(w.SERVE_STEPS):
        nxt, lo, c = decode(params, c, jax.device_put(tok, NamedSharding(mesh, P())),
                            jax.numpy.int32(w.SERVE_S + t))
        out["steps"].append({"tokens": tok, "next_tok": np.asarray(nxt),
                             "logits": np.asarray(lo), "cache": _np(c)})
        tok = np.asarray(nxt)
    return out


@pytest.fixture(params=SERVE)
def serve_runs(request, tmp_path_factory):
    """(the reference's serve run, the ranks' records, their coordinates,
    the port's config) of one smoke model."""
    arch = request.param
    want = shared(tmp_path_factory, f"inpod_serve_reference_{arch}",
                  lambda: _serve_reference(arch))
    ranks = request.getfixturevalue("port")["ranks"]
    return (want, [out["serve"][arch] for out in ranks], [out["coords"] for out in ranks],
            registry.smoke_config(arch))


def _assert_shard(got, whole, spec, c, what):
    want = local_shard(torch.tensor(np.asarray(whole, np.float32)), spec, MESH, c)
    assert tuple(got.shape) == tuple(want.shape), what
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5, err_msg=what)


def _assert_cache_shards(got, whole, c, what):
    """A rank's cache shard against its ``_cache_spec`` shard of the whole."""
    for k, v in whole.items():
        spec = steps._cache_spec(f"cache/{k}", v.shape, tmesh.Mesh(MESH))
        _assert_shard(got[k], v, spec, c, f"{what}: {k}")


def test_serve_prefill_matches_reference(serve_runs):
    """The in-pod ``make_prefill_step`` (batch over (pod, data), heads over
    ``model``; MoE: the whole batch's dispatch) against the reference's
    2 x 2 x 2 prefill: each rank's last-position logits (its rows, its
    vocabulary columns) within 1e-5, and each rank's cache of
    ``SERVE_SMAX`` slots (every K/V head or the MLA latents; its ``data``
    rows, its ``model`` slots) within 1e-5 of its ``_cache_spec`` shard of
    the reference's grown cache, and the shards gathered back
    (``gather_cache``) within 1e-5 of the whole."""
    want, recs, coords, cfg = serve_runs
    spec = steps.serve_specs(cfg, tmesh.Mesh(MESH), "prefill")["logits"]
    for c, rec in zip(coords, recs):
        _assert_shard(rec["logits"], want["logits"], spec, c, f"logits {c}")
        _assert_cache_shards(rec["cache"], want["cache"], c, f"cache {c}")
        for k, v in rec["whole_cache"].items():  # the shards gathered back
            np.testing.assert_allclose(v.numpy(), want["cache"][k], rtol=0, atol=1e-5)


def test_serve_decode_matches_reference(serve_runs):
    """``SERVE_STEPS`` greedy in-pod decode steps (split-KV over ``model``)
    against the reference's: slots 6 and 7 are ``model`` rank 0's (rank 1
    holds none yet: its partials weigh 0), 8 is rank 1's first, 9 and 10
    later.  At each: every rank's ``next_tok`` rows equal to the
    reference's, its logits within 1e-5 and its cache shard within 1e-5
    of the reference's cache's ``_cache_spec`` shard."""
    want, recs, coords, cfg = serve_runs
    specs = steps.serve_specs(cfg, tmesh.Mesh(MESH), "decode")
    for t, ref in enumerate(want["steps"]):
        for c, rec in zip(coords, recs):
            got = rec["steps"][t]
            mine = local_shard(torch.tensor(ref["next_tok"].astype(np.int64)),
                               specs["next_tok"], MESH, c)
            assert torch.equal(got["next_tok"], mine), (t, c)
            _assert_shard(got["logits"], ref["logits"], specs["logits"], c, f"step {t} {c}")
            _assert_cache_shards(got["cache"], ref["cache"], c, f"step {t} {c}")


def test_serve_decode_donation(serve_runs):
    """``donate=True`` writes the new slot into the rank's cache shard
    itself; ``donate=False`` leaves it as it was and returns the same
    values."""
    for rec in serve_runs[1]:
        assert rec["donated_in_place"] and rec["kept_left_cache"] and rec["kept_equals_donated"]


def test_greedy_over_vocabulary_shards_takes_the_lowest_index(port):
    """The decode's argmax over the ranks' vocabulary columns: the best
    value wins, and of equal values the lowest global index (the
    reference's ``argmax``), on every rank."""
    assert all(out["greedy_ties"] == [3, 13, 9] for out in port["ranks"])


def test_serve_cache_on_the_mesh_is_a_ranks_shard():
    """``model.init_cache(..., mesh=)`` gives zeros of a rank's shard (rows
    over ``data``, slots over ``model``); ``shard_cache`` cuts a whole
    cache the same way; a single-process prefill into ``smax`` slots is
    its prompt's cache grown to them."""
    mesh = tmesh.Mesh(MESH)
    for arch in (ARCH, "deepseek-v3-671b"):
        cfg = registry.smoke_config(arch)
        local = tmodel.init_cache(cfg, 8, 16, "cpu", mesh=mesh)
        whole = tmodel.init_cache(cfg, 8, 16, "cpu")
        for k, v in tshard.shard_cache(whole, mesh).items():
            assert v.shape == local[k].shape and local[k].shape[1:3] == (4, 8), k
            assert not local[k].any()
    cfg = registry.smoke_config(ARCH)
    params = tmodel.init_params(cfg, 0, "cpu")
    batch = torch_inpod_worker.serve_batch(cfg)
    prefill = steps.make_prefill_step(cfg, None)
    logits, cache = prefill(params, batch, 16)
    want_logits, want = prefill(params, batch)
    assert torch.equal(logits, want_logits)
    for k, v in tmodel.grow_cache(want, 16).items():
        assert torch.equal(cache[k], v), k


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


def _inpod_state(arch, opt=_OPT):
    """(the config, its optimizer, rank 0's in-pod state) of ``arch``'s
    smoke model (a mesh made outside its world holds rank 0's place)."""
    cfg = registry.smoke_config(arch)
    return cfg, opt, steps.init_train_state(cfg, opt, _FED, mesh=tmesh.Mesh(MESH), device="cpu")


@pytest.mark.parametrize("route,item", [
    pytest.param(lambda: _inpod_state(MOE), None, id="moe-family"),
    pytest.param(lambda: _inpod_state("mamba2-1.3b"), None, id="ssm-family"),
    pytest.param(lambda: _inpod_state("zamba2-2.7b"), None, id="hybrid-family"),
    pytest.param(lambda: _inpod_state("qwen2-vl-7b"), None, id="vlm-family"),
    pytest.param(lambda: _inpod_state("whisper-base"), None, id="audio-family"),
    pytest.param(lambda: _inpod_state(ARCH, dataclasses.replace(_OPT, state_dtype="int8")),
                 None, id="int8-adam"),
    pytest.param(lambda: steps.make_decode_step(registry.smoke_config("mamba2-1.3b"),
                                                tmesh.Mesh(MESH)),
                 "item 10c, second part", id="decode-step"),
    pytest.param(lambda: steps.make_prefill_step(registry.smoke_config("mamba2-1.3b"),
                                                 tmesh.Mesh(MESH)),
                 "item 10c, second part", id="prefill-step"),
    pytest.param(lambda: steps.make_decode_step(registry.smoke_config("zamba2-2.7b"),
                                                tmesh.Mesh(MESH)),
                 "item 10c, second part", id="decode-step-hybrid"),
    pytest.param(lambda: steps.make_prefill_step(registry.smoke_config("zamba2-2.7b"),
                                                 tmesh.Mesh(MESH)),
                 "item 10c, second part", id="prefill-step-hybrid"),
    pytest.param(lambda: steps.make_decode_step(registry.smoke_config("whisper-base"),
                                                tmesh.Mesh(MESH)),
                 "item 10c, second part", id="decode-step-audio"),
    pytest.param(lambda: steps.make_prefill_step(registry.smoke_config("whisper-base"),
                                                 tmesh.Mesh(MESH)),
                 "item 10c, second part", id="prefill-step-audio"),
    pytest.param(lambda: tmodel.init_cache(registry.smoke_config("mamba2-1.3b"), 8, 16, "cpu",
                                           mesh=tmesh.Mesh(MESH)),
                 "item 10c, second part", id="init-cache-ssm"),
    pytest.param(lambda: steps.make_decode_step(_CFG, tmesh.Mesh(MESH)),
                 (RuntimeError, "run_world"), id="serve-mesh-without-its-world"),
    pytest.param(lambda: tmesh.make_production_mesh(multi_pod=True), "item 10g",
                 id="production-mesh"),
    pytest.param(lambda: steps.make_train_step(_CFG, _OPT, _FED, tmesh.Mesh(MESH)),
                 (RuntimeError, "run_world"), id="mesh-without-its-world"),
    pytest.param(lambda: steps.init_train_state(
        dataclasses.replace(registry.smoke_config(MOE), n_experts=7), _OPT, _FED,
        mesh=tmesh.Mesh(MESH), device="cpu"), "item 10g", id="experts-the-axis-does-not-divide"),
    pytest.param(lambda: steps.init_train_state(
        dataclasses.replace(_CFG, n_heads=3, n_kv_heads=1), _OPT, _FED, mesh=tmesh.Mesh(MESH),
        device="cpu"), "item 10g", id="heads-the-axis-does-not-divide"),
])
def test_routes_outside_the_slice_raise(route, item):
    """Each route the in-pod slice does not run raises
    ``NotImplementedError`` naming its ROADMAP.md item; an in-pod mesh made
    outside its world has no groups and says how to start one.  The routes
    the in-pod program runs (``item`` None: every family, int8 Adam states)
    run: rank 0's state holds each leaf's shard by its sanitized spec (a
    quarter of the Mamba ``in_proj``, of the MoE's expert stacks) and an
    int8 moment the whole leaf's block scales."""
    if item is None:
        cfg, opt, state = route()
        mesh = tmesh.Mesh(MESH)
        whole, specs = steps.state_specs(cfg, opt, _FED, mesh)
        for path, p in tree_util.leaves(state["params"]):
            want = local_shard(tree_util.get(whole["params"], path),
                               tree_util.get(specs["params"], path), mesh.shape, mesh.coords(0))
            assert p.shape == want.shape, path
        for path, m in tree_util.leaves(state["opt"]["m"]):
            p = tree_util.get(state["params"], path)
            if isinstance(m, tuple):
                assert m.q.shape == p.shape and m.q.dtype == torch.int8
                assert m.scale.numel() >= -(-p.numel() // 256)
            else:
                assert m.shape == p.shape
        experts = state["params"].get("layers", {}).get("ffn", {}).get("experts", {})
        for name, v in experts.items():  # the expert stacks: a quarter a rank
            whole_leaf = tree_util.get(whole["params"], ("layers", "ffn", "experts", name))
            assert 4 * v.numel() == whole_leaf.numel(), name
        return
    err, match = item if isinstance(item, tuple) else (NotImplementedError, item)
    with pytest.raises(err, match=match):
        route()


@pytest.mark.parametrize("arch,world", [
    ("qwen3-0.6b", 8), ("mamba2-1.3b", 8), ("zamba2-2.7b", 8),
    # the id it had while this arch ran on (pods, 1, 1) in one process
    pytest.param(MOE, 8, id=f"{MOE}-None"),
    ("qwen2-vl-7b", 8), ("deepseek-v3-671b", 8), ("whisper-base", ValueError),
])
def test_launcher_pod_mode_picks_the_mesh(arch, world, monkeypatch):
    """Pod mode spawns the reference's (pods, 2, 2) world of pods x 4 ranks
    for every arch it trains; the audio arch raises ValueError (its token
    data has no frames, as in the reference's pod mode)."""
    from repro_torch.launch import train as tlaunch

    seen = {}
    monkeypatch.setattr(tlaunch, "run_world", lambda fn, n, **kw: seen.update(world=n))
    argv = ["--arch", arch, "--smoke", "--fedqcs", "--pods", "2", "--device", "cpu",
            "--int8-opt-state"]
    if world is ValueError:
        with pytest.raises(ValueError, match="frames"):
            tlaunch.main(argv)
        assert seen == {}
        return
    tlaunch.main(argv)
    assert seen == {"world": world}


def test_spawned_rank_that_raises_makes_the_parent_raise():
    """A rank's exception stops the world and reaches the caller."""
    with pytest.raises(Exception, match="rank 3 fails"):
        run_world(torch_inpod_worker.fail_on_rank_3, 4, device="cpu", timeout_s=60)
