"""Port parity, whole slice: one federated round of the paper's experiment.

The reference (``repro.paper.mlp.run_federated``'s engine setup, kernel
route: ``use_kernels=True``, ``gamp_variance_mode="scalar"``) and the port
(``repro_torch``, plain versions on the CPU) run one full-width round --
K = 30 clients, N = 1591, M = 530, Q = 3, S = 159 -- from the same initial
parameters and the same sensing matrix, carried across with
``convert.from_reference``.  Contracts:

  * numpy data, partition, scheduler and batch draws: identical;
  * the round's decoded gradient: NMSE <= 1e-3 against the reference's
    (looser than the 1e-4 GAMP contract because the per-client gradient
    products sum in another order and can flip a code at a threshold; the
    count of differing wire lanes is printed);
  * the round's ``nmse`` stat: within 1e-3 of the reference's;
  * params: allclose (atol 1e-6) on entries where |ghat| > 1e-4 max|ghat|.
    Adam's first step is ~ +-lr * sign(ghat) there; on near-zero entries it
    is ghat / (|ghat| + eps) * lr, which may differ by up to 2 lr.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.compression import FedQCSConfig as JCfg  # noqa: E402
from repro.core.compression import unpack_codes as j_unpack  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro.fed import engine as jeng  # noqa: E402
from repro.fed.channel import ChannelConfig as JChan  # noqa: E402
from repro.fed.partition import PartitionConfig as JPart  # noqa: E402
from repro.fed.partition import partition_indices as j_partition  # noqa: E402
from repro.fed.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro.fed.scheduler import SchedulerState as JState  # noqa: E402
from repro.fed.scheduler import select_cohort as j_select  # noqa: E402
from repro.fed.server_opt import ServerOptConfig as JSrv  # noqa: E402
from repro.paper import mlp as jmlp  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core.compression import FedQCSConfig as TCfg  # noqa: E402
from repro_torch.data import mnist as tmnist  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.fed.partition import PartitionConfig as TPart  # noqa: E402
from repro_torch.fed.partition import partition_indices as t_partition  # noqa: E402
from repro_torch.fed.scheduler import SchedulerConfig as TSched  # noqa: E402
from repro_torch.fed.scheduler import SchedulerState as TState  # noqa: E402
from repro_torch.fed.scheduler import select_cohort as t_select  # noqa: E402
from repro_torch.paper import mlp as tmlp  # noqa: E402
from torch_shared import shared as _shared, one_torch_thread  # noqa: E402,F401

jax.config.update("jax_platform_name", "cpu")

K = 30


@pytest.fixture(scope="module")
def data():
    (xtr, ytr, xte, yte), _ = jmnist.load(0)
    parts = j_partition(ytr, K, JPart(kind="paper", seed=0))
    return xtr, ytr, xte, yte, parts


def test_numpy_substrate_identical(data):
    xtr, ytr, xte, yte, parts = data
    (txtr, tytr, txte, tyte), real = tmnist.load(0)
    assert not real
    for a, b in ((xtr, txtr), (ytr, tytr), (xte, txte), (yte, tyte)):
        assert np.array_equal(a, b)
    tparts = t_partition(ytr, K, TPart(kind="paper", seed=0))
    assert all(np.array_equal(p, q) for p, q in zip(parts, tparts))
    counts = np.array([len(p) for p in parts])
    js, ts = JState.init(K), TState.init(K)
    for t in range(3):
        for cfg_kw in (dict(), dict(dropout_prob=0.3, seed=4)):
            ji, jr, js2 = j_select(JSched(**cfg_kw), js, t, counts)
            ti, tr, ts2 = t_select(TSched(**cfg_kw), ts, t, counts)
            assert np.array_equal(ji, ti) and np.array_equal(jr, tr)
            assert np.array_equal(js2.last_round, ts2.last_round)
        js, ts = js2, ts2
    jd = jeng.ArrayClientData(xtr, ytr, parts, batch_size=2, seed=0)
    td = teng.ArrayClientData(xtr, ytr, parts, batch_size=2, seed=0, device="cpu")
    ids = np.arange(K)
    jb, tb = jd.cohort_batch(3, ids), td.cohort_batch(3, ids)
    assert np.array_equal(np.asarray(jb["x"]), tb["x"].numpy())
    assert np.array_equal(np.asarray(jb["y"]), tb["y"].numpy())


def test_mlp_loss_grad_accuracy_match(data):
    xtr, ytr, _, _, _ = data
    params_j = jmlp.init_mlp(jax.random.PRNGKey(3))
    params_t, _ = from_reference({k: np.asarray(v) for k, v in params_j.items()})
    x, y = xtr[:64], ytr[:64]
    lj = float(jmlp.mlp_loss(params_j, jnp.asarray(x), jnp.asarray(y)))
    lt = float(tmlp.mlp_loss(params_t, torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64)))
    assert abs(lj - lt) <= 1e-6 * abs(lj)
    gj = jmlp.mlp_grad_fn(params_j, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    gt = tmlp.mlp_grad_fn(params_t, {"x": torch.as_tensor(x),
                                     "y": torch.as_tensor(y, dtype=torch.int64)})
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]), rtol=1e-4, atol=1e-7)
    aj = float(jmlp.accuracy(params_j, jnp.asarray(x), jnp.asarray(y)))
    at = float(tmlp.accuracy(params_t, torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64)))
    assert aj == at
    model = tmlp.MLP()
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == {
        k: tuple(v.shape) for k, v in params_j.items()}


FED = dict(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=25, use_kernels=True,
           gamp_variance_mode="scalar", block_size=1591)


def _reference_round(method, data, cohort_kw):
    """One reference round, set up exactly as paper/mlp.run_federated does,
    capturing the PS pass's decoded blocks and the wire payload."""
    xtr, ytr, _, _, parts = data
    params = jmlp.init_mlp(jax.random.PRNGKey(0))
    eng = jeng.CohortEngine(
        params, jmlp.mlp_grad_fn, jeng.ArrayClientData(xtr, ytr, parts, batch_size=1, seed=0),
        fed_cfg=JCfg(**FED), cohort=jeng.CohortConfig(method=method, seed=0, **cohort_kw),
        sched=JSched(kind="full", seed=0), chan=JChan(kind="ideal"),
        server=JSrv(kind="fedadam", lr=0.003, b1=0.9, b2=0.999, eps=1e-8),
    )
    seen = {}
    ps = eng._ps_jit

    def capture(payloads, *rest):
        seen["payloads"] = payloads
        out = ps(payloads, *rest)
        seen["ghat"] = out[0]
        return out

    eng._ps_jit = capture
    stats = eng.run_round()
    params_np = {k: np.asarray(v) for k, v in params.items()}
    new_np = {k: np.asarray(v) for k, v in eng.params.items()}
    pay = seen["payloads"]
    codes = pay["codes"] if "codes" in pay else j_unpack(pay["words"], 3, 530)
    return (params_np, np.asarray(eng.codec.a), stats, np.asarray(seen["ghat"]), new_np,
            np.asarray(codes), np.asarray(eng.residuals))


def _full_width_round(method, data, cohort_kw):
    """One full-width round in both packages from the same parameters and A,
    held to the module's contracts; returns the count of differing wire
    lanes."""
    xtr, ytr, _, _, parts = data
    params_np, a_np, stats_j, ghat_j, new_j, codes_j, res_j = _reference_round(method, data,
                                                                               cohort_kw)
    params_t, a_t = from_reference(params_np, a_np)
    eng = teng.CohortEngine(
        params_t, tmlp.mlp_grad_fn,
        teng.ArrayClientData(xtr, ytr, parts, batch_size=1, seed=0, device="cpu"),
        fed_cfg=TCfg(**FED), cohort=teng.CohortConfig(method=method, seed=0, **cohort_kw),
        sched=TSched(kind="full", seed=0),
        server=tmlp.ServerOptConfig(kind="fedadam", lr=0.003, b1=0.9, b2=0.999, eps=1e-8),
        device="cpu", a=a_t,
    )
    return _hold_round(method, eng, float(stats_j["nmse"]), ghat_j, new_j, codes_j, res_j)


def _hold_round(method, eng, nmse_j, ghat_j, new_j, codes_j, res_j):
    """Runs the port engine's next round and holds it to the module's
    contracts against the reference round's nmse stat, decoded gradient,
    new parameters, wire codes and residuals; returns the count of
    differing wire lanes."""
    seen = {}
    client_pass = eng._client_pass

    def capture(*args):
        out = client_pass(*args)
        seen["words"] = out[0]["words"]
        return out

    eng._client_pass = capture
    stats_t = eng.run_round()
    codes_t = eng.codec.unpack(seen["words"]).numpy()
    n_diff = int(np.sum(codes_t != codes_j))
    print(f"{method}: {n_diff} of {codes_j.size} wire lanes differ; "
          f"nmse port {stats_t['nmse']:.6f} reference {nmse_j:.6f}")
    ghat_t = eng.last_ghat.numpy()
    nmse = np.sum((ghat_t - ghat_j) ** 2) / np.sum(ghat_j**2)
    assert nmse <= 1e-3, nmse
    assert abs(stats_t["nmse"] - nmse_j) <= 1e-3
    assert stats_t["cohort"] == K and stats_t["participating"] == K
    np.testing.assert_allclose(eng.residuals.numpy(), res_j, rtol=1e-4, atol=1e-6)
    gj = {k: v.numpy() for k, v in eng.layout.tree_from_blocks(torch.tensor(ghat_j)).items()}
    big = 1e-4 * np.abs(ghat_j).max()
    for k, v in new_j.items():
        mask = np.abs(gj[k].reshape(v.shape)) > big
        np.testing.assert_allclose(eng.params[k].numpy()[mask], v[mask], rtol=0, atol=1e-6)
        assert np.all(np.abs(eng.params[k].numpy() - v) <= 2 * 0.003 + 1e-6)
    return n_diff


@pytest.mark.parametrize("method", ["fedqcs-ae", "fedqcs-ea"])
def test_one_full_width_round_matches_reference(method, data):
    _full_width_round(method, data, {})


def test_one_full_width_per_tensor_round_matches_reference(data):
    """The paper's round over the per-tensor layout (13 block rows a client)
    with the segment-streamed encode: every wire lane equal."""
    assert _full_width_round("fedqcs-ea", data, dict(layout="per_tensor",
                                                     encode_stream=True)) == 0


def test_run_federated_on_the_cpu():
    res = tmlp.run_federated("fedqcs-ae", steps=2, k_devices=10, eval_every=1, device="cpu")
    assert len(res.nmses) == 2 and all(np.isfinite(res.nmses))
    assert len(res.accs) == 2 and len(res.round_ms) == 2
    assert res.bits_per_entry == 1.0
    assert res.last_ghat.shape == (10, 1591) and bool(torch.isfinite(res.last_ghat).all())


def _per_tensor_engine_builds_once():
    """The per-tensor cohort config builds its layout once, in the
    constructor: the paper's MLP in 13 block rows, the residuals on them."""
    mono, _ = tmlp.mlp_engine("fedqcs-ea", k_devices=4, device="cpu",
                              fed_cfg=TCfg(**dict(FED, use_kernels=False)))
    assert mono.layout.kind == "monolithic" and mono.nb == 10
    eng = teng.CohortEngine(mono.params, tmlp.mlp_grad_fn, mono.data, fed_cfg=mono.fed_cfg,
                            cohort=teng.CohortConfig(method="fedqcs-ea", layout="per_tensor"),
                            device="cpu")
    assert eng.spec is eng.layout and eng.layout.kind == "per_tensor"
    assert eng.nb == 13 and tuple(eng.residuals.shape) == (4, 13, 1591)


# Explicit ids keep each case's name from before the baselines (item 3), the
# noisy uplinks (item 5), the round's remaining knobs (item 6) and the
# per-tensor layouts (item 9) were ported; their raise cases became the
# parity tests of tests/test_torch_baselines.py, tests/test_torch_channel.py,
# tests/test_torch_knobs.py and tests/test_torch_layout.py, and route5 now
# builds a per-tensor engine (item "ported").
@pytest.mark.parametrize("route,item", [
    pytest.param(_per_tensor_engine_builds_once, "ported", id="route5-item 9"),
])
def test_round_routes_outside_the_slice_raise(route, item):
    if item == "ported":
        route()
        return
    with pytest.raises(NotImplementedError, match=item):
        route()


def _reference_run_federated(method):
    """The reference's own ``run_federated(method, steps=1, seed=0)`` on the
    kernel route, its engine's first round captured (the engine class is
    swapped for one that records its state): initial parameters, A, the
    nmse stat, the decoded blocks, the new parameters, the wire codes and
    the residuals, as numpy."""
    seen = {}
    base = jmlp.CohortEngine

    class Recording(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["engine"] = self
            seen["params"] = {k: np.asarray(v) for k, v in self.params.items()}
            ps = self._ps_jit

            def capture(payloads, *rest):
                seen["payloads"] = payloads
                out = ps(payloads, *rest)
                seen["ghat"] = out[0]
                return out

            self._ps_jit = capture

    jmlp.CohortEngine = Recording
    try:
        res = jmlp.run_federated(method, steps=1, seed=0, fed_cfg=JCfg(**SEED_FED))
    finally:
        jmlp.CohortEngine = base
    eng, pay = seen["engine"], seen["payloads"]
    codes = pay["codes"] if "codes" in pay else j_unpack(pay["words"], 3, 530)
    return dict(params=seen["params"], a=np.asarray(eng.codec.a), nmse=float(res.nmses[0]),
                ghat=np.asarray(seen["ghat"]),
                new={k: np.asarray(v) for k, v in eng.params.items()},
                codes=np.asarray(codes), residuals=np.asarray(eng.residuals))


# run_federated's default experiment on the kernel route (block_size is set there)
SEED_FED = dict(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=25, use_kernels=True,
                gamp_variance_mode="scalar")


@pytest.mark.parametrize("method", ["fedqcs-ae", "fedqcs-ea"])
def test_round_from_a_seed_matches_reference(method, tmp_path_factory):
    """The paper's round from ``seed=0`` with each package's defaults alone
    -- no parameters or A carried across, no draw injected: the port's
    ``mlp_engine`` (what its ``run_federated`` drives) against the
    reference's own ``run_federated(seed=0)``, its initial parameters and A
    bit for bit, its round under the module's contracts."""
    ref = _shared(tmp_path_factory, f"round_from_seed_{method}",
                  lambda: _reference_run_federated(method))
    eng, _ = tmlp.mlp_engine(method, fed_cfg=TCfg(**SEED_FED), seed=0, device="cpu")
    for k, v in ref["params"].items():
        assert np.array_equal(eng.params[k].numpy().view(np.int32), v.view(np.int32)), k
    assert np.array_equal(eng.codec.a.numpy().view(np.int32), ref["a"].view(np.int32))
    _hold_round(method, eng, ref["nmse"], ref["ghat"], ref["new"], ref["codes"],
                ref["residuals"])
