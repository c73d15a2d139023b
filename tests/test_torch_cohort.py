"""Port parity: the cohort mode for the registry models -- ``TokenClientData``,
the engine over nested bf16/fp32 parameter trees, the nested server
optimizers, the launcher's ``--fed-cohort`` and
``examples/distributed_train_torch.py`` -- on the CPU.

The engine runs the reference's three cohort archs at their smoke configs
(fp32; ``tests/test_models.py``'s ``FED_COHORT_ARCHS``) at the launcher's
FedQCS point (N = 255, R = 3, Q = 3, s_ratio 0.05, 15 scalar-variance GAMP
iterations, fedqcs-ae), 4 clients of 2 x 16 tokens.  Both engines start
from the same parameters (``convert.from_reference``), the same A, the
reference's ``TokenClientData`` batches (replayed to the port by
``_Replay``) and the reference's draws (``torch_fed_parity.reference_draw``);
the reference's rounds are jitted and computed once a pytest run
(``torch_shared.shared``).

Contracts:
  * ``TokenClientData``'s dialect mixtures ``_p`` and ``counts``
    bit-identical to the reference's; batches deterministic, fresh each
    round, (C, batch, seq); every row the affine rule of one dialect;
  * one round: the decoded aggregate within NMSE 1e-4 of the reference's
    (the GAMP pin); every parameter within 2 lr (the tolerance of
    ``tests/test_torch_serve.py::test_train_step_matches_reference``: a
    near-zero aggregate entry's sign can part, which one Adam step turns
    into up to 2 lr); the residuals atol 1e-5; stats nu_quant 1e-5
    relative;
  * a bf16 tree keeps every leaf's dtype through a round, as the
    reference's does, its parameters within 2 lr and each side's bf16
    rounding; fedavg and fedavgm over a nested bf16/fp32 tree
    bit-identical to the reference's updates;
  * ``grad_accum=2`` (per-tensor layout, segment-streamed encode) on a
    nested tree: the same round contracts.
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core.compression import FedQCSConfig as JCfg  # noqa: E402
from repro.fed import engine as jeng  # noqa: E402
from repro.fed import server_opt as jsrv  # noqa: E402
from repro.fed.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.obs import reader as jreader  # noqa: E402
from repro_torch import fed as tfed  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core.compression import FedQCSConfig as TCfg  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.fed import server_opt as tsrv  # noqa: E402
from repro_torch.fed.scheduler import SchedulerConfig as TSched  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.obs import reader as treader  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from torch_fed_parity import nmse, reference_draw, reference_round  # noqa: E402
from torch_shared import shared, one_torch_thread  # noqa: E402,F401

ARCHS = ["qwen3-0.6b", "mamba2-1.3b", "qwen3-moe-235b-a22b"]
CLIENTS, BATCH, SEQ, LR = 4, 2, 16, 3e-3
FED = dict(block_size=255, reduction_ratio=3, bits=3, s_ratio=0.05, gamp_iters=15,
           gamp_variance_mode="scalar")
GHAT_NMSE = 1e-4  # the GAMP pin
PARAM_ATOL = 2 * LR  # test_train_step_matches_reference's parameter tolerance
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", k) for k in p): v for p, v in flat}


# ---------------------------------------------------------------------------
# TokenClientData
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 0.01, 1.0])
def test_token_client_data_mixtures_are_the_references(alpha):
    kw = dict(vocab_size=97, batch=4, seq=16, clients=6, alpha=alpha, seed=1)
    jd, td = jeng.TokenClientData(**kw), teng.TokenClientData(**kw, device="cpu")
    assert td._p.dtype == jd._p.dtype and np.array_equal(td._p, jd._p)
    assert td.counts.dtype == jd.counts.dtype and np.array_equal(td.counts, jd.counts)


def test_token_client_data_batches():
    """The reference's own checks (``tests/test_fed.py``): deterministic,
    fresh each round, (C, batch, seq), near one-hot mixtures at alpha
    0.01; int64 on the device; a client's batch its own (independent of
    the cohort around it)."""
    data = teng.TokenClientData(vocab_size=97, batch=4, seq=16, clients=6, alpha=0.01, seed=1,
                                device="cpu")
    b1 = data.cohort_batch(0, np.array([0, 1, 2]))
    b2 = data.cohort_batch(0, np.array([0, 1, 2]))
    assert set(b1) == {"tokens", "labels"}
    assert b1["tokens"].shape == (3, 4, 16) and b1["tokens"].dtype == torch.int64
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"], b2["labels"])
    b3 = data.cohort_batch(1, np.array([0, 1, 2]))
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert torch.equal(data.cohort_batch(0, np.array([2]))["tokens"][0], b1["tokens"][2])
    assert torch.equal(b1["tokens"][:, :, 1:], b1["labels"][:, :, :-1])
    assert float(data._p.max(axis=1).mean()) > 0.8


def _rule(start, c, seq, vocab):
    """The reference's affine rule in its int32 arithmetic (jnp)."""
    idx = jnp.arange(seq + 1)
    return np.asarray((jnp.asarray(start, jnp.int32) * jnp.power(31, idx % 8)
                       + jnp.asarray(c, jnp.int32) * idx) % vocab)


def test_token_client_data_rows_follow_their_dialects_rule():
    """With noise 0 every row is the affine rule of one dialect d (c = 17 +
    5 d); at alpha 0.01 that is the client's dominant dialect for most rows.
    The same draws with noise 0.2 keep the rule on every position the
    noise spared (>= 70% of them)."""
    kw = dict(vocab_size=97, batch=8, seq=16, clients=6, alpha=0.01, seed=3, device="cpu")
    clean = teng.TokenClientData(**kw, noise=0.0).cohort_batch(2, np.arange(6))
    noisy = teng.TokenClientData(**kw, noise=0.2).cohort_batch(2, np.arange(6))
    p = teng.TokenClientData(**kw)._p
    seqs = np.concatenate([clean["tokens"].numpy(), clean["labels"].numpy()[..., -1:]], -1)
    dominant = 0
    for k in range(6):
        for r in range(8):
            row = seqs[k, r]
            hits = [d for d in range(10)
                    if np.array_equal(_rule(row[0], 17 + 5 * d, 16, 97), row)]
            assert hits, (k, r)
            dominant += int(np.argmax(p[k])) in hits
    assert dominant >= 0.8 * 48
    same = noisy["tokens"].numpy() == clean["tokens"].numpy()
    assert same.mean() >= 0.7 and not same.all()


# ---------------------------------------------------------------------------
# one round against the reference's
# ---------------------------------------------------------------------------


class _Replay:
    """The port's data source for the parity rounds: the reference's
    ``TokenClientData`` batches, recorded by round."""

    def __init__(self, batches, clients):
        self.batches = batches
        self.counts = np.ones(clients, np.int64)

    def cohort_batch(self, round_idx, ids):
        return {k: torch.tensor(v.astype(np.int64)) for k, v in self.batches[round_idx].items()}


def _cfg(arch, dtype=None):
    cfg = jreg.smoke_config(arch)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _ref_cohort(arch, dtype=None, cohort_kw=None, server_kw=None):
    """One reference round of the launcher's cohort engine (fedqcs-ae, full
    participation, FedAdam at lr 3e-3 unless ``server_kw``): parameters
    before and after, A, the round's batches, the decoded aggregate, the
    stats and the residuals."""
    cfg = _cfg(arch, dtype)
    params = jax.jit(lambda k: jmodel.init_params(cfg, k))(jax.random.PRNGKey(0))
    data = jeng.TokenClientData(cfg.vocab_size, batch=BATCH, seq=SEQ, clients=CLIENTS,
                                alpha=0.5)
    batches = {}
    draw = data.cohort_batch

    def record(t, ids):
        out = draw(t, ids)
        batches[t] = _np(out)
        return out

    data.cohort_batch = record
    je = jeng.CohortEngine(
        params, jax.grad(lambda p, b: jmodel.train_loss(p, b, cfg)), data,
        fed_cfg=JCfg(**FED),
        cohort=jeng.CohortConfig(method="fedqcs-ae", chunk=2, **(cohort_kw or {})),
        sched=JSched(kind="full"),
        server=jsrv.ServerOptConfig(**dict(dict(kind="fedadam", lr=LR), **(server_kw or {}))),
    )
    stats, ghat = reference_round(je)
    return {"params": _np(params), "a": np.asarray(je.codec.a), "batches": batches,
            "ghat": ghat, "stats": {k: float(v) for k, v in stats.items()},
            "new": _np(je.params), "residuals": np.asarray(je.residuals)}


def _port_round(arch, ref, dtype=None, cohort_kw=None, server_kw=None):
    """The same round on the port's engine, built as the launcher builds
    it, from the reference's parameters, A, batches and draws."""
    cfg = registry.smoke_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params, a = from_reference(ref["params"], ref["a"])
    te = teng.CohortEngine(
        params, lambda p, b: steps.value_and_grad(p, b, cfg)[1], _Replay(ref["batches"], CLIENTS),
        fed_cfg=TCfg(**FED),
        cohort=teng.CohortConfig(method="fedqcs-ae", chunk=2, **(cohort_kw or {})),
        sched=TSched(kind="full"),
        server=tsrv.ServerOptConfig(**dict(dict(kind="fedadam", lr=LR), **(server_kw or {}))),
        device="cpu", a=a, draw=reference_draw(0),
    )
    return te, te.run_round()


def _check_params(te, ref, rel: float = 0.0):
    """Every leaf in the reference's dtype and within 2 lr (plus ``rel`` of
    each side's value) of the reference's after the round; some leaf
    moved."""
    want, before = _paths(ref["new"]), _paths(ref["params"])
    moved = 0.0
    for path, p in tree_util.leaves(te.params):
        assert str(p.dtype) == f"torch.{want[path].dtype}", path
        got, w = p.float().numpy(), want[path].astype(np.float32)
        assert np.all(np.abs(got - w) <= PARAM_ATOL + rel * (np.abs(got) + np.abs(w))), path
        moved = max(moved, float(np.max(np.abs(got - before[path].astype(np.float32)))))
    assert moved > 0


def _check_round(te, stats, ref):
    assert te._per_client
    assert nmse(te.last_ghat.numpy(), ref["ghat"]) <= GHAT_NMSE
    assert set(stats) == set(ref["stats"])
    for k in ("cohort", "participating"):
        assert stats[k] == ref["stats"][k]
    assert abs(stats["nu_quant"] - ref["stats"]["nu_quant"]) <= 1e-5 * ref["stats"]["nu_quant"]
    np.testing.assert_allclose(te.residuals.numpy(), ref["residuals"], rtol=0, atol=1e-5)
    _check_params(te, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_round_matches_reference(arch, tmp_path_factory):
    ref = shared(tmp_path_factory, f"cohort_ref_{arch}", lambda: _ref_cohort(arch))
    te, stats = _port_round(arch, ref)
    _check_round(te, stats, ref)


def test_bf16_tree_keeps_every_leaf_dtype(tmp_path_factory):
    """The bf16 smoke config (the model zoo's default dtype; the RMS-norm
    scales bf16 too) through one round: every leaf keeps its dtype, as in
    the reference's round, within 2 lr and each side's bf16 rounding (half
    a bf16 step, 2^-8 of its value) of the reference's parameters.  The aggregate is not pinned
    here: two bf16 gradients summed in other orders part by bf16's rounding
    (2^-8 relative), which moves the top-S picks (the fp32 rounds above
    hold it)."""
    ref = shared(tmp_path_factory, "cohort_ref_bf16",
                 lambda: _ref_cohort("qwen3-0.6b", dtype="bfloat16"))
    te, stats = _port_round("qwen3-0.6b", ref, dtype="bfloat16")
    assert {str(v.dtype) for v in _paths(ref["new"]).values()} == {"bfloat16"}
    assert {p.dtype for _, p in tree_util.leaves(te.params)} == {torch.bfloat16}
    assert te.last_ghat.dtype == torch.float32 and bool(torch.isfinite(te.last_ghat).all())
    assert stats["cohort"] == ref["stats"]["cohort"]
    _check_params(te, ref, rel=2.0**-8)


def test_grad_accum_on_a_nested_tree_matches_reference(tmp_path_factory):
    """``grad_accum=2`` (each client's 2 samples as 2 microbatches, summed
    then halved) over the per-tensor layout and the segment-streamed
    encode: the per-client pass builds the batched gradient tree the
    streamed pass slices."""
    kw = dict(layout="per_tensor", encode_stream=True, grad_accum=2)
    ref = shared(tmp_path_factory, "cohort_ref_accum",
                 lambda: _ref_cohort("qwen3-0.6b", cohort_kw=kw))
    te, stats = _port_round("qwen3-0.6b", ref, cohort_kw=kw)
    assert len(te.layout.segments) > 1
    _check_round(te, stats, ref)


@pytest.mark.parametrize("kind", ["fedavg", "fedavgm"])
def test_nested_server_updates_match_reference(kind):
    """Two updates over a nested tree with bf16 and fp32 leaves: fp32
    arithmetic, each parameter cast back to its dtype, bit for bit."""
    rng = np.random.default_rng(5)
    shapes = {"a": {"w": (3, 4), "b": (4,)}, "n": (5,)}
    tree = {"a": {"w": rng.normal(size=(3, 4)), "b": rng.normal(size=4)}, "n": rng.normal(size=5)}
    j_params = {"a": {"w": jnp.asarray(tree["a"]["w"], jnp.bfloat16),
                      "b": jnp.asarray(tree["a"]["b"], jnp.float32)},
                "n": jnp.asarray(tree["n"], jnp.bfloat16)}
    t_params = from_reference(_np(j_params))[0]
    cfg_j, cfg_t = jsrv.ServerOptConfig(kind=kind, lr=0.1), tsrv.ServerOptConfig(kind=kind, lr=0.1)
    sj, st = jsrv.init_server_state(cfg_j, j_params), tsrv.init_server_state(cfg_t, t_params)
    for step in range(2):
        g = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
        gj = jax.tree_util.tree_map(jnp.asarray, g)
        gt = tree_util.tree_map(torch.tensor, g)
        j_params, sj = jsrv.server_update(cfg_j, gj, sj, j_params, step)
        t_params, st = tsrv.server_update(cfg_t, gt, st, t_params, step)
        want = _paths(_np(j_params))
        for path, p in tree_util.leaves(t_params):
            assert str(p.dtype) == f"torch.{want[path].dtype}", path
            assert np.array_equal(p.float().numpy(), want[path].astype(np.float32)), path
        if kind == "fedavgm":
            want_m = _paths(_np(sj["m"]))
            for path, m in tree_util.leaves(st["m"]):
                assert m.dtype == torch.float32 and np.array_equal(m.numpy(), want_m[path])


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

LAUNCH = ["--smoke", "--fed-cohort", "--clients", "4", "--steps", "2", "--log-every", "1",
          "--seq", "16", "--device", "cpu"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("extra", [
    pytest.param([], id="barrier"),
    pytest.param(["--stream", "2"], id="stream"),
    pytest.param(["--snr-db", "10"], id="awgn"),
    pytest.param(["--sample-frac", "0.5", "--dropout", "0.25"], id="sampled"),
    pytest.param(["--server-opt", "fedavgm"], id="fedavgm"),
])
def test_launcher_cohort_mode(arch, extra, capsys):
    """``python -m repro_torch.launch.train --arch ARCH --smoke --fed-cohort
    ...`` on the CPU: two rounds, each logged with its cohort, participants
    and nmse, the parameters moved and finite."""
    before = tree_util.leaves(steps.abstract_params(registry.smoke_config(arch)))
    engine = tlaunch.main(["--arch", arch] + LAUNCH + extra)
    out = capsys.readouterr().out
    assert f"[fed-cohort] arch={arch}" in out and "[fed-cohort] done" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("round ")]
    assert len(lines) == 2 and all("eval-loss" in ln and "nmse" in ln for ln in lines)
    assert engine.round == 2 and engine._per_client
    assert [p for p, _ in tree_util.leaves(engine.params)] == [p for p, _ in before]
    assert all(bool(torch.isfinite(p).all()) for _, p in tree_util.leaves(engine.params))
    if "--sample-frac" in extra:
        assert all("cohort    2" in ln for ln in lines)


def test_launcher_cohort_record(tmp_path, capsys):
    """``--record DIR``: the run directory validates and both packages'
    readers summarize it (two round events and two eval events)."""
    run = tmp_path / "run"
    tlaunch.main(["--arch", "qwen3-0.6b"] + LAUNCH + ["--record", str(run)])
    assert f"[fed-cohort] run log: {run}" in capsys.readouterr().out
    assert treader.validate_dir(str(run)) == [] and jreader.validate_dir(str(run)) == []
    text = treader.summarize(str(run))
    assert text == jreader.summarize(str(run)) and "rounds" in text
    events = [ln for ln in (run / "events.jsonl").read_text().splitlines()]
    assert sum('"kind": "round"' in e for e in events) == 2
    assert sum('"kind": "eval"' in e for e in events) == 2


@pytest.mark.parametrize("argv,err,match", [
    pytest.param(["--arch", "whisper-base"], ValueError, "frames", id="audio"),
    pytest.param(["--arch", "qwen2-vl-7b"], ValueError, "patches", id="vlm"),
    pytest.param(["--arch", "qwen3-0.6b", "--interleave", "2"], None, None, id="interleave"),
    pytest.param(["--arch", "qwen3-0.6b", "--grad-accum", "2"], ValueError, "encode_stream",
                 id="grad-accum-without-interleave"),
])
def test_launcher_cohort_mode_rejects(argv, err, match):
    """The archs whose batches the token data cannot make (the reference's
    first round fails on the missing key) and the reference's gate on
    ``--grad-accum`` without ``--interleave``.  ``--interleave 2`` (no
    ``err``) is taken: the launcher's engine streams the encode over the
    producer's own layout, with the producer as its segment source."""
    if err is None:
        args = tlaunch.parse_args(argv + LAUNCH)
        engine, _, _ = tlaunch.make_fed_cohort(args, registry.smoke_config(args.arch))
        prod = engine._grad_segments_fn
        assert engine.cohort.encode_stream and engine.cohort.grad_accum == 1
        assert type(prod).__name__ == "InterleavedSegments" and prod.layout is engine.layout
        assert engine.layout.kind == "per_tensor" and len(engine.layout.segments) == 24
        return
    with pytest.raises(err, match=match):
        tlaunch.main(argv + LAUNCH)


def _example():
    """The example as a module registered under its name (its ranks are
    spawned with a function of it, pickled by that name)."""
    spec = importlib.util.spec_from_file_location(
        "distributed_train_torch", os.path.join(ROOT, "examples", "distributed_train_torch.py"))
    example = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = example
    spec.loader.exec_module(example)
    return example


def test_distributed_example_restarts_exactly(tmp_path, capfd):
    """12 smoke steps on the reference's (2, 2, 2) world with pod 1 down at
    steps 3-7 (``--inject-failure 3``), then a rerun that resumes after the
    step-10 checkpoint: its parameters, moments and residuals bit-identical
    to the uninterrupted run's (rank 0 prints: its lines reach the file
    descriptor)."""
    example = _example()
    argv = ["--steps", "12", "--inject-failure", "3", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    full = example.main(argv)
    out = capfd.readouterr().out
    down = sorted(int(ln.split()[1]) for ln in out.splitlines()
                  if ln.startswith("step") and "[pod1 DOWN]" in ln)
    assert down == [3, 4, 5, 6, 7]
    assert "[wire] compressed payload/pod/step" in out
    assert all(np.isfinite(float(ln.split()[3])) for ln in out.splitlines()
               if ln.startswith("step"))
    again = example.main(argv)
    out = capfd.readouterr().out
    assert "[restore] resumed after step 10" in out
    assert [ln.split()[1] for ln in out.splitlines() if ln.startswith("step")] == ["11"]
    for key in ("params", "opt", "residual", "step"):
        for path, leaf in tree_util.leaves(full[key]):
            assert torch.equal(leaf, tree_util.get(again[key], path)), (key, path)


def test_fed_exports_token_client_data():
    assert tfed.TokenClientData is teng.TokenClientData
