"""The port's telemetry (``repro_torch.obs`` and the engine's round events)
against the reference's ``repro.obs``, at the reference tests' toy size
(``tests/test_obs.py``; the engine rounds on the shared 6-client softmax
regression of ``tests/torch_fed_parity.py``, the reference's A and draws
injected).

What is held, and how:
  * schema: the same version, envelope and validators; a run directory
    written by either package validates under both (``validate_run``,
    ``validate_dir``);
  * the reader: ``summarize``, ``compare``, ``tail`` and ``validate`` print
    the same text in both packages on the same run directories;
  * round events: the key set (and the ``phase_ms`` keys) equal to the
    reference's for the same engine configuration, the values to the round
    contract (1e-5 relative; the norms and wire bytes too), and recording
    changes no returned stat and no parameter (bit for bit);
  * ``clip_saturation``: equal to the reference's on the same payload.
"""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.obs as jobs  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.obs import reader as jreader  # noqa: E402
from repro.paper import mlp as jmlp  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.obs import reader as treader  # noqa: E402
from repro_torch.obs.schema import validate_run  # noqa: E402
from repro_torch.obs.trace import SpanCollector, span  # noqa: E402
from repro_torch.paper import mlp as tmlp  # noqa: E402
from torch_fed_parity import engines, port_engine  # noqa: E402

FED = dict(block_size=64, reduction_ratio=2, bits=3, s_ratio=0.2, gamp_iters=10,
           gamp_variance_mode="scalar")


def T(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# schema, sinks, spans
# ---------------------------------------------------------------------------


def test_schema_is_the_references():
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    from repro.obs import schema as jschema
    from repro_torch.obs import schema as tschema

    assert tschema.ENVELOPE_FIELDS == jschema.ENVELOPE_FIELDS
    assert tschema.KIND_REQUIRED == jschema.KIND_REQUIRED
    assert tschema.META_REQUIRED == jschema.META_REQUIRED
    ok = {"v": 1, "kind": "round", "seq": 0, "t": 0.1, "round": 0, "cohort": 4,
          "participating": 4.0, "mystery_field": 1}
    bad = dict(ok)
    del bad["cohort"]
    for ev in (ok, bad, {**ok, "v": 99}, {**ok, "kind": "nope"}, {**ok, "seq": -1}):
        assert tobs.validate_event(ev) == jobs.validate_event(ev)
    meta = {"run_id": "x", "schema_version": 1, "created_unix": 0.0}
    assert validate_run(meta, [ok, {**ok, "seq": 0}]) == jschema.validate_run(
        meta, [ok, {**ok, "seq": 0}])


def _write(recorder_cls, run_dir):
    with recorder_cls(str(run_dir), config={"method": "fedqcs-ae", "Q": 3}) as rec:
        rec.record("round", {"round": 0, "cohort": 8, "participating": 7.0,
                             "nmse": np.float32(0.25), "gamp_iters_mean": torch.tensor(12.5),
                             "phase_ms": {"decode": 1.5}, "round_ms": 1.5})
        rec.record("eval", {"round": 0, "accuracy": 0.9, "loss": 0.3})
        rec.record("span", {"name": "decode", "ms": 1.5})
        rec.record("note", {"msg": "checkpointed"})
    return str(run_dir)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_run_dir_validates_under_both_packages(tmp_path, writer):
    cls = tobs.JsonlRecorder if writer == "port" else jobs.JsonlRecorder
    run_dir = _write(cls, tmp_path / "run")
    assert treader.validate_dir(run_dir) == [] and jreader.validate_dir(run_dir) == []
    meta = treader.load_meta(run_dir)
    events = list(treader.iter_events(run_dir))
    assert validate_run(meta, events) == []
    assert [ev["seq"] for ev in events] == [0, 1, 2, 3]
    assert isinstance(events[0]["nmse"], float) and isinstance(events[0]["gamp_iters_mean"],
                                                              float)
    if writer == "port":
        assert meta["torch_version"] == torch.__version__ and meta["backend"] == "cpu"
        assert "jax_version" not in meta
        with open(tmp_path / "run" / "events.jsonl") as f:
            assert all(json.loads(line) for line in f)


def test_sinks_agree_and_null_recorder_is_inert(tmp_path):
    payloads = [("round", {"round": 0, "cohort": 2, "participating": 2.0}),
                ("eval", {"round": 0, "loss": 1.0}), ("note", {"msg": "hi"})]
    mem = tobs.InMemoryRecorder()
    jsl = tobs.JsonlRecorder(str(tmp_path / "run_b"))
    ref = jobs.InMemoryRecorder()
    for kind, p in payloads:
        mem.record(kind, p)
        jsl.record(kind, p)
        ref.record(kind, p)
    jsl.close()
    jsl.close()  # idempotent
    disk = list(treader.iter_events(str(tmp_path / "run_b")))
    strip = [{k: v for k, v in ev.items() if k != "t"} for ev in mem.events]
    assert strip == [{k: v for k, v in ev.items() if k != "t"} for ev in disk]
    assert strip == [{k: v for k, v in ev.items() if k != "t"} for ev in ref.events]
    with pytest.raises(ValueError, match="close"):
        jsl.record("note", {})
    assert tobs.NULL_RECORDER.active is False
    tobs.NULL_RECORDER.record("round", {"anything": 1})
    eng = port_engine("fedqcs-ae")
    assert eng.obs is tobs.NULL_RECORDER and eng._spans is None
    assert "gamp_iters_mean" not in eng.run_round()


def test_span_collector_accumulates_and_drains(monkeypatch):
    col = SpanCollector()
    for name in ("decode", "decode", "apply"):
        with span(name, col):
            pass
    assert set(col.ms) == {"decode", "apply"}
    assert col.drain()["decode"] >= 0.0 and col.ms == {}
    # with annotations on, a span is also a torch.profiler range
    from repro_torch.obs import trace

    monkeypatch.setattr(trace, "ANNOTATE", True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("fold", col):
            torch.ones(3).sum()
    assert "fold" in {e.name for e in prof.events()} and "fold" in col.ms


# ---------------------------------------------------------------------------
# clip saturation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codebook,bits", [("lloyd_max", 3), ("dithered_uniform", 2),
                                           ("vq", 4)])
def test_clip_saturation_matches_reference(codebook, bits):
    kw = dict(FED, bits=bits, codebook=codebook, vq_dim=2)
    jc = jcomp.BQCSCodec(jcomp.FedQCSConfig(**kw))
    tc = tcomp.BQCSCodec(tcomp.FedQCSConfig(**kw), a=T(jc.a), device="cpu")
    blocks = jnp.asarray(np.random.default_rng(4).normal(size=(5, 64)).astype(np.float32))
    words, _, _ = jc.compress_blocks_packed(blocks, jnp.zeros_like(blocks))
    codes = tc.unpack(T(words))
    want = float(jc.clip_saturation(words))
    assert float(tc.clip_saturation(T(words))) == want
    assert float(tc.clip_saturation(codes, packed=False)) == want
    if codebook == "vq":
        assert want == 0.0
    else:
        n = tc.codebook.n_levels
        extreme = (codes.numpy() == 0) | (codes.numpy() == n - 1)
        assert want == pytest.approx(np.mean(extreme), rel=1e-7)  # f32 rounding


# ---------------------------------------------------------------------------
# engine round events
# ---------------------------------------------------------------------------

ROUND_CASES = {
    "ae-awgn": ("fedqcs-ae", dict(kind="awgn", snr_db=10.0), None),
    "ea": ("fedqcs-ea", {}, None),
    "ae-mimo_mac": ("fedqcs-ae", dict(kind="mimo_mac", n_rx=8), None),
    "qcs-qiht": ("qcs-qiht", {}, None),
    "ae-stream-awgn": ("fedqcs-ae", dict(kind="awgn", snr_db=10.0),
                       dict(batch_clients=4, deadline=1e9)),
    "ea-stream": ("fedqcs-ea", {}, dict(batch_clients=4, deadline=1e9)),
}
# measured, not computed: these differ between any two runs
WALL = {"t", "phase_ms", "round_ms"}
# csi_target_mismatch is the mean of (f^T h_hat_k - 1)^2 over an fp32 solve
# whose f^T h_hat_k is good to a few ulps of 1: compared as its root (the
# RMS mismatch) to 1e-6, ~8 ulps of 1
ROOT_COMPARED = {"csi_target_mismatch"}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_round_events_match_reference(case):
    """Two recorded rounds in both engines: the same event keys (and phase
    names), the same values within the round contract, round_ms the sum of
    the phases, and the stats the port returns unchanged by recording."""
    method, chan_kw, stream = ROUND_CASES[case]
    rec_j, rec_t = jobs.InMemoryRecorder(), tobs.InMemoryRecorder()
    je, te = engines(method, chan_kw=chan_kw, stream=stream, fed_kw=dict(
        gamp_variance_mode="scalar"), obs=(rec_j, rec_t))
    plain = port_engine(method, chan_kw=chan_kw, stream=stream, fed_kw=dict(
        gamp_variance_mode="scalar"), a=te.codec.a, draw=te.draw)
    for _ in range(2):
        je.run_round()
        stats, unrecorded = te.run_round(), plain.run_round()
        assert {k: stats[k] for k in unrecorded} == unrecorded
    for k in te.params:
        assert torch.equal(te.params[k], plain.params[k])
    ev_j = [e for e in rec_j.events if e["kind"] == "round"]
    ev_t = [e for e in rec_t.events if e["kind"] == "round"]
    assert len(ev_t) == len(ev_j) == 2
    for a, b in zip(ev_t, ev_j):
        assert set(a) == set(b), (sorted(set(a) ^ set(b)))
        assert set(a["phase_ms"]) == set(b["phase_ms"])
        assert a["round_ms"] == pytest.approx(sum(a["phase_ms"].values()))
        assert tobs.validate_event(a) == [] and jobs.validate_event(a) == []
        for k, v in b.items():
            if k in WALL or k in ("v", "kind", "seq"):
                assert k in WALL or a[k] == v
                continue
            if k in ROOT_COMPARED:
                assert np.sqrt(a[k]) == pytest.approx(np.sqrt(v), abs=1e-6), (k, a[k], v)
                continue
            assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-9), (k, a[k], v)


def test_run_federated_records_round_and_eval_events():
    """``run_federated(obs=)`` on the paper's MLP (2 clients' worth of
    iterations cut to 3): one round event per round and an eval event per
    evaluation, in order; ``device_grad`` is the reference's gradient."""
    rec = tobs.InMemoryRecorder()
    cfg = tcomp.FedQCSConfig(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=3,
                             use_kernels=True, gamp_variance_mode="scalar")
    res = tmlp.run_federated("fedqcs-ae", steps=2, k_devices=6, eval_every=1, device="cpu",
                             fed_cfg=cfg, obs=rec)
    kinds = [(e["kind"], e["round"]) for e in rec.events]
    assert kinds == [("round", 0), ("eval", 0), ("round", 1), ("eval", 1)]
    assert [e["accuracy"] for e in rec.events if e["kind"] == "eval"] == res.accs
    assert [e["nmse"] for e in rec.events if e["kind"] == "round"] == res.nmses
    rng = np.random.default_rng(5)
    x = rng.random((4, 784)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    jp = jmlp.init_mlp(jax.random.PRNGKey(0))
    want = jmlp.device_grad(jp, jnp.asarray(x), jnp.asarray(y))
    got = tmlp.device_grad({k: T(v) for k, v in jp.items()}, T(x), T(y).long())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the reader CLI
# ---------------------------------------------------------------------------


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """Two recorded runs of the port's engine (barrier and streamed AE) and
    one of the reference's, each with an eval event."""
    root = tmp_path_factory.mktemp("runs")
    dirs = {}
    for name, stream in (("barrier", None), ("stream", dict(batch_clients=4, deadline=1e9))):
        rec = tobs.JsonlRecorder(str(root / name), config={"stream": stream})
        port_engine("fedqcs-ae", chan_kw=dict(kind="awgn"), stream=stream, obs=rec).run(2)
        rec.record("eval", {"round": 1, "accuracy": 0.5})
        rec.close()
        dirs[name] = str(root / name)
    rec = jobs.JsonlRecorder(str(root / "reference"))
    engines("fedqcs-ea", obs=(rec, None))[0].run(2)
    rec.close()
    dirs["reference"] = str(root / "reference")
    return dirs


@pytest.mark.parametrize("argv", [
    ["summarize", "barrier"], ["summarize", "stream"], ["summarize", "reference"],
    ["compare", "barrier", "stream"], ["compare", "reference", "barrier"],
    ["tail", "stream", "-n", "3"], ["validate", "reference"], ["validate", "stream"],
], ids=lambda a: "-".join(a))
def test_reader_cli_prints_the_references_text(run_dirs, argv):
    argv = [run_dirs.get(a, a) for a in argv]
    rc_t, out_t = _cli(treader.main, argv)
    rc_j, out_j = _cli(jreader.main, argv)
    assert (rc_t, out_t) == (rc_j, out_j) and rc_t == 0
    if argv[0] == "summarize":
        assert "rnd" in out_t and "phase wall-clock" in out_t and "decode health" in out_t
