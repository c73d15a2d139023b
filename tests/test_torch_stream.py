"""The streaming PS of the port (``core/aggregator.py``, ``fed/stream.py``,
``decode_from_stats`` and the engine's ``stream=`` rounds) against the
reference's, at the reference tests' toy size (``tests/test_stream.py``:
N = 64, R = 2, Q = 3, 13 clients of 3 blocks; the engine rounds on the
shared 6-client softmax regression of ``tests/torch_fed_parity.py``).

Tolerances, each with its reason:
  * partial statistics: 1e-6 relative (the same f32 sums in another order);
    the tree's tiers and live bytes equal (host bookkeeping).
  * arrivals and batches: bit-identical (the same numpy streams).
  * ``stream_decode`` against the reference's on the same payloads: NMSE
    <= 1e-6 (two GAMP implementations, 10 iterations, f32).
  * streamed against barrier inside the port: the reference's pinned
    contract, NMSE <= 1e-8 and atol 1e-5 (only the order of the client sums
    differs).
  * engine rounds against the reference's: stats to 1e-5 relative, the
    decoded aggregate to NMSE 1e-4 and the parameters to atol 1e-5 after 2
    rounds (``tests/test_torch_knobs.py``'s round contract); a blackout
    round bit-exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregator as jagg  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core.recon_engine import decode_from_stats as j_decode_from_stats  # noqa: E402
from repro.fed import stream as jstream  # noqa: E402
from repro_torch.core import aggregator as tagg  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core.recon_engine import decode_from_stats  # noqa: E402
from repro_torch.core.reconstruction import (  # noqa: E402
    aggregate_and_estimate,
    estimate_and_aggregate_packed,
    gamp_config_from,
)
from repro_torch.fed import stream as tstream  # noqa: E402
from repro_torch.fed.stream import (  # noqa: E402
    BoundedIngestBuffer,
    StreamConfig,
    batch_arrivals,
    stream_decode,
)
from torch_fed_parity import engines, nmse, port_engine, reference_round  # noqa: E402

FED = dict(block_size=64, reduction_ratio=2, bits=3, s_ratio=0.2, gamp_iters=10,
           gamp_variance_mode="scalar")
NMSE_TOL = 1e-8  # the reference's pinned streamed-vs-barrier contract
ATOL = 1e-5


def T(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def payload():
    """One 13-client cohort's wire payloads (the reference's encoder, A and
    codebook), its codes and raw weights (one weight zero: a dropped
    client riding in the cohort arrays), and both codecs."""
    jc = jcomp.BQCSCodec(jcomp.FedQCSConfig(**FED))
    tc = tcomp.BQCSCodec(tcomp.FedQCSConfig(**FED), a=T(jc.a), device="cpu")
    rng = np.random.default_rng(0)
    blocks = jnp.asarray(rng.normal(size=(13, 3, 64)).astype(np.float32))
    words, alphas, _ = jax.vmap(jc.compress_blocks_packed)(blocks, jnp.zeros_like(blocks))
    w = np.abs(rng.normal(size=13)).astype(np.float32)
    w[3] = 0.0
    return dict(jc=jc, tc=tc, jw=words, ja=alphas, words=T(words), alphas=T(alphas),
                codes=tc.unpack(T(words)), w=w)


def _scfg(**kw):
    return StreamConfig(**dict(dict(batch_clients=4, buffer_batches=2, fanout=2), **kw))


def _batches(c, size=4):
    return batch_arrivals(np.arange(c, dtype=float) * 0.1, 1e9, size)


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# partial statistics and the tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noisy", [False, True])
def test_ae_batch_stats_match_reference(payload, noisy):
    p = payload
    kw_j, kw_t = {}, {}
    if noisy:
        rng = np.random.default_rng(1)
        nu = rng.uniform(0.01, 0.1, (13, 3)).astype(np.float32)
        noise = rng.normal(size=(13, 3, p["tc"].cfg.m)).astype(np.float32)
        kw_j = dict(nu_chan=jnp.asarray(nu), noise=jnp.asarray(noise))
        kw_t = dict(nu_chan=T(nu), noise=T(noise))
    want = jagg.ae_batch_stats(p["jc"], p["jw"], p["ja"], jnp.asarray(p["w"]), **kw_j)
    got = tagg.ae_batch_stats(p["tc"], p["words"], p["alphas"], T(p["w"]), **kw_t)
    for name in ("y", "nu", "energy", "wsum", "count"):
        _close(getattr(got, name), getattr(want, name))
    assert got.nbytes == want.nbytes and float(got.count) == 12.0


def test_ea_and_mimo_batch_stats_match_reference(payload):
    rng = np.random.default_rng(2)
    ghat = rng.normal(size=(5, 2, 16)).astype(np.float32)
    w = np.asarray([0.5, 1.5, 0.0, 2.0, 1.0], np.float32)
    want = jagg.ea_batch_stats(jnp.asarray(ghat), jnp.asarray(w))
    got = tagg.ea_batch_stats(T(ghat), T(w))
    for name in ("y", "nu", "energy", "wsum", "count"):
        _close(getattr(got, name), getattr(want, name))
    p = payload
    y_eff = rng.normal(size=(3, p["tc"].cfg.m)).astype(np.float32)
    nu = rng.uniform(0.0, 0.1, 3).astype(np.float32)
    want = jagg.mimo_batch_stats(p["jc"], jnp.asarray(y_eff), jnp.asarray(nu), p["ja"],
                                 jnp.asarray(p["w"]))
    got = tagg.mimo_batch_stats(p["tc"], T(y_eff), T(nu), p["alphas"], T(p["w"]))
    for name in ("y", "nu", "energy", "wsum", "count"):
        _close(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("fanout,pushes", [(2, 5), (4, 37), (8, 3)])
def test_aggregator_tree_matches_reference(fanout, pushes):
    """The same push sequence gives the reference's root (and the plain
    left-to-right fold), tier count and peak live bytes."""
    rng = np.random.default_rng(fanout)
    jtree = jagg.AggregatorTree(jagg.zero_stats("ea", 2, 8), fanout=fanout)
    ttree = tagg.AggregatorTree(tagg.zero_stats("ea", 2, 8), fanout=fanout)
    linear = tagg.zero_stats("ea", 2, 8)
    for _ in range(pushes):
        y, wsum = rng.normal(size=(2, 8)).astype(np.float32), np.float32(rng.random())
        z = np.zeros(2, np.float32)
        jtree.push(jagg.PartialStats("ea", jnp.asarray(y), jnp.asarray(z), jnp.asarray(z),
                                     jnp.asarray(wsum), jnp.ones((), jnp.float32)))
        s = tagg.PartialStats("ea", T(y), T(z), T(z), T(wsum), torch.ones(()))
        ttree.push(s)
        linear = tagg.stats_add(linear, s)
    _close(ttree.root().y, jtree.root().y)
    _close(ttree.root().y, linear.y.numpy(), rtol=1e-5)
    assert len(ttree.tiers) == len(jtree.tiers) and ttree.pushed == pushes
    assert ttree.peak_live_bytes == jtree.peak_live_bytes


def test_stats_mode_mismatch_raises():
    with pytest.raises(ValueError, match="fold"):
        tagg.stats_add(tagg.zero_stats("ae", 1, 8), tagg.zero_stats("ea", 1, 8))
    with pytest.raises(ValueError, match="mode"):
        tagg.zero_stats("nope", 1, 8)
    with pytest.raises(ValueError, match="fanout"):
        tagg.AggregatorTree(tagg.zero_stats("ae", 1, 8), fanout=1)


# ---------------------------------------------------------------------------
# arrivals, batches, the ingest buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_kw,round_idx", [
    (dict(seed=5, straggler_prob=0.3, straggler_mult=100.0), 3),
    (dict(seed=0), 0),
    (dict(seed=7, latency_sigma=1.2, soft_deadline=1.0, late_decay=0.7, deadline=3.0), 11),
])
def test_arrivals_and_batches_bit_identical(cfg_kw, round_idx):
    alive = np.array([True] * 20 + [False] * 3 + [True] * 7)
    t_times = tstream.simulate_arrivals(StreamConfig(**cfg_kw), round_idx, 30, alive)
    j_times = jstream.simulate_arrivals(jstream.StreamConfig(**cfg_kw), round_idx, 30, alive)
    np.testing.assert_array_equal(t_times, j_times)
    assert np.all(np.isinf(t_times[20:23]))
    np.testing.assert_array_equal(tstream.late_discount(StreamConfig(**cfg_kw), t_times),
                                  jstream.late_discount(jstream.StreamConfig(**cfg_kw), j_times))
    deadline = cfg_kw.get("deadline", 8.0)
    for size in (1, 4, 8):
        tb = batch_arrivals(t_times, deadline, size)
        jb = jstream.batch_arrivals(j_times, deadline, size)
        assert [b.tolist() for b in tb] == [b.tolist() for b in jb]


def test_bounded_buffer_contract():
    buf = BoundedIngestBuffer(2)
    assert buf.push(b"a", 1) and buf.push(b"b", 2)
    assert buf.full and len(buf) == 2
    assert not buf.push(b"a", 1)  # duplicate: rejected, does NOT occupy a slot
    assert buf.rejected_dup == 1 and len(buf) == 2
    with pytest.raises(RuntimeError, match="full"):
        buf.push(b"c", 3)
    assert buf.pop() == 1  # FIFO
    assert buf.push(b"c", 3)
    assert not buf.push(b"b", 2)  # dedup persists across drains
    assert buf.peak_occupancy == 2
    with pytest.raises(ValueError, match="capacity"):
        BoundedIngestBuffer(0)


# ---------------------------------------------------------------------------
# stream_decode and decode_from_stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ae", "ea"])
def test_stream_decode_matches_reference(payload, mode):
    p = payload
    kw = dict(batch_clients=4, buffer_batches=2, fanout=2)
    want, info_j = jstream.stream_decode(p["jc"], p["jw"], p["ja"], p["w"], _batches(13),
                                         mode=mode, stream=jstream.StreamConfig(**kw))
    got, info = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], _batches(13),
                              mode=mode, stream=StreamConfig(**kw))
    assert nmse(got.numpy(), want) <= 1e-6
    assert set(info) == set(info_j)
    for k, v in info_j.items():
        assert abs(info[k] - float(v)) <= 1e-6 * abs(float(v)), (k, info[k], v)


@pytest.mark.parametrize("mode", ["ae", "ea"])
def test_stream_decode_matches_barrier(payload, mode):
    """The pinned contract inside the port: a streamed round decodes the
    barrier aggregate up to the order of the client sums."""
    p = payload
    tc, w = p["tc"], p["w"]
    rhos = T(w / w.sum())
    if mode == "ae":
        bar = aggregate_and_estimate(tc, p["codes"], p["alphas"], rhos, gamp=gamp_config_from(tc))
    else:
        bar = estimate_and_aggregate_packed(tc, p["words"], p["alphas"], rhos)
    got, info = stream_decode(tc, p["words"], p["alphas"], w, _batches(13), mode=mode,
                              stream=_scfg())
    assert nmse(got.numpy(), bar.numpy()) <= NMSE_TOL
    np.testing.assert_allclose(got.numpy(), bar.numpy(), atol=ATOL)
    assert info["participating"] == 12.0 and info["batches_admitted"] == 4


def test_stream_reorder_within_contract(payload):
    p = payload
    batches = _batches(13)
    ref, _ = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], batches, stream=_scfg())
    for perm in ([3, 1, 0, 2], [1, 3, 2, 0]):
        got, _ = stream_decode(p["tc"], p["words"], p["alphas"], p["w"],
                               [batches[i] for i in perm], stream=_scfg())
        assert nmse(got.numpy(), ref.numpy()) <= NMSE_TOL


def test_stream_duplicate_batch_rejected_not_double_counted(payload):
    p = payload
    batches = _batches(13)
    ref, info0 = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], batches,
                               stream=_scfg())
    got, info = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], batches[:1] + batches,
                              stream=_scfg())
    assert info["batches_rejected_dup"] == 1
    assert info["batches_admitted"] == info0["batches_admitted"]
    assert torch.equal(got, ref)


def test_stream_dropped_batch_degrades_to_nonparticipation(payload):
    p = payload
    batches = _batches(13)
    w_eff = p["w"].copy()
    w_eff[batches[2]] = 0.0
    rhos = T(w_eff / w_eff.sum())
    bar = aggregate_and_estimate(p["tc"], p["codes"], p["alphas"], rhos,
                                 gamp=gamp_config_from(p["tc"]))
    got, info = stream_decode(p["tc"], p["words"], p["alphas"], p["w"],
                              batches[:2] + batches[3:], stream=_scfg())
    assert nmse(got.numpy(), bar.numpy()) <= NMSE_TOL
    assert info["participating"] == float(np.sum(w_eff > 0))


def test_stream_empty_round_is_exact_zero_update(payload):
    p = payload
    g, info = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], [], stream=_scfg())
    assert not g.any() and g.shape == (3, 64)
    assert info["participating"] == 0.0 and info["batches_admitted"] == 0


def test_stream_backpressure_bounds_buffer(payload):
    p = payload
    batches = _batches(13, 2)
    ref, _ = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], batches,
                           stream=_scfg(batch_clients=2))
    got, info = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], batches,
                              stream=_scfg(batch_clients=2, buffer_batches=1))
    assert info["buffer_peak_occupancy"] == 1
    assert info["batches_backpressure"] == len(batches) - 1
    assert info["batches_admitted"] == len(batches)
    assert nmse(got.numpy(), ref.numpy()) <= NMSE_TOL


def test_noisy_stream_is_batching_invariant(payload):
    """Per-client noise makes the channel draw independent of how arrivals
    batch up: 4-client batches and one 13-client batch fold the same noisy
    observation (up to the order of the sums)."""
    p = payload
    nu_chan = torch.full(tuple(p["alphas"].shape), 0.05)
    noise = torch.randn((13, 3, p["tc"].cfg.m), generator=torch.Generator().manual_seed(9))
    a, _ = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], _batches(13, 4),
                         stream=_scfg(), nu_chan=nu_chan, noise=noise)
    b, _ = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], _batches(13, 13),
                         stream=_scfg(batch_clients=13, buffer_batches=1),
                         nu_chan=nu_chan, noise=noise)
    assert nmse(a.numpy(), b.numpy()) <= NMSE_TOL


@pytest.mark.parametrize("mode", ["ae", "ea"])
def test_stream_health_counters_leave_the_aggregate(payload, mode):
    """collect_health=True returns the reference's health keys without
    changing the decoded aggregate."""
    p = payload
    ref, _ = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], _batches(13), mode=mode,
                           stream=_scfg())
    ps = tstream.StreamingPS(p["tc"], mode=mode, stream=_scfg(), collect_health=True)
    got, info = stream_decode(p["tc"], p["words"], p["alphas"], p["w"], _batches(13),
                              mode=mode, ps=ps)
    assert torch.equal(got, ref)
    assert 0.0 < info["gamp_iters_mean"] <= FED["gamp_iters"]
    assert info["gamp_iters_max"] <= FED["gamp_iters"]
    assert 0.0 <= info["gamp_converged_frac"] <= 1.0


@pytest.mark.parametrize("mode", ["ae", "ea"])
def test_decode_from_stats_matches_reference(payload, mode):
    p = payload
    if mode == "ae":
        js = jagg.ae_batch_stats(p["jc"], p["jw"], p["ja"], jnp.asarray(p["w"]))
        ts = tagg.ae_batch_stats(p["tc"], p["words"], p["alphas"], T(p["w"]))
    else:
        ghat = np.random.default_rng(3).normal(size=(13, 3, 64)).astype(np.float32)
        js = jagg.ea_batch_stats(jnp.asarray(ghat), jnp.asarray(p["w"]))
        ts = tagg.ea_batch_stats(T(ghat), T(p["w"]))
    want = j_decode_from_stats(p["jc"], js)
    got = decode_from_stats(p["tc"], ts)
    assert nmse(got.numpy(), want) <= (1e-6 if mode == "ae" else 1e-12)


def test_streaming_ps_gating_raises(payload):
    from repro_torch.fed.channel import ChannelConfig

    with pytest.raises(ValueError, match="mode"):
        tstream.StreamingPS(payload["tc"], mode="nope")
    with pytest.raises(ValueError, match="multiple-access"):
        tstream.StreamingPS(payload["tc"], chan=ChannelConfig(kind="awgn"))
    with pytest.raises(ValueError, match="only joint-estimation"):
        tstream.StreamingPS(payload["tc"], mode="ea", chan=ChannelConfig(kind="mimo_mac"))
    with pytest.raises(ValueError, match="exceeds"):
        stream_decode(payload["tc"], payload["words"], payload["alphas"], payload["w"],
                      _batches(13, 5), stream=_scfg())


# ---------------------------------------------------------------------------
# the engine's streamed rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,chan_kw,stream", [
    ("fedqcs-ae", {}, dict(batch_clients=4, deadline=1e9, fanout=2)),
    ("fedqcs-ea", {}, dict(batch_clients=4, deadline=1e9)),
    ("fedqcs-ae", dict(kind="awgn", snr_db=10.0), dict(batch_clients=4, deadline=1e9)),
    ("fedqcs-ae", dict(kind="mimo_mac", n_rx=8), dict(batch_clients=4, deadline=1e9)),
    # stragglers past the deadline and late arrivals discounted
    ("fedqcs-ae", {}, dict(batch_clients=2, deadline=1.2, late_decay=0.5, soft_deadline=0.9,
                           seed=3)),
], ids=["ae", "ea", "ae-awgn", "ae-mimo_mac", "ae-deadline"])
def test_engine_streamed_rounds_match_reference(method, chan_kw, stream):
    """Two streamed rounds in both engines, the reference's A and draws in
    the port's: stats, decoded aggregate, scheduler stamps, parameters."""
    je, te = engines(method, chan_kw=chan_kw, stream=stream, fed_kw=dict(
        gamp_variance_mode="scalar"))
    for _ in range(2):
        stats_j, ghat_j = reference_round(je)
        stats_t = te.run_round()
        assert set(stats_t) == set(stats_j), (sorted(stats_t), sorted(stats_j))
        for k, v in stats_j.items():
            assert abs(stats_t[k] - float(v)) <= 1e-5 * abs(float(v)) + 1e-9, (k, stats_t[k], v)
        assert nmse(te.last_ghat.numpy(), ghat_j) <= 1e-4
        assert np.array_equal(te.sched_state.last_round, je.sched_state.last_round)
    for k, v in je.params.items():
        np.testing.assert_allclose(te.params[k].numpy(), np.asarray(v), rtol=0, atol=ATOL)
    np.testing.assert_allclose(te.residuals.numpy(), np.asarray(je.residuals), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("method", ["fedqcs-ae", "fedqcs-ea"])
def test_engine_streaming_matches_barrier_round(method):
    """With a deadline no client misses, the streamed and the barrier round
    drive the same trajectory (the pinned contract)."""
    cfg = dict(gamp_variance_mode="scalar")
    barrier = port_engine(method, fed_kw=cfg)
    streamed = port_engine(method, fed_kw=cfg,
                           stream=dict(batch_clients=4, deadline=1e9, fanout=2))
    for _ in range(2):
        sb, ss = barrier.run_round(), streamed.run_round()
        assert ss["participating"] == sb["participating"] == 6.0
        assert nmse(streamed.last_ghat.numpy(), barrier.last_ghat.numpy()) <= NMSE_TOL
    for k, v in barrier.params.items():
        np.testing.assert_allclose(streamed.params[k].numpy(), v.numpy(), atol=ATOL)
    np.testing.assert_allclose(streamed.residuals.numpy(), barrier.residuals.numpy(),
                               atol=ATOL)


def test_engine_streaming_blackout_round_is_exact():
    """Nobody beats the deadline: the round is an exact zero update, every
    residual carries the FULL gradient bit for bit, nobody is stamped -- in
    the port and in the reference alike."""
    stream = dict(batch_clients=4, deadline=8.0, straggler_prob=1.0, straggler_mult=1e12)
    je, te = engines("fedqcs-ae", stream=stream, sched_kw=dict(kind="async", sample_frac=1.0))
    params0 = {k: v.clone() for k, v in te.params.items()}
    blocks = te._grad_blocks(te.data.cohort_batch(0, np.arange(te.clients)))
    stats_j, _ = reference_round(je)
    stats = te.run_round()
    assert stats["participating"] == stats_j["participating"] == 0.0
    assert stats["arrived"] == stats_j["arrived"] == 0.0
    for k, v in params0.items():
        assert torch.equal(te.params[k], v)
        assert np.array_equal(te.params[k].numpy(), np.asarray(je.params[k]))
    assert torch.equal(te.residuals, blocks)
    assert not te.last_ghat.any()
    np.testing.assert_array_equal(te.sched_state.last_round, -1)
    np.testing.assert_array_equal(je.sched_state.last_round, -1)


def test_engine_streaming_gating_raises():
    with pytest.raises(ValueError, match="streaming"):
        port_engine("signsgd", stream=dict())
    with pytest.raises(ValueError, match="groups"):
        port_engine("fedqcs-ae", stream=dict(), cohort_kw=dict(groups=2))
