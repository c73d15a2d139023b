"""Port parity, the round's remaining knobs, against the JAX reference on
the CPU: the package names and the legacy quantizer surface, the
partitioners, the schedulers, SGD and int8 Adam, FedAvg/FedAvgM, the AE
decode in G groups, the chunked client pass, the per-client loop oracle,
``python -m repro_torch.fed`` and carrying optimizer state across.

Contracts, each with its reason:

  * partitions, schedulers, ``staleness_discount``, the legacy quantizer's
    tables and ``encode``/``decode``/``quantize``: bit-identical (numpy
    copies of the reference; the same fp32 searchsorted and gather);
  * a legacy ``LloydMaxQuantizer`` at the port's entry points: the same
    bits as its ``Codebook``;
  * ``QLeaf`` round trips and SGD / Adam updates with fp32 or int8 states
    over several steps: bit-identical (the reference's order of operations;
    ``torch.round`` and ``jnp.round`` both round half to even), except the
    Adam parameters, within 1 ulp of the step (the reference folds its
    ``mhat / (sqrt(vhat) + eps)`` in another order of f32 roundings);
    FedAvg / FedAvgM: bit-identical;
  * ``impl="loop"`` against ``impl="vmap"`` and ``chunk`` against one pass,
    in the port: bit-identical params, residuals and stats, as the
    reference's own ``tests/test_fed.py`` holds its engine (at its toy
    size; at the MLP's width the CPU BLAS rounds a GEMM row differently
    with the row count, see PERF.md);
  * engine rounds against the reference (the reference's draws injected,
    ``torch_fed_parity``): stats to 1e-5 relative, the decoded aggregate
    to NMSE 1e-4 (the GAMP contract), scheduler state equal;
  * ``aggregate_and_estimate`` in G groups, an all-dropped group included:
    NMSE 1e-4 against the reference.
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.fed as jfed  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.fed as tfed  # noqa: E402
from repro.core import codebook as jcb  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import quantizer as jq  # noqa: E402
from repro.core import reconstruction as jrec  # noqa: E402
from repro.fed import partition as jpart  # noqa: E402
from repro.fed import scheduler as jsched  # noqa: E402
from repro.fed import server_opt as jsrv  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import bussgang as tbuss  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import gamp as tgamp  # noqa: E402
from repro_torch.core import quantizer as tq  # noqa: E402
from repro_torch.core import reconstruction as trec  # noqa: E402
from repro_torch.core.recon_engine import ReconSpec  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.fed import partition as tpart  # noqa: E402
from repro_torch.fed import scheduler as tsched  # noqa: E402
from repro_torch.fed import server_opt as tsrv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from torch_fed_parity import engines, nmse, port_engine, reference_round  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# every name of repro.fed is ported
UNPORTED_FED = set()


def T(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# package names and the legacy quantizer surface
# ---------------------------------------------------------------------------


def test_core_exports_the_reference_names():
    names = ("BQCSCodec", "CompressorState", "FedQCSConfig", "compress", "init_state",
             "make_codec", "reconstruct")
    for name in names:
        assert hasattr(jcore, name)
        assert getattr(tcore, name) is getattr(tapi, name)


def test_fed_exports_the_reference_names():
    assert set(tfed.__all__) == set(jfed.__all__) - UNPORTED_FED
    for name in tfed.__all__:
        assert getattr(tfed, name) is not None
    assert tfed.CohortEngine is teng.CohortEngine


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_as_codebook_matches_reference(bits):
    jc = jcb.as_codebook(jq.design_lloyd_max(bits))
    tc = tcb.as_codebook(tq.design_lloyd_max(bits))
    for field in ("family", "bits", "dim", "n_levels", "gamma", "psi"):
        assert getattr(tc, field) == getattr(jc, field), field
    assert np.array_equal(tc.levels, jc.levels) and np.array_equal(tc.thresholds, jc.thresholds)
    assert tc.dither is None and jc.dither is None
    assert tcb.as_codebook(tc) is tc
    with pytest.raises(TypeError, match="not a codebook"):
        tcb.as_codebook(object())


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_legacy_quantizer_functions_match_reference(bits):
    jqz, tqz = jq.design_lloyd_max(bits), tq.design_lloyd_max(bits)
    assert tqz.distortion == jqz.distortion and tqz.kappa == jqz.kappa
    rng = np.random.default_rng(bits)
    # Gaussian draws plus every threshold exactly (the side="left" tie rule)
    x = np.concatenate([rng.normal(size=4000), jqz.thresholds]).astype(np.float32)
    codes_j = np.asarray(jq.encode(jnp.asarray(x), jqz))
    codes_t = tq.encode(T(x), tqz)
    assert codes_t.dtype == torch.uint8 and np.array_equal(codes_t.numpy(), codes_j)
    assert np.array_equal(tq.decode(codes_t, tqz).numpy(),
                          np.asarray(jq.decode(jnp.asarray(codes_j), jqz)))
    assert np.array_equal(tq.quantize(T(x), tqz).numpy(),
                          np.asarray(jq.quantize(jnp.asarray(x), jqz)))


def _legacy_inputs():
    cfg = tcomp.FedQCSConfig(block_size=96, reduction_ratio=3, bits=3, s_ratio=0.2,
                             gamp_iters=5, gamp_variance_mode="scalar")
    codec = tcomp.BQCSCodec(cfg, device="cpu")
    rng = np.random.default_rng(0)
    g = T(rng.normal(0, 0.05, (8, 96)).astype(np.float32))
    words, alpha, _ = codec.compress_blocks_packed(g, torch.zeros_like(g))
    return codec, g, words, alpha


ENTRY_POINTS = {
    "bussgang_weight": lambda c, g, w, al, q: tbuss.bussgang_weight(
        torch.full((2, 1), 0.5), al.reshape(2, 4), q),
    "aggregate_codes": lambda c, g, w, al, q: tbuss.aggregate_codes(
        c.unpack(w).reshape(2, 4, -1), al.reshape(2, 4), torch.full((2,), 0.5), q, c.cfg.m),
    "aggregate_packed": lambda c, g, w, al, q: tbuss.aggregate_packed(
        w.reshape(2, 4, -1), al.reshape(2, 4), torch.full((2,), 0.5), q, c.cfg.m),
    "effective_noise_var": lambda c, g, w, al, q: tbuss.effective_noise_var(
        al.reshape(2, 4), torch.full((2,), 0.5), q),
    "qem_gamp": lambda c, g, w, al, q: tgamp.qem_gamp(
        c.unpack(w), al, c.a, q, tgamp.GampConfig(iters=5, variance_mode="scalar")),
    "qem_gamp_xla": lambda c, g, w, al, q: tgamp.qem_gamp(
        c.unpack(w), al, c.a, q, tgamp.GampConfig(iters=5), use_kernels=False),
    "qem_gamp_packed": lambda c, g, w, al, q: tgamp.qem_gamp_packed(
        w, al, c.a, q, tgamp.GampConfig(iters=5, variance_mode="scalar"), c.cfg.m),
    "qiht_reconstruct": lambda c, g, w, al, q: tbase.qiht_reconstruct(
        c.unpack(w), al, c.a, q, c.cfg.s, iters=5),
    "bqcs_encode_fused": lambda c, g, w, al, q: tops.bqcs_encode_fused(
        g, torch.zeros_like(g), c.a, q, c.cfg.s),
    "bqcs_encode": lambda c, g, w, al, q: tops.bqcs_encode(g, c.a, q),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_take_a_legacy_quantizer(entry):
    """The reference's entry points adapt a LloydMaxQuantizer through
    ``as_codebook``; the port's give it the bits of its Codebook."""
    codec, g, words, alpha = _legacy_inputs()
    fn = ENTRY_POINTS[entry]
    want = fn(codec, g, words, alpha, codec.codebook)
    got = fn(codec, g, words, alpha, tq.design_lloyd_max(codec.cfg.bits))
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# partitions, schedulers, staleness
# ---------------------------------------------------------------------------

PARTITIONS = [
    ("iid", {}, 0), ("iid", {}, 3),
    ("shard", dict(shards_per_client=1), 0), ("shard", dict(shards_per_client=2), 5),
    ("dirichlet", dict(alpha=0.05, min_size=4), 0), ("dirichlet", dict(alpha=0.1), 1),
    ("dirichlet", dict(alpha=0.3, min_size=4), 2), ("dirichlet", dict(alpha=10.0), 3),
    ("paper", dict(per_client=20), 0),
]


@pytest.mark.parametrize("kind,kw,seed", PARTITIONS)
def test_partition_matches_reference(kind, kw, seed):
    labels = np.random.default_rng(seed).integers(0, 10, 700).astype(np.int32)
    clients = 13
    parts_j = jpart.partition_indices(labels, clients,
                                      jpart.PartitionConfig(kind=kind, seed=seed, **kw))
    parts_t = tpart.partition_indices(labels, clients,
                                      tpart.PartitionConfig(kind=kind, seed=seed, **kw))
    assert len(parts_t) == clients
    for pt, pj in zip(parts_t, parts_j):
        assert pt.dtype == pj.dtype and np.array_equal(pt, pj)
    stats = tpart.partition_stats(parts_t, labels)
    assert np.array_equal(stats, jpart.partition_stats(parts_j, labels))
    if kind == "dirichlet":
        assert min(len(p) for p in parts_t) >= kw.get("min_size", 1)


def test_partition_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown partition kind"):
        tpart.partition_indices(np.arange(4), 2, tpart.PartitionConfig(kind="zipf"))


@pytest.mark.parametrize("kind,frac,dropout", [
    ("full", 1.0, 0.0), ("full", 1.0, 0.3), ("uniform", 0.3, 0.0), ("uniform", 0.5, 0.25),
    ("async", 0.4, 0.0), ("async", 0.6, 0.3),
])
def test_scheduler_matches_reference(kind, frac, dropout):
    counts = np.random.default_rng(7).integers(1, 50, 20)
    kw = dict(kind=kind, sample_frac=frac, dropout_prob=dropout, staleness_decay=0.7, seed=3)
    sj, st = jsched.SchedulerState.init(20), tsched.SchedulerState.init(20)
    for t in range(8):
        ids_j, rho_j, sj = jsched.select_cohort(jsched.SchedulerConfig(**kw), sj, t, counts)
        ids_t, rho_t, st = tsched.select_cohort(tsched.SchedulerConfig(**kw), st, t, counts)
        assert np.array_equal(ids_t, ids_j) and rho_t.dtype == rho_j.dtype
        assert np.array_equal(rho_t, rho_j)
        assert np.array_equal(st.last_round, sj.last_round)


def test_staleness_discount_matches_reference():
    s = np.array([-3, 0, 1, 2, 7, 100])
    for decay in (0.0, 0.5, 2.0):
        assert np.array_equal(tsched.staleness_discount(s, decay),
                              jsched.staleness_discount(s, decay))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _moments(shape, seed, positive):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(-8.0, 3.0, shape) if positive else rng.normal(0, 1e-3, shape)
    x = x.astype(np.float32).reshape(-1)
    x[: min(256, x.size)] = 0.0  # an all-zero block
    return x.reshape(shape)


@pytest.mark.parametrize("sqrt_domain", [False, True])
@pytest.mark.parametrize("shape", [(7,), (300, 7), (2, 256)])
def test_qleaf_round_trip_matches_reference(shape, sqrt_domain):
    x = _moments(shape, 1, sqrt_domain)
    qj = jadam._quantize_leaf(jnp.asarray(x), sqrt_domain)
    qt = tadam._quantize_leaf(T(x), sqrt_domain)
    assert qt.q.dtype == torch.int8 and qt.q.shape == shape
    assert np.array_equal(qt.q.numpy(), np.asarray(qj.q))
    assert np.array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    dj = np.asarray(jadam._dequantize_leaf(qj, sqrt_domain))
    assert np.array_equal(tadam._dequantize_leaf(qt, sqrt_domain).numpy(), dj)
    if sqrt_domain:  # the half-LSB floor: a live block never decodes to 0
        live = np.repeat(np.asarray(qj.scale) > 0, 256)[: x.size].reshape(shape)
        assert (dj[live] > 0).all()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 0.1, (40, 13)).astype(np.float32),
            "b": rng.normal(0, 0.1, (13,)).astype(np.float32)}


def _leaves(state):
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    if isinstance(state, tuple):  # a QLeaf
        return [np.asarray(v) for v in state]
    return [np.asarray(state)]


@pytest.mark.parametrize("kind,state_dtype,wd", [
    ("adam", "float32", 0.0), ("adam", "int8", 0.0), ("adam", "int8", 0.01),
    ("sgd", "float32", 0.0), ("sgd", "int8", 0.0), ("sgd", "float32", 0.01),
])
def test_optimizer_updates_match_reference(kind, state_dtype, wd):
    """Without gradient clipping: states bit-identical, SGD parameters
    bit-identical, Adam parameters within 1 ulp."""
    kw = dict(kind=kind, state_dtype=state_dtype, weight_decay=wd, lr=1e-2, warmup_steps=2,
              decay_steps=6, grad_clip=0.0)
    for pt, pj, st, sj in _optimizer_steps(kw):
        for a, b in zip(_leaves(st), _leaves(sj)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for k in pt:
            got, want = pt[k].numpy(), np.asarray(pj[k])
            if kind == "sgd":
                assert np.array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(np.abs(want)).max())


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_clipped_optimizer_updates_match_reference(kind):
    """With the global-norm clip: the norm is a sum over every gradient
    entry, which the two libraries reduce in another order, so the clip
    factor and everything after it agree to a few ulps (rtol 1e-6)."""
    kw = dict(kind=kind, lr=1e-2, warmup_steps=2, decay_steps=6, grad_clip=1.0)
    for pt, pj, st, sj in _optimizer_steps(kw):
        for a, b in zip(_leaves(st) + [pt[k].numpy() for k in sorted(pt)],
                        _leaves(sj) + [np.asarray(pj[k]) for k in sorted(pj)]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


def _optimizer_steps(kw, steps=5):
    """Yields (port params, reference params, port state, reference state)
    after each of ``steps`` updates from the same parameters and gradients
    (growing, so the clip engages)."""
    cj, ct = jadam.OptConfig(**kw), tadam.OptConfig(**kw)
    p = _tree(0)
    pj, pt = {k: jnp.asarray(v) for k, v in p.items()}, {k: T(v) for k, v in p.items()}
    sj, st = jadam.init_state(cj, pj), tadam.init_state(ct, pt)
    for step in range(steps):
        g = {k: v * (1.0 + 3 * step) for k, v in _tree(10 + step).items()}
        pj, sj = jadam.update(cj, {k: jnp.asarray(v) for k, v in g.items()}, sj, pj, step)
        pt, st = tadam.update(ct, {k: T(v) for k, v in g.items()}, st, pt, step)
        yield pt, pj, st, sj


@pytest.mark.parametrize("kind", ["fedavg", "fedavgm", "fedadam"])
def test_server_optimizers_match_reference(kind):
    kw = dict(kind=kind, lr=0.05, momentum=0.8)
    cj, ct = jsrv.ServerOptConfig(**kw), tsrv.ServerOptConfig(**kw)
    p = _tree(1)
    pj, pt = {k: jnp.asarray(v) for k, v in p.items()}, {k: T(v) for k, v in p.items()}
    sj, st = jsrv.init_server_state(cj, pj), tsrv.init_server_state(ct, pt)
    for step in range(4):
        g = _tree(20 + step)
        pj, sj = jsrv.server_update(cj, {k: jnp.asarray(v) for k, v in g.items()}, sj, pj, step)
        pt, st = tsrv.server_update(ct, {k: T(v) for k, v in g.items()}, st, pt, step)
        for a, b in zip(_leaves(st), _leaves(sj)):
            assert np.array_equal(a, b)
        for k in p:
            want = np.asarray(pj[k])
            if kind == "fedadam":
                np.testing.assert_allclose(pt[k].numpy(), want, rtol=0,
                                           atol=np.spacing(np.abs(want)).max())
            else:
                assert np.array_equal(pt[k].numpy(), want)


def test_unknown_optimizers_raise():
    with pytest.raises(ValueError, match="unknown server optimizer"):
        tsrv.init_server_state(tsrv.ServerOptConfig(kind="fedprox"), {})
    with pytest.raises(ValueError, match="unknown optimizer"):
        tadam.init_state(tadam.OptConfig(state_dtype="int4"), {})


@pytest.mark.parametrize("which", ["fedadam", "fedavgm", "adam-int8", "sgd-int8"])
def test_state_from_reference_continues_the_run(which):
    """Two reference steps, then the port goes on from the reference's
    state and parameters: its third step is the reference's."""
    if which in ("fedadam", "fedavgm"):
        cj, ct = jsrv.ServerOptConfig(kind=which), tsrv.ServerOptConfig(kind=which)
        init_j, upd_j, upd_t = jsrv.init_server_state, jsrv.server_update, tsrv.server_update
    else:
        kind = which.split("-")[0]
        kw = dict(kind=kind, state_dtype="int8", warmup_steps=1, grad_clip=0.0)
        cj, ct = jadam.OptConfig(**kw), tadam.OptConfig(**kw)
        init_j, upd_j, upd_t = jadam.init_state, jadam.update, tadam.update
    pj = {k: jnp.asarray(v) for k, v in _tree(2).items()}
    sj = init_j(cj, pj)
    for step in range(2):
        pj, sj = upd_j(cj, {k: jnp.asarray(v) for k, v in _tree(30 + step).items()}, sj, pj,
                       step)
    st = state_from_reference(jax.tree_util.tree_map(np.asarray, sj))
    pt = {k: T(v) for k, v in pj.items()}
    g = _tree(40)
    pj, sj = upd_j(cj, {k: jnp.asarray(v) for k, v in g.items()}, sj, pj, 2)
    pt, st = upd_t(ct, {k: T(v) for k, v in g.items()}, st, pt, 2)
    for a, b in zip(_leaves(st), _leaves(sj)):
        assert np.array_equal(a, b)
    for k in pt:
        want = np.asarray(pj[k])
        np.testing.assert_allclose(pt[k].numpy(), want, rtol=0,
                                   atol=np.spacing(np.abs(want)).max())


# ---------------------------------------------------------------------------
# the AE decode in G groups
# ---------------------------------------------------------------------------


def _group_payload(use_kernels, k=6, nb=3, seed=0):
    cfg = dict(block_size=64, reduction_ratio=2, bits=3, s_ratio=0.2, gamp_iters=10,
               gamp_variance_mode="scalar", use_kernels=use_kernels)
    jc = jcomp.BQCSCodec(jcomp.FedQCSConfig(**cfg))
    tc = tcomp.BQCSCodec(tcomp.FedQCSConfig(**cfg), device="cpu", a=T(jc.a))
    g = T(np.random.default_rng(seed).normal(0, 0.05, (k * nb, 64)).astype(np.float32))
    codes, alpha, _ = tc.compress_blocks(g, torch.zeros_like(g))
    return jc, tc, codes.reshape(k, nb, -1).numpy(), alpha.reshape(k, nb).numpy()


@pytest.mark.parametrize("groups,use_kernels", [(2, False), (3, False), (3, True)])
def test_aggregate_and_estimate_in_groups_matches_reference(groups, use_kernels):
    """Clients 0 and 1 carry rho = 0, so at G = 3 the first group is all
    dropped: zero observation, noise and energy rows, decoded as the
    reference decodes them."""
    jc, tc, codes, alpha = _group_payload(use_kernels)
    rhos = np.array([0.0, 0.0, 0.3, 0.2, 0.25, 0.25], np.float32)
    gj, info_j = jrec.aggregate_and_estimate(jc, jnp.asarray(codes), jnp.asarray(alpha),
                                             jnp.asarray(rhos), groups=groups, with_info=True)
    gt, info_t = trec.aggregate_and_estimate(tc, T(codes), T(alpha), T(rhos), groups=groups,
                                             with_info=True)
    assert gt.shape == (3, 64) and bool(torch.isfinite(gt).all())
    assert nmse(gt.numpy(), gj) <= 1e-4
    assert info_t.iters.shape == (groups * 3,) == np.asarray(info_j.iters).shape
    assert np.array_equal(info_t.converged.numpy(), np.asarray(info_j.converged))


def test_aggregate_and_estimate_indivisible_groups_raise():
    _, tc, codes, alpha = _group_payload(False)
    with pytest.raises(ValueError, match="not divisible"):
        trec.aggregate_and_estimate(tc, T(codes), T(alpha), torch.full((6,), 1 / 6), groups=4)


def test_api_reconstruct_in_groups_is_the_grouped_decode():
    """``ReconSpec(groups=G)`` reaches ``aggregate_and_estimate`` (held
    against the reference above) with the payloads' codes."""
    cfg = tcomp.FedQCSConfig(block_size=128, reduction_ratio=4, bits=2, s_ratio=0.1,
                             gamp_iters=15)
    codec = tapi.make_codec(cfg, device="cpu")
    rng = np.random.default_rng(3)
    pays, codes, alphas = [], [], []
    for _ in range(4):
        g = {"w": T(rng.standard_t(4, (20, 30)).astype(np.float32) * 0.01)}
        pay, spec, _ = tapi.compress(codec, g, tapi.init_state(codec, g))
        pays.append(pay)
        codes.append(codec.unpack(pay.codes))
        alphas.append(pay.alpha)
    rhos = torch.tensor([0.4, 0.1, 0.3, 0.2])
    got = tapi.reconstruct(codec, pays, rhos, spec, recon=ReconSpec(mode="ae", groups=2))
    want = trec.aggregate_and_estimate(codec, torch.stack(codes), torch.stack(alphas), rhos,
                                       groups=2)
    assert torch.equal(got["w"], tcomp.blocks_to_tree(want, spec)["w"])


# ---------------------------------------------------------------------------
# engine rounds: loop oracle, chunked pass, schedulers, groups, servers
# ---------------------------------------------------------------------------

AWGN_PARTIAL = dict(sched_kw=dict(kind="uniform", sample_frac=0.75, dropout_prob=0.25),
                    chan_kw=dict(kind="awgn", snr_db=10.0))


def _same_run(a, b, rounds):
    for _ in range(rounds):
        assert a.run_round() == b.run_round()
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert torch.equal(a.residuals, b.residuals)
    assert np.array_equal(a.sched_state.last_round, b.sched_state.last_round)


@pytest.mark.parametrize("method,kw", [
    ("fedqcs-ae", AWGN_PARTIAL), ("fedqcs-ea", {}), ("qcs-qiht", {}), ("qcs-dither", {}),
    ("signsgd", {}), ("none", {}),
])
def test_loop_oracle_matches_vmap_bitexact(method, kw):
    """As the reference's ``test_engine_vmap_matches_loop_bitexact`` and
    ``test_engine_methods_run_and_match_loop``: the per-client loop and the
    batched encode give the same bits (they share the gradient pass, and
    every encoder stage is per block row)."""
    vmap = port_engine(method, cohort_kw=dict(impl="vmap"), **kw)
    loop = port_engine(method, cohort_kw=dict(impl="loop"), **kw)
    _same_run(vmap, loop, 2 if method == "fedqcs-ae" else 1)


@pytest.mark.parametrize("chunk", [1, 4, 5])
def test_chunked_client_pass_matches_one_pass_bitexact(chunk):
    """As the reference's ``test_engine_chunked_scan_matches_single_pass``:
    chunking the client pass changes memory, not values."""
    _same_run(port_engine("fedqcs-ae", cohort_kw=dict(chunk=chunk)),
              port_engine("fedqcs-ae", cohort_kw=dict(chunk=0)), 2)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        port_engine("fedqcs-ae", cohort_kw=dict(impl="scan"))


def _rounds_match(je, te, rounds):
    """``rounds`` rounds in both engines: stats to 1e-5 relative, the decoded
    aggregate to NMSE 1e-4, the scheduler state equal.  Returns the port's
    stats per round."""
    out = []
    for _ in range(rounds):
        stats_j, ghat_j = reference_round(je)
        stats_t = te.run_round()
        assert set(stats_t) == set(stats_j)
        for k, v in stats_j.items():
            assert abs(stats_t[k] - float(v)) <= 1e-5 * abs(float(v)) + 1e-9, (k, stats_t[k], v)
        assert nmse(te.last_ghat.numpy(), ghat_j) <= 1e-4
        assert np.array_equal(te.sched_state.last_round, je.sched_state.last_round)
        out.append(stats_t)
    for k, v in je.params.items():
        np.testing.assert_allclose(te.params[k].numpy(), np.asarray(v), rtol=0, atol=1e-5)
    return out


def test_loop_and_chunked_round_matches_reference():
    """The loop oracle over a chunked gradient pass, in both packages, with
    partial participation, dropout and a noisy uplink: the reference's
    rounds, to the engine-round contract."""
    je, te = engines("fedqcs-ae", cohort_kw=dict(impl="loop", chunk=4), **AWGN_PARTIAL)
    _rounds_match(je, te, 2)


@pytest.mark.parametrize("sched_kw,chan_kw", [
    (dict(kind="uniform", sample_frac=0.5), {}),
    (dict(kind="uniform", sample_frac=0.75, dropout_prob=0.25), dict(kind="awgn", snr_db=10.0)),
    (dict(kind="async", sample_frac=0.5, staleness_decay=0.5), {}),
    # outages every few rounds: the un-stamp feeds the next staleness discount
    (dict(kind="async", sample_frac=0.75, staleness_decay=1.0),
     dict(kind="rayleigh", snr_db=10.0, outage_gain=0.5)),
], ids=["uniform", "uniform-dropout-awgn", "async", "async-rayleigh-outage"])
def test_scheduled_rounds_match_reference(sched_kw, chan_kw):
    je, te = engines("fedqcs-ae", sched_kw=sched_kw, chan_kw=chan_kw)
    stats = _rounds_match(je, te, 3)
    assert all(s["cohort"] < 6 for s in stats)
    if chan_kw.get("kind") == "rayleigh":
        assert any(s["participating"] < s["cohort"] for s in stats)


def _all_dropped_group_seed(groups, clients=6, dropout=0.5):
    """The first seed whose full-cohort dropout drops a whole group of
    consecutive clients in round 0 but not every client."""
    per = clients // groups
    for seed in range(100):
        _, rho, _ = tsched.select_cohort(tsched.SchedulerConfig(dropout_prob=dropout, seed=seed),
                                         tsched.SchedulerState.init(clients), 0,
                                         np.ones(clients))
        dead = (rho == 0).reshape(groups, per).all(axis=1)
        if dead.any() and rho.any():
            return seed
    raise AssertionError("no seed drops a whole group")


@pytest.mark.parametrize("groups,kernels,dropped", [
    (2, False, False), (3, True, False), (3, True, True), (2, True, True),
], ids=["G2-default", "G3-kernel-route", "G3-all-dropped-group", "G2-all-dropped-group"])
def test_ae_groups_round_matches_reference(groups, kernels, dropped):
    """fedqcs-ae with ``cohort.groups``: the plain route, and the kernel
    route (on the CPU, the plain step of ``gamp_step`` at G * nb rows), with
    a group whose members all dropped out of round 0."""
    fed_kw = dict(use_kernels=True, gamp_variance_mode="scalar") if kernels else {}
    kw = dict(fed_kw=fed_kw, cohort_kw=dict(groups=groups))
    if dropped:
        kw.update(dropout=0.5, seed=_all_dropped_group_seed(groups))
    je, te = engines("fedqcs-ae", **kw)
    stats = _rounds_match(je, te, 2)
    if dropped:
        assert 0 < stats[0]["participating"] < stats[0]["cohort"]


@pytest.mark.parametrize("method,chan_kw", [("fedqcs-ea", {}), ("fedqcs-ae",
                                                                 dict(kind="awgn"))])
def test_groups_gating_raises_like_the_reference(method, chan_kw):
    with pytest.raises(ValueError, match="groups != 1"):
        port_engine(method, chan_kw=chan_kw, cohort_kw=dict(groups=2))


@pytest.mark.parametrize("server", ["fedavg", "fedavgm"])
def test_server_rounds_match_reference(server):
    je, te = engines("fedqcs-ae", server_kw=dict(kind=server, lr=0.5),
                     sched_kw=dict(kind="uniform", sample_frac=0.5))
    _rounds_match(je, te, 3)
    for a, b in zip(_leaves(te.server_state), _leaves(je.server_state)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# python -m repro_torch.fed
# ---------------------------------------------------------------------------


def test_fed_smoke_runs_two_rounds_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        teng._smoke_main(["--device", "cpu", "--sample-frac", "0.5", "--chunk", "3"])
    text = out.getvalue()
    assert "round 1" in text and "smoke ok: 8 clients, 2 rounds" in text


# Explicit ids keep each case's name from before the per-tensor layouts
# (item 9), the streaming PS (item 7) and the telemetry (item 8) were
# ported: those flags now run their round (``ported``) instead of raising.
@pytest.mark.parametrize("flags,item", [
    pytest.param(["--layout", "per_tensor", "--record", "RUN"], "ported", id="flags0-item 9"),
    pytest.param(["--layout", "per_tensor", "--encode-stream", "--grad-accum", "2",
                  "--method", "fedqcs-ea", "--record", "RUN"], "ported", id="flags1-item 9"),
    pytest.param(["--stream", "4"], "ported", id="flags2-item 7"),
    pytest.param(["--record", "RUN"], "ported", id="flags3-item 8"),
])
def test_fed_smoke_unported_flags_raise(flags, item, tmp_path):
    argv = ["--device", "cpu", "--rounds", "1"] + [
        str(tmp_path / "run") if f == "RUN" else f for f in flags]
    if item != "ported":
        with pytest.raises(NotImplementedError, match=item):
            teng._smoke_main(argv)
        return
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        teng._smoke_main(argv)
    text = out.getvalue()
    assert "round 0" in text and "smoke ok: 8 clients, 1 rounds" in text
    if "--stream" in flags:
        assert "'batches_admitted': 2.0" in text  # 8 clients in batches of 4
    else:
        from repro.obs.reader import load_rounds, validate_dir

        assert validate_dir(str(tmp_path / "run")) == []
        [event] = load_rounds(str(tmp_path / "run"))
        if "--layout" in flags:  # the toy's b (4,) and w (32, 4): 1 and 2 rows
            assert [s["name"] for s in event["wire_segments"]] == ["['b']", "['w']"]
            assert ("backward" in event["phase_ms"]) == ("--encode-stream" in flags)


def test_run_federated_passes_the_knobs(monkeypatch):
    """``run_federated``'s scenario arguments reach the engine's configs as
    the reference's ``run_federated`` passes them."""
    from repro_torch.paper import mlp as tmlp

    seen = {}
    init = teng.CohortEngine.__init__

    def capture(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen["engine"] = self

    monkeypatch.setattr(teng.CohortEngine, "__init__", capture)
    res = tmlp.run_federated(
        "fedqcs-ae", steps=1, k_devices=12, device="cpu", partition="dirichlet", alpha=0.5,
        scheduler="async", sample_frac=0.5, dropout=0.2, server="fedavgm", chunk=4,
        impl="loop", groups=2, seed=1,
        fed_cfg=tcomp.FedQCSConfig(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=5,
                                   use_kernels=True, gamp_variance_mode="scalar"))
    eng = seen["engine"]
    c = eng.cohort
    assert (c.method, c.chunk, c.groups, c.impl) == ("fedqcs-ae", 4, 2, "loop")
    assert (eng.sched.kind, eng.sched.sample_frac, eng.sched.dropout_prob, eng.sched.seed) == (
        "async", 0.5, 0.2, 1)
    assert eng.server.kind == "fedavgm" and set(eng.server_state) == {"m"}
    assert eng.clients == 12 and len(res.nmses) == 1 and np.isfinite(res.nmses[0])
