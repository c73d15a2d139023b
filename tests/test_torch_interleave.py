"""Port parity: the backward-interleaved segment producer
(``repro_torch.models.segment_tap``, ``fed/engine.py::make_interleaved_segments``,
the launcher's ``--fed-cohort --interleave``) on the CPU.

Every staged family of the reference's own interleave tests
(``tests/test_interleave.py``'s ``STAGED_ARCHS``) runs its smoke config
(fp32) over C = 2 clients of 2 x 16 tokens drawn from a numpy seed, with
the reference's parameters carried across (``convert.from_reference``)
and the reference's producer run once a pytest run
(``torch_shared.shared``).

Contracts:
  * ``interleaved_layout``: the reference's segments field for field (names,
    leaf ids, sizes, offsets, rows, row starts, pads), layer_chunks 1 and 2
    (the hybrid: 1);
  * the producer's ``stage_names``, the order in which it yields segment
    indices and ``peak_live_grad_bytes(C)`` equal the reference's exactly;
    each yielded (C, rows, N) block within rtol 1e-4 / atol 1e-6 of the
    reference producer's (the gradient tolerance of
    ``tests/test_torch_families.py``; where the reference's own fp32 block
    is farther than that from its float64 gradient -- three of Zamba2's
    blocks and one of DeepSeek-V3's on this batch -- the port's is held to
    the float64 gradient instead, as there);
  * ``grads_fn`` against the engine's default per-client gradient tree
    (``_grads_tree``), allclose at rtol 2e-4 / atol 5e-5 (the reference's
    own pin between its staged and monolithic gradients);
  * the wire through the port's engine: the producer's and a shuffled
    re-emission of it bit-identical to the one-pass encode of the
    producer's own ``grads_fn`` tree (payload and residuals), over
    ``WIRE_ARCHS`` x grad_accum {1, 4};
  * the reference's error contracts, each boundary carry released after
    its stage's backward, the ``backward``/``encode_overlap`` spans of a
    recorded round, and the launcher's ``--fed-cohort --interleave``.
"""

import dataclasses
import random
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.fed import engine as jeng  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import segment_tap as jtap  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core.compression import FedQCSConfig as TCfg  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import segment_tap as ttap  # noqa: E402
from repro_torch.obs import InMemoryRecorder  # noqa: E402
from repro_torch.obs.trace import SUB_PHASES  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from torch_shared import shared, one_torch_thread  # noqa: E402,F401

C, B, S, SV = 2, 2, 16, 4  # clients, samples a client, tokens, VLM patches
N = 64  # the reference's interleave tests' block size
FED = dict(block_size=N, reduction_ratio=2, bits=3, gamp_iters=4)
STAGED_ARCHS = ["qwen3-0.6b", "deepseek-v3-671b", "mamba2-1.3b", "zamba2-2.7b", "qwen2-vl-7b"]
WIRE_ARCHS = ["qwen3-0.6b", "mamba2-1.3b", "zamba2-2.7b"]
BLOCK_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_torch_families.py's gradient pin
TREE_TOL = dict(rtol=2e-4, atol=5e-5)  # the reference's staged-vs-monolithic pin


def _chunks(arch, layer_chunks=2):
    return 1 if jreg.smoke_config(arch).family == "hybrid" else layer_chunks


def _np_batch(cfg, b=B, seed=3):
    """The (C, ...) cohort batch from a numpy seed: token ids and labels
    (the VLM: S - SV text positions after SV patch embeddings, with its
    (3, b, S) positions)."""
    rng = np.random.default_rng(seed)
    st = S - SV if cfg.family == "vlm" else S
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (C, b, st)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (C, b, st)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (rng.normal(size=(C, b, SV, cfg.d_model)) * 0.02).astype(np.float32)
        batch["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32), (C, 3, b, S)).copy()
    return batch


def _t_batch(batch):
    return {k: torch.tensor(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _ref_run(arch):
    """The reference producer's run at layer_chunks 2 (the hybrid: 1):
    parameters, batch, the (index, blocks) stream, stage names and bound."""
    cfg = jreg.smoke_config(arch)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: jmodel.init_params(cfg, k))(jax.random.PRNGKey(0)))
    chunks = _chunks(arch)
    layout = jtap.interleaved_layout(cfg, N, layer_chunks=chunks)
    prod = jeng.make_interleaved_segments(cfg, layout, layer_chunks=chunks)
    batch = _np_batch(cfg)
    return {"params": params, "batch": batch,
            "segments": [(int(i), np.asarray(b)) for i, b in prod(params, batch, layout)],
            "stages": prod.stage_names, "peak": prod.peak_live_grad_bytes(C)}


def _blocks64(arch, params, batch, layout):
    """The reference's float64 gradient (each client's, the parameters and
    patches cast up) cut into ``layout``'s segments: {index: (C, rows, N)}."""
    cfg = jreg.smoke_config(arch)
    up = lambda v: v.astype(np.float64) if v.dtype == np.float32 else v  # noqa: E731
    jax.config.update("jax_enable_x64", True)
    try:
        grads = jax.jit(jax.vmap(jax.grad(lambda p, b: jmodel.train_loss(p, b, cfg)),
                                 in_axes=(None, 0)))(
            jax.tree_util.tree_map(up, params), {k: up(v) for k, v in batch.items()})
        leaves = [np.asarray(v, np.float64).reshape(C, -1)
                  for v in jax.tree_util.tree_leaves(grads)]
    finally:
        jax.config.update("jax_enable_x64", False)
    out = {}
    for seg in layout.segments:
        flat = np.concatenate([leaves[lid][:, off:off + size] for lid, size, off
                               in zip(seg.leaf_ids, seg.sizes, seg.leaf_offsets)], axis=1)
        out[seg.index] = np.pad(flat, ((0, 0), (0, seg.pad))).reshape(C, seg.rows, N)
    return out


def _setup(arch, grad_accum=1, layer_chunks=2):
    cfg = registry.smoke_config(arch)
    chunks = _chunks(arch, layer_chunks)
    layout = ttap.interleaved_layout(cfg, N, layer_chunks=chunks)
    prod = teng.make_interleaved_segments(cfg, layout, grad_accum=grad_accum,
                                          layer_chunks=chunks)
    return cfg, layout, prod


def _port_params(tmp_path_factory, arch):
    ref = shared(tmp_path_factory, f"interleave_ref_{arch}", lambda: _ref_run(arch))
    return ref, from_reference(ref["params"])[0]


class _FakeData:
    """Engine-constructible data source: every round's cohort batch is
    ``batch``."""

    def __init__(self, batch=None):
        self.counts = np.ones(C, np.int64)
        self.batch = batch

    def cohort_batch(self, round_idx, ids):
        return {k: v[torch.as_tensor(ids)] for k, v in self.batch.items()}


def _engine(cfg, params, layout, hook, grad_accum=1, obs=None, data=None):
    return teng.CohortEngine(
        params, lambda p, b: steps.value_and_grad(p, b, cfg)[1], data or _FakeData(),
        fed_cfg=TCfg(**FED),
        cohort=teng.CohortConfig(method="fedqcs-ae", encode_stream=True, record_nmse=False,
                                 grad_accum=grad_accum, seed=3),
        layout=layout, grad_segments_fn=hook, obs=obs, device="cpu")


def _one_pass_hook(prod):
    """The one-pass oracle: the producer's own gradient tree, then every
    segment sliced out of it in layout order."""

    def hook(params, batch, layout):
        tree = prod.grads_fn(params, batch)
        for seg in layout.segments:
            yield seg.index, layout.segment_blocks_batched(tree, seg.index)

    return hook


def _shuffled_hook(prod):
    """The producer's segments re-emitted in a fixed shuffled order (the
    streamed pass takes any order)."""

    def hook(params, batch, layout):
        out = list(prod(params, batch, layout))
        random.Random(7).shuffle(out)
        yield from out

    return hook


def _segment_tuple(layout):
    return (layout.nbar, layout.rows, [
        (s.index, s.name, s.leaf_ids, s.sizes, s.size, s.rows, s.row_start, s.pad, s.s,
         s.offsets) for s in layout.segments])


# ---------------------------------------------------------------------------
# geometry and the producer against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", STAGED_ARCHS)
def test_interleaved_layout_matches_reference(arch):
    for chunks in sorted({1, _chunks(arch)}):
        got = ttap.interleaved_layout(registry.smoke_config(arch), N, layer_chunks=chunks)
        want = jtap.interleaved_layout(jreg.smoke_config(arch), N, layer_chunks=chunks)
        assert got.kind == want.kind == "per_tensor"
        assert _segment_tuple(got) == _segment_tuple(want), (arch, chunks)
        assert [tuple(s) for s, _ in got.shapes] == [tuple(s) for s, _ in want.shapes]


@pytest.mark.parametrize("arch", STAGED_ARCHS)
def test_producer_matches_reference(arch, tmp_path_factory):
    """Stage names, the yield order and the live-bytes bound exactly; each
    block at BLOCK_TOL (the float64 anchor where the reference's own block
    is off it)."""
    ref, params = _port_params(tmp_path_factory, arch)
    cfg, layout, prod = _setup(arch)
    assert prod.stage_names == ref["stages"]
    assert prod.peak_live_grad_bytes(C) == ref["peak"]
    got = [(i, b) for i, b in prod(params, _t_batch(ref["batch"]), layout)]
    assert [i for i, _ in got] == [i for i, _ in ref["segments"]]
    assert sorted(i for i, _ in got) == list(range(len(layout.segments)))
    exact = None
    for (i, g), (_, w) in zip(got, ref["segments"]):
        seg = layout.segments[i]
        assert g.dtype == torch.float32 and tuple(g.shape) == (C, seg.rows, N) == w.shape
        g = g.numpy()
        if np.allclose(g, w, **BLOCK_TOL):
            continue
        if exact is None:
            exact = shared(tmp_path_factory, f"interleave_ref64_{arch}",
                           lambda: _blocks64(arch, ref["params"], ref["batch"], layout))
        e = exact[i]
        past = lambda x: float(np.max(np.abs(x - e) - BLOCK_TOL["rtol"] * np.abs(e)))  # noqa: E731
        assert past(g) <= max(BLOCK_TOL["atol"], 2 * past(w)), (
            f"{seg.name}: {past(g):.3g} past rtol from the float64 gradient, the reference "
            f"{past(w):.3g}")


@pytest.mark.parametrize("arch,grad_accum", [(a, 1) for a in STAGED_ARCHS]
                         + [("qwen3-0.6b", 4)])
def test_grads_fn_matches_engine_tree(arch, grad_accum, tmp_path_factory):
    """``grads_fn`` against the engine's default per-client gradient tree
    (the one-pass ``_grads_tree``; grad_accum 4: 4 microbatches of one
    sample a client), at TREE_TOL; the tree keeps the parameters'
    structure and dtypes."""
    ref, params = _port_params(tmp_path_factory, arch)
    cfg, layout, prod = _setup(arch, grad_accum=grad_accum)
    batch = _t_batch(_np_batch(registry.smoke_config(arch), b=4 if grad_accum > 1 else B))
    want = _engine(cfg, params, layout, prod, grad_accum=grad_accum)._grads_tree(batch)
    got = prod.grads_fn(params, batch)
    items, ref_items = tree_util.leaves(got), tree_util.leaves(want)
    assert [p for p, _ in items] == [p for p, _ in ref_items]
    for (path, g), (_, w) in zip(items, ref_items):
        assert g.dtype == w.dtype == tree_util.get(params, path).dtype, path
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TREE_TOL, err_msg=str(path))


# ---------------------------------------------------------------------------
# wire bit-identity through the port's engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", WIRE_ARCHS)
@pytest.mark.parametrize("grad_accum", [1, 4])
def test_wire_bit_identity(arch, grad_accum, tmp_path_factory):
    """The producer's payload and residuals, and those of its segments
    re-emitted shuffled, bit for bit those of the one-pass encode of its
    own ``grads_fn`` tree, from the same nonzero residuals."""
    _, params = _port_params(tmp_path_factory, arch)
    cfg, layout, prod = _setup(arch, grad_accum=grad_accum)
    batch = _t_batch(_np_batch(cfg, b=4 if grad_accum > 1 else B))
    eng = _engine(cfg, params, layout, _one_pass_hook(prod), grad_accum=grad_accum)
    res0 = torch.randn((C, eng.nb, eng.n), generator=torch.Generator().manual_seed(1)) * 1e-3
    rhos = torch.ones(C)
    pay_ref, _, res_ref = eng._client_pass_streamed(batch, res0.clone(), rhos, rhos)
    for hook in (prod, _shuffled_hook(prod)):
        eng._grad_segments_fn = hook
        pay, _, res = eng._client_pass_streamed(batch, res0.clone(), rhos, rhos)
        assert set(pay) == set(pay_ref) == {"words", "alpha"}
        for k in pay:
            assert torch.equal(pay[k], pay_ref[k]), k
        assert torch.equal(res, res_ref)


# ---------------------------------------------------------------------------
# the reference's error contracts
# ---------------------------------------------------------------------------


def test_producer_rejects_foreign_layout(tmp_path_factory):
    _, params = _port_params(tmp_path_factory, "qwen3-0.6b")
    cfg, layout, prod = _setup("qwen3-0.6b")
    other = ttap.interleaved_layout(cfg, N, layer_chunks=1)
    with pytest.raises(ValueError, match="layout differs"):
        next(prod(params, _t_batch(_np_batch(cfg)), other))
    with pytest.raises(ValueError, match="does not describe"):
        teng.make_interleaved_segments(registry.smoke_config("mamba2-1.3b"), layout)


@pytest.mark.parametrize("make,err,match", [
    pytest.param(lambda: teng.make_interleaved_segments(
        registry.smoke_config("qwen2-vl-7b"),
        ttap.interleaved_layout(registry.smoke_config("qwen2-vl-7b"), N), grad_accum=2),
        ValueError, "VLM", id="vlm-grad-accum"),
    pytest.param(lambda: ttap.build_stages(
        registry.smoke_config("zamba2-2.7b"),
        ttap._abstract_params(registry.smoke_config("zamba2-2.7b")), layer_chunks=2),
        ValueError, "weight-shared", id="hybrid-chunks"),
    pytest.param(lambda: ttap.InterleavedSegments(
        registry.smoke_config("whisper-base"),
        ttap.interleaved_layout(registry.smoke_config("whisper-base"), N)),
        NotImplementedError, "audio", id="audio"),
    pytest.param(lambda: teng.make_interleaved_segments(*_setup("qwen3-0.6b")[:2], grad_accum=0),
                 ValueError, "grad_accum must be >= 1", id="grad-accum-0"),
])
def test_producer_rejects(make, err, match):
    with pytest.raises(err, match=match):
        make()


def test_plan_errors():
    """The fold plan's checks: a leaf no stage produces, a stage span that
    leaves part of a slot uncovered, a stage naming a leaf the tree does
    not have."""
    _, _, prod = _setup("qwen3-0.6b")
    stages = list(prod.stages)
    head = stages[-1]
    short = dataclasses.replace(head, ranges=tuple(
        (nm, lo, hi - (1 if nm == "['final_norm']" else 0)) for nm, lo, hi in head.ranges))
    bogus = dataclasses.replace(head, ranges=head.ranges + (("['nope']", 0, 1),))
    for repl, match in ((stages[:-1], "produced by no stage"),
                        (stages[:-1] + [short], "stages cover"),
                        (stages[:-1] + [bogus], "unknown leaf")):
        prod.stages = repl
        with pytest.raises(ValueError, match=match):
            prod._build_plan()
    prod.stages = stages
    prod._build_plan()


def test_boundary_carries_released_after_their_stage(tmp_path_factory):
    """Each carry the forward sweep keeps (the input of stage k) is dead by
    the time stage k-1's backward starts: the counterpart of the
    reference's donated boundary carries."""
    _, params = _port_params(tmp_path_factory, "qwen3-0.6b")
    cfg, layout, prod = _setup("qwen3-0.6b")
    refs, dead_at = {}, {}

    def tapped(k, fwd):
        def run(sp, x, ctx):
            out = fwd(sp, x, ctx)
            if not torch.is_grad_enabled():  # the forward sweep: out enters stage k + 1
                refs.setdefault(k + 1, []).append(weakref.ref(out))
            elif k + 1 in refs:  # stage k's backward starts: stage k + 1's is done
                dead_at.setdefault(k + 1, all(r() is None for r in refs[k + 1]))
            return out
        return run

    prod.stages = [dataclasses.replace(st, fwd=tapped(k, st.fwd))
                   for k, st in enumerate(prod.stages)]
    seen = [i for i, _ in prod(params, _t_batch(_np_batch(cfg)), layout)]
    assert sorted(seen) == list(range(len(layout.segments)))
    ns = len(prod.stages)
    assert sorted(refs) == list(range(1, ns)) and all(len(v) == C for v in refs.values())
    assert dead_at == {k: True for k in range(1, ns)}


# ---------------------------------------------------------------------------
# telemetry and the launcher
# ---------------------------------------------------------------------------


def test_interleave_spans_recorded(tmp_path_factory):
    """A recorded interleaved round: ``backward`` and ``encode_overlap``
    land in its ``phase_ms`` and stay out of ``round_ms``."""
    _, params = _port_params(tmp_path_factory, "qwen3-0.6b")
    cfg, layout, prod = _setup("qwen3-0.6b")
    data = _FakeData(_t_batch(_np_batch(cfg)))
    eng = _engine(cfg, params, layout, prod, obs=InMemoryRecorder(), data=data)
    eng.run_round()
    rounds = [e for e in eng.obs.events if e["kind"] == "round"]
    phase = rounds[-1]["phase_ms"]
    assert phase["backward"] > 0 and phase["encode_overlap"] > 0 and "client_pass" in phase
    expect = sum(v for k, v in phase.items() if k not in SUB_PHASES)
    assert abs(rounds[-1]["round_ms"] - expect) < 1e-6


def test_launcher_fed_cohort_interleave(capsys):
    """``--fed-cohort --interleave 2 --device cpu``: the engine streams the
    encode through the producer over its own layout, prints the
    reference's interleave line (its numbers from the reference's layout
    and producer) and runs a round."""
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--fed-cohort", "--interleave", "2",
            "--clients", "4", "--seq", "16", "--steps", "1", "--device", "cpu"]
    engine = tlaunch.main(argv)
    out = capsys.readouterr().out
    jcfg = jreg.smoke_config("qwen3-0.6b")
    jl = jtap.interleaved_layout(jcfg, 255, layer_chunks=2)
    jp = jeng.make_interleaved_segments(jcfg, jl, layer_chunks=2)
    line = (f"[fed-cohort] interleave: {len(jl.segments)} segments, stages {jp.stage_names}, "
            f"peak live grad+enc {jp.peak_live_grad_bytes(4) / 1e6:.1f} MB "
            f"(whole tree {4 * jl.nbar * 4 / 1e6:.1f} MB)")
    assert line in out.splitlines() and "[fed-cohort] done" in out
    prod = engine._grad_segments_fn
    assert isinstance(prod, ttap.InterleavedSegments) and prod.layout is engine.layout
    assert engine.cohort.encode_stream and engine.round == 1
    assert all(bool(torch.isfinite(p).all()) for _, p in tree_util.leaves(engine.params))
