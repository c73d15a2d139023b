"""Port parity: per-tensor gradient layouts, the segment-streamed encode and
the segment-local EA decode (``repro_torch.core.layout``, the layout
paths of ``core/compression.py``, ``core/recon_engine.py``, ``core/api.py``
and ``fed/engine.py``) against ``repro``'s, on the CPU.

Contracts (``tests/test_layout.py``'s, held across the two packages):

  * geometry: every segment field (name, leaf ids, sizes, rows, row_start,
    pad, s, offsets) and every derived number equal, per-tensor layouts
    with groups, budgets, splits and row multiples included;
  * blocks and roundtrips: bit-identical to the reference's blocks, exact
    roundtrips;
  * the int32 guard, ``owner_map``, ``encoder_live_bytes``, ``as_layout``;
  * the streamed encode's wire bit-identical to the one-pass encode of the
    same layout (both encode routes), and to the reference's;
  * ``ea_decode_segments`` within NMSE 1e-4 of the whole-grid decode and of
    the reference's; ``reconstruct(emit=)``;
  * engine rounds with ``encode_stream``, ``grad_accum``, explicit layouts
    with budgets and the ``grad_segments_fn`` hook, against the one-pass
    round and against the reference's round (``tests/torch_fed_parity.py``,
    the reference's draws injected).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_fed_parity as fp  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import recon_engine as jre  # noqa: E402
from repro.core.layout import GradientLayout as JLayout  # noqa: E402
from repro.obs import InMemoryRecorder as JRec  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import recon_engine as tre  # noqa: E402
from repro_torch.core.layout import INT32_MAX, as_layout  # noqa: E402
from repro_torch.core.layout import GradientLayout as TLayout  # noqa: E402
from repro_torch.core.reconstruction import gamp_config_from  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.obs import InMemoryRecorder as TRec  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CFG = dict(block_size=64, reduction_ratio=2, bits=3, gamp_iters=8)
MLP = {"w1": (784, 20), "b1": (20,), "w2": (20, 10), "b2": (10,)}


def T(x):
    return torch.tensor(np.asarray(x))


def _tree(sizes, seed=0):
    """The reference tests' uneven-leaf dict: 1-D and 2-D float32 leaves."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, s in enumerate(sizes):
        shape = (s,) if (i % 2 == 0 or s < 4) else (s // 2, 2) if s % 2 == 0 else (s,)
        out[f"w{i}"] = rng.normal(size=shape).astype(np.float32)
    return out


def _pair(tree_np):
    return ({k: jnp.asarray(v) for k, v in tree_np.items()},
            {k: torch.tensor(v) for k, v in tree_np.items()})


def _bias_ratio(name, shape):
    return 0.05 if name.startswith("['b") else None


def _split_w1(name, shape):
    return [3, 5] if name == "['w1']" else None


# (tree sizes or "mlp", block size, per_tensor keyword arguments)
GEOMETRY = [
    pytest.param([3, 130, 64, 7, 1000], 64, None, id="monolithic"),
    pytest.param([3, 130, 64, 7, 1000], 64, {}, id="per_tensor"),
    pytest.param([3, 130, 64, 7, 1000], 64, {"row_multiple": 3}, id="row_multiple"),
    pytest.param([1, 1, 1, 200, 33, 5], 16, {"group_scalars": 32}, id="group_scalars"),
    pytest.param([640, 64, 320], 64, {"s_ratio": lambda n, s: {"['w0']": 0.5,
                                                               "['w2']": 0.25}.get(n)},
                 id="s_ratio"),
    pytest.param([40, 16, 9], 16, {"split": _split_w1}, id="split"),
    pytest.param("mlp", 1591, {}, id="mlp"),
    pytest.param("mlp", 1591, {"group_scalars": 1591}, id="mlp-grouped"),
    pytest.param("mlp", 1591, {"s_ratio": _bias_ratio}, id="mlp-budgets"),
    pytest.param("mlp", 1591, {"split": lambda n, s: [392, 392] if n == "['w1']" else None},
                 id="mlp-split"),
]


def _layouts(sizes, n, kw):
    tree_np = ({k: np.zeros(s, np.float32) for k, s in MLP.items()} if sizes == "mlp"
               else _tree(sizes, seed=n))
    jt, tt = _pair(tree_np)
    if kw is None:
        return JLayout.monolithic(jt, n), TLayout.monolithic(tt, n), tree_np
    return JLayout.per_tensor(jt, n, **kw), TLayout.per_tensor(tt, n, **kw), tree_np


@pytest.mark.parametrize("sizes,n,kw", GEOMETRY)
def test_geometry_equals_reference(sizes, n, kw):
    jl, tl, _ = _layouts(sizes, n, kw)
    fields = ("index", "name", "leaf_ids", "sizes", "size", "rows", "row_start", "pad", "s",
              "offsets")
    assert len(tl.segments) == len(jl.segments)
    for js, ts in zip(jl.segments, tl.segments):
        assert [getattr(ts, f) for f in fields] == [getattr(js, f) for f in fields]
        assert ts.row_slice == js.row_slice and ts.leaf_offsets == js.leaf_offsets
    assert (tl.n, tl.row_multiple, tl.nbar, tl.kind, tl.rows, tl.max_segment_rows) == (
        jl.n, jl.row_multiple, jl.nbar, jl.kind, jl.rows, jl.max_segment_rows)
    assert [s for s, _ in tl.shapes] == [s for s, _ in jl.shapes]
    assert tl.segment_s(7) == jl.segment_s(7)
    assert tl.owner_map() == jl.owner_map()
    for streamed in (False, True):
        assert tl.encoder_live_bytes(streamed) == jl.encoder_live_bytes(streamed)


def test_mlp_per_tensor_numbers():
    """The paper's MLP at N = 1591: 13 rows per tensor (10 monolithic); a
    1591-scalar group is one 10-row segment (w2 rides the last group); a
    0.05 budget on the biases is s = 79."""
    tt = {k: torch.zeros(s) for k, s in MLP.items()}
    pt = TLayout.per_tensor(tt, 1591)
    assert [(s.name, s.size, s.rows, s.pad) for s in pt.segments] == [
        ("['b1']", 20, 1, 1571), ("['b2']", 10, 1, 1581), ("['w1']", 15680, 10, 230),
        ("['w2']", 200, 1, 1391)]
    assert pt.rows == 13 and TLayout.monolithic(tt, 1591).rows == 10
    grouped = TLayout.per_tensor(tt, 1591, group_scalars=1591)
    assert [(s.name, s.rows, s.pad) for s in grouped.segments] == [("['b1']+3", 10, 0)]
    assert grouped.kind == "per_tensor"
    assert TLayout.per_tensor(tt, 1591, s_ratio=_bias_ratio).segment_s(159) == [79, 79, 159, 159]


@pytest.mark.parametrize("sizes,n,kw", GEOMETRY)
def test_blocks_and_roundtrips_exact(sizes, n, kw):
    jl, tl, tree_np = _layouts(sizes, n, kw)
    jt, tt = _pair(tree_np)
    blocks = tl.to_blocks(tt)
    assert np.array_equal(blocks.numpy(), np.asarray(jl.to_blocks(jt)))
    back = tl.tree_from_blocks(blocks)
    assert list(back) == sorted(tree_np)
    for k, v in tt.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    segs = {s.index: blocks[s.row_slice] for s in tl.segments}
    assert all(torch.equal(v, tt[k]) for k, v in tl.tree_from_segments(segs).items())
    # batched views: the full grid and each segment's
    stacked = {k: torch.stack([v, 2 * v, -v]) for k, v in tt.items()}
    jstacked = {k: jnp.stack([v, 2 * v, -v]) for k, v in jt.items()}
    grid = tl.to_blocks_batched(stacked)
    assert np.array_equal(grid.numpy(), np.asarray(jl.to_blocks_batched(jstacked)))
    for s in tl.segments:
        assert torch.equal(tl.segment_blocks_batched(stacked, s.index), grid[:, s.row_slice])
        assert torch.equal(tl.segment_blocks(tt, s.index), blocks[s.row_slice])
        if s.offsets is None:
            leaves = tl.segment_leaves(s.index, blocks[s.row_slice])
            assert all(torch.equal(v, tt[tl.treedef[lid]]) for lid, v in leaves.items())
        else:
            with pytest.raises(ValueError, match="slices"):
                tl.segment_leaves(s.index, blocks[s.row_slice])
    assert [s.index for s, _ in tl.iter_segment_blocks(tt)] == list(range(len(tl.segments)))


def test_monolithic_layout_is_the_old_flatten():
    """The monolithic layout's blocks are the single-concat, single-pad
    flatten bit for bit, in sorted key order, with row_multiple padding;
    the batched flatten matches per item."""
    tree_np = _tree([67, 512, 9, 300], seed=3)
    tt = {k: torch.tensor(tree_np[k]) for k in reversed(sorted(tree_np))}
    flat = torch.cat([tt[k].reshape(-1) for k in sorted(tt)])
    for rm in (1, 4):
        rows = -(-(-(-flat.numel() // 64)) // rm) * rm
        golden = torch.nn.functional.pad(flat, (0, rows * 64 - flat.numel())).reshape(rows, 64)
        blocks, layout, nbar = tcomp.flatten_to_blocks(tt, 64, row_multiple=rm)
        assert nbar == flat.numel() and torch.equal(blocks, golden) and layout.kind == "monolithic"
    stacked = {k: torch.stack([v, -v]) for k, v in tt.items()}
    batched, blayout, _ = tcomp.flatten_to_blocks_batched(stacked, 64)
    blocks, layout, _ = tcomp.flatten_to_blocks(tt, 64)
    assert blayout == layout and torch.equal(batched[1], -blocks)


def test_split_hook_errors_and_tiling():
    tt = _pair(_tree([40, 16, 9]))[1]
    with pytest.raises(ValueError, match="partition axis 0"):
        TLayout.per_tensor(tt, 16, split=lambda n, s: [3, 3] if n == "['w1']" else None)
    tl = TLayout.per_tensor(tt, 16, split=_split_w1)
    blocks = tl.to_blocks(tt)
    with pytest.raises(ValueError, match="missing leaves"):
        tl.tree_from_segments({0: blocks[tl.segments[0].row_slice]})
    with pytest.raises(ValueError, match="do not tile"):  # one of w1's two pieces
        tl.tree_from_segments({s.index: blocks[s.row_slice] for s in tl.segments
                               if s.index != 1})


def test_int32_guard():
    """Python-int geometry; a span past int32 raises naming the per-tensor
    fix, which passes where each tensor fits; one over-int32 tensor still
    raises, segment-locally (the reference raises so with x64 off)."""
    big = INT32_MAX // 2 + 1
    keys = ("a", "b", "c")
    with pytest.raises(ValueError, match="per-tensor"):
        TLayout.from_shapes(keys[:2], [((INT32_MAX // 2, 3), torch.float32),
                                       ((1024,), torch.float32)], 1024)
    with pytest.raises(ValueError, match="int32"):
        TLayout.from_shapes(keys, [((big,), torch.float32)] * 3, 1024)
    layout = TLayout.from_shapes_per_tensor(keys, [((big,), torch.float32)] * 3, 1024)
    assert layout.nbar == 3 * big > INT32_MAX
    assert all(seg.rows * layout.n <= INT32_MAX for seg in layout.segments)
    with pytest.raises(ValueError, match="segment"):
        TLayout.from_shapes_per_tensor(keys, [((INT32_MAX + 2,), torch.float32)] * 3, 1024)
    with pytest.raises(ValueError, match="s_ratio"):
        TLayout.per_tensor({"w": torch.zeros(8)}, 64, s_ratio=lambda n, s: 1.5)
    # a nested tree (ported since): leaves in jax.tree_util order, keystr names
    nested = TLayout.per_tensor(
        {"a": {"c": torch.zeros(3), "b": torch.ones(2)}, "d": torch.ones(1)}, 64)
    assert [seg.name for seg in nested.segments] == ["['a']['b']", "['a']['c']", "['d']"]


def test_owner_map_live_bytes_and_as_layout():
    tt = _pair(_tree([100, 64, 3], seed=13))[1]
    pt = TLayout.per_tensor(tt, 64)
    spans = sorted((r0, r1) for _, r0, r1 in pt.owner_map().values())
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))
    big = _pair(_tree([4096, 64, 512, 8], seed=17))[1]
    pt, mono = TLayout.per_tensor(big, 64), TLayout.monolithic(big, 64)
    assert pt.rows >= mono.rows
    assert pt.encoder_live_bytes(streamed=True) == 3 * pt.max_segment_rows * 64 * 4
    assert pt.encoder_live_bytes(streamed=True) < pt.encoder_live_bytes(streamed=False)
    tree = _pair(_tree([33, 20], seed=19))[1]
    blocks, layout, nbar = tcomp.flatten_to_blocks(tree, 16)
    legacy = layout.spec
    rebuilt = as_layout(legacy, n=16)
    assert rebuilt == layout and as_layout(layout) is layout
    old, new = tcomp.blocks_to_tree(blocks, legacy, nbar), tcomp.blocks_to_tree(blocks, rebuilt)
    assert all(torch.equal(old[k], new[k]) and torch.equal(new[k], tree[k]) for k in tree)
    with pytest.raises(ValueError, match="block size"):
        as_layout(legacy)


# ---------------------------------------------------------------------------
# the streamed encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
def test_streamed_wire_bit_identical_to_one_pass(use_kernels):
    """compress_tree_streamed == the one-pass encode of the SAME per-tensor
    layout: words, alphas and residuals bit for bit (the kernel route runs
    the fused encoder's plain version here); and the words equal the
    reference's streamed encode from the same A."""
    jcodec = jcomp.BQCSCodec(jcomp.FedQCSConfig(**CFG))
    codec = tcomp.BQCSCodec(tcomp.FedQCSConfig(**CFG, use_kernels=use_kernels,
                                               gamp_variance_mode="scalar"), a=T(jcodec.a),
                            device="cpu")
    jt, tt = _pair(_tree([67, 512, 9, 300], seed=4))
    layout = codec.layout_for(tt, per_tensor=True)
    assert len(layout.segments) == 4
    res_np = np.random.default_rng(7).normal(size=(layout.rows, layout.n)).astype(np.float32)
    one = codec.compress_blocks_packed(layout.to_blocks(tt), T(res_np))
    payload, spec, new_res = codec.compress_tree_streamed(tt, T(res_np), layout)
    assert spec is layout and payload.nbar == layout.nbar
    for got, want in zip((payload.codes, payload.alpha, new_res), one):
        assert torch.equal(got, want)
    jpay, _, jres = jcodec.compress_tree_streamed(jt, jnp.asarray(res_np),
                                                  jcodec.layout_for(jt, per_tensor=True))
    assert np.array_equal(payload.codes.numpy(), np.asarray(jpay.codes))
    np.testing.assert_allclose(payload.alpha.numpy(), np.asarray(jpay.alpha), rtol=1e-6)
    np.testing.assert_allclose(new_res.numpy(), np.asarray(jres), rtol=0, atol=0)


def test_segment_budgets_force_the_streamed_encode():
    """Per-segment budgets take compress_tree through the segment loop: each
    segment's rows equal a one-pass encode of those rows at its own s, and
    the words equal the reference's."""
    jcodec = jcomp.BQCSCodec(jcomp.FedQCSConfig(**CFG))
    codec = tcomp.BQCSCodec(tcomp.FedQCSConfig(**CFG), a=T(jcodec.a), device="cpu")
    jt, tt = _pair(_tree([640, 64, 320], seed=11))
    ratio = lambda name, shape: {"['w0']": 0.5, "['w2']": 0.25}.get(name)  # noqa: E731
    layout = TLayout.per_tensor(tt, 64, s_ratio=ratio)
    assert [s.s for s in layout.segments] == [32, None, 16]
    residual = codec.zero_residual(tt, layout)
    payload, _, new_res = codec.compress_tree(tt, residual, layout)
    assert payload.codes.shape[0] == layout.rows and new_res.shape == (layout.rows, 64)
    blocks = layout.to_blocks(tt)
    for seg, s in zip(layout.segments, layout.segment_s(codec.cfg.s)):
        w, al, res = codec.compress_blocks_packed(blocks[seg.row_slice], residual[seg.row_slice],
                                                  s=s)
        assert torch.equal(payload.codes[seg.row_slice], w)
        assert torch.equal(new_res[seg.row_slice], res)
    jpay, _, _ = jcodec.compress_tree(jt, jnp.zeros((layout.rows, 64)),
                                      JLayout.per_tensor(jt, 64, s_ratio=ratio))
    assert np.array_equal(payload.codes.numpy(), np.asarray(jpay.codes))


# ---------------------------------------------------------------------------
# the segment-local EA decode and reconstruct(emit=)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ea_payloads():
    """Three clients' words over a per-tensor layout, encoded by the
    reference; the port's codec on the same A."""
    jcodec = jcomp.BQCSCodec(jcomp.FedQCSConfig(**CFG))
    jt, tt = _pair(_tree([130, 64, 40], seed=23))
    jl = jcodec.layout_for(jt, per_tensor=True)
    words, alphas = [], []
    for i in range(3):
        w, a, _ = jcodec.compress_blocks_packed(jl.to_blocks({k: (i + 1.0) * v
                                                              for k, v in jt.items()}),
                                                jnp.zeros((jl.rows, jl.n)))
        words.append(np.asarray(w))
        alphas.append(np.asarray(a))
    rhos = np.random.default_rng(29).dirichlet(np.ones(3)).astype(np.float32)
    codec = tcomp.BQCSCodec(tcomp.FedQCSConfig(**CFG), a=T(jcodec.a), device="cpu")
    return (jcodec, jl, codec, TLayout.per_tensor(tt, 64), np.stack(words), np.stack(alphas),
            rhos)


def test_ea_decode_segments_matches_whole_grid_and_reference(ea_payloads):
    jcodec, jl, codec, tl, words, alphas, rhos = ea_payloads
    gamp = gamp_config_from(codec)
    whole = tre.ea_decode(codec, T(words), T(alphas), T(rhos), gamp, packed=True)
    emitted = []
    seg_wise = tre.ea_decode_segments(
        codec, T(words), T(alphas), T(rhos), tl, gamp, packed=True,
        emit=lambda seg, leaves: emitted.append((seg.index, leaves)))
    assert fp.nmse(seg_wise, whole) <= 1e-4
    assert [i for i, _ in emitted] == [0, 1, 2]
    tree_hat = tl.tree_from_blocks(seg_wise)
    got = {}
    for _, leaves in emitted:
        got.update(leaves)
    assert all(torch.equal(got[lid], tree_hat[k]) for lid, k in enumerate(tl.treedef))
    want = jre.ea_decode_segments(jcodec, jnp.asarray(words), jnp.asarray(alphas),
                                  jnp.asarray(rhos), jl, packed=True)
    assert fp.nmse(seg_wise, want) <= 1e-4
    with pytest.raises(ValueError, match="block rows"):
        tre.ea_decode_segments(codec, T(words[:, :2]), T(alphas[:, :2]), T(rhos), tl,
                               packed=True)


def test_api_reconstruct_emit(ea_payloads):
    jcodec, jl, codec, tl, words, alphas, rhos = ea_payloads
    pays = [tcomp.CompressedGradient(T(w), T(a), tl.nbar, codec.cfg.m, 3)
            for w, a in zip(words, alphas)]
    jpays = [jcomp.CompressedGradient(jnp.asarray(w), jnp.asarray(a), jl.nbar, codec.cfg.m, 3)
             for w, a in zip(words, alphas)]
    ea = tapi.ReconSpec(mode="ea")
    barrier = tapi.reconstruct(codec, pays, rhos, tl, recon=ea)
    fired = []
    streamed = tapi.reconstruct(codec, pays, rhos, tl, recon=ea,
                                emit=lambda seg, leaves: fired.append(seg.index))
    want = japi.reconstruct(jcodec, jpays, rhos, jl, recon=japi.ReconSpec(mode="ea"),
                            emit=lambda seg, leaves: None)
    assert fired == [0, 1, 2]
    for k in barrier:
        assert fp.nmse(streamed[k], barrier[k]) <= 1e-4
        assert fp.nmse(streamed[k], want[k]) <= 1e-4
    with pytest.raises(ValueError, match="segment-local"):
        tapi.reconstruct(codec, pays, rhos, tl, recon=tapi.ReconSpec(mode="ae"),
                         emit=lambda s, l: None)
    with pytest.raises(ValueError, match="segment-local"):
        tapi.reconstruct(codec, pays, rhos, tl.spec, recon=ea, emit=lambda s, l: None)
    with pytest.raises(ValueError, match="health"):
        tapi.reconstruct(codec, pays, rhos, tl, recon=tapi.ReconSpec(mode="ea", return_info=True),
                         emit=lambda s, l: None)


def test_api_compress_with_a_layout():
    codec = tapi.make_codec(tcomp.FedQCSConfig(**CFG), device="cpu")
    tt = _pair(_tree([100, 30], seed=31))[1]
    layout = codec.layout_for(tt, per_tensor=True)
    state = tapi.init_state(codec, tt, layout)
    assert state.residual.shape == (layout.rows, 64)
    payload, spec, state = tapi.compress(codec, tt, state, layout)
    assert spec is layout and payload.codes.shape[0] == layout.rows
    got = tapi.reconstruct(codec, [payload], [1.0], spec, recon=tapi.ReconSpec(mode="ea"))
    assert sorted(got) == sorted(tt) and all(got[k].shape == tt[k].shape for k in tt)


# ---------------------------------------------------------------------------
# engine rounds
# ---------------------------------------------------------------------------


def _stream_kw(**kw):
    return {"layout": "per_tensor", "encode_stream": True, **kw}


@pytest.mark.parametrize("method", ["fedqcs-ea", "fedqcs-ae", "qcs-qiht"])
def test_engine_encode_stream_matches_one_pass(method):
    """encode_stream over a per-tensor layout leaves the engine in the SAME
    state as the one-pass encode of that layout after two rounds."""
    one = fp.port_engine(method, cohort_kw={"layout": "per_tensor"})
    two = fp.port_engine(method, cohort_kw=_stream_kw())
    assert two.spec is two.layout and len(two.layout.segments) == 2
    for _ in range(2):
        s1, s2 = one.run_round(), two.run_round()
        assert torch.equal(one.residuals, two.residuals) and torch.equal(one.last_ghat,
                                                                         two.last_ghat)
        assert all(torch.equal(one.params[k], two.params[k]) for k in one.params)
        assert abs(s1["nmse"] - s2["nmse"]) <= 1e-6 * s1["nmse"]


@pytest.mark.parametrize("cohort_kw,stream", [
    pytest.param({"layout": "per_tensor"}, None, id="per_tensor"),
    pytest.param(_stream_kw(), None, id="encode_stream"),
    pytest.param(_stream_kw(grad_accum=2), None, id="grad_accum"),
    pytest.param(_stream_kw(), dict(batch_clients=4), id="streamed-ps"),
])
def test_engine_round_matches_reference(cohort_kw, stream):
    je, te = fp.engines("fedqcs-ea", cohort_kw=cohort_kw, stream=stream)
    assert te.layout.rows == je.layout.rows == 5
    fp.check_round(je, te, 1e-6)


def test_engine_grad_accum_sums_microbatches_in_order():
    eng = fp.port_engine("fedqcs-ea", cohort_kw=_stream_kw(grad_accum=2))
    batch = eng.data.cohort_batch(0, np.arange(fp.CLIENTS))
    got = eng._grads_tree(batch)
    halves = [{k: v[:, i * 2:(i + 1) * 2] for k, v in batch.items()} for i in range(2)]
    g0, g1 = (eng._vgrad(h) for h in halves)
    assert all(torch.equal(got[k], (g0[k] + g1[k]) / 2) for k in got)
    bad = fp.port_engine("fedqcs-ea", cohort_kw=_stream_kw(grad_accum=3))
    with pytest.raises(ValueError, match="must divide"):
        bad.run_round()


@pytest.mark.parametrize("kw,match", [
    pytest.param({"cohort_kw": {"method": "signsgd", "encode_stream": True}}, "encode_stream",
                 id="method"),
    pytest.param({"cohort_kw": {"method": "qcs-dither", "layout": "per_tensor"}}, "qcs-dither",
                 id="dither"),
    pytest.param({"cohort_kw": {"grad_accum": 2}}, "grad_accum", id="accum"),
    pytest.param({"cohort_kw": {"grad_accum": 0, "encode_stream": True}}, "grad_accum",
                 id="accum0"),
    pytest.param({"cohort_kw": {"encode_stream": True, "impl": "loop"}}, "loop", id="loop"),
    pytest.param({"cohort_kw": {"layout": "diagonal"}}, "layout", id="layout"),
    pytest.param({"grad_segments_fn": lambda p, b, l: iter(())}, "encode_stream", id="hook"),
    pytest.param({"layout": TLayout.per_tensor({"w": torch.zeros(3)}, 32)}, "block size",
                 id="block_size"),
])
def test_engine_validation_errors(kw, match):
    cohort_kw = dict(kw.get("cohort_kw", {}))
    method = cohort_kw.pop("method", "fedqcs-ea")
    x, y, parts, params = fp._data()
    with pytest.raises(ValueError, match=match):
        teng.CohortEngine(
            {k: T(v) for k, v in params.items()}, fp._t_grad,
            teng.ArrayClientData(x, y, parts, batch_size=4, device="cpu"),
            fed_cfg=tcomp.FedQCSConfig(**fp.FED),
            cohort=teng.CohortConfig(method=method, **cohort_kw),
            layout=kw.get("layout"), grad_segments_fn=kw.get("grad_segments_fn"), device="cpu")


def test_engine_explicit_layout_with_budgets():
    """An explicit layout with per-segment budgets threads through
    CohortEngine(layout=); the budgets need the streamed encode; the round
    matches the reference's with the same layout."""
    params = {k: T(v) for k, v in fp._data()[3].items()}
    ratio = lambda name, shape: 0.5 if "w" in name else None  # noqa: E731
    tl = TLayout.per_tensor(params, 64, s_ratio=ratio)
    with pytest.raises(ValueError, match="encode_stream"):
        fp.port_engine("fedqcs-ea", layout=tl)
    jl = JLayout.per_tensor({k: jnp.asarray(v) for k, v in fp._data()[3].items()}, 64,
                            s_ratio=ratio)
    je, te = fp.engines("fedqcs-ea", cohort_kw={"encode_stream": True}, layouts=(jl, tl))
    assert te.layout is tl and te.layout.segment_s(te.fed_cfg.s) == [12, 32]
    fp.check_round(je, te, 1e-6)


def test_engine_round_event_wire_segments():
    """The round event itemizes the uplink per layout segment, summing to
    wire_up_bytes, as the reference's does; the streamed pass's spans."""
    jrec, trec = JRec(), TRec()
    je, te = fp.engines("fedqcs-ea", cohort_kw=_stream_kw(), obs=(jrec, trec))
    fp.check_round(je, te, 1e-6)
    [event] = [e for e in trec.events if e["kind"] == "round"]
    [jevent] = [e for e in jrec.events if e["kind"] == "round"]
    segs = event["wire_segments"]
    assert segs == jevent["wire_segments"]
    assert sum(s["rows"] for s in segs) == te.layout.rows
    assert sum(s["bytes"] for s in segs) == pytest.approx(event["wire_up_bytes"], rel=1e-6)
    assert {"backward", "encode_overlap"} <= set(event["phase_ms"])


def _hand_producer(order, extra=()):
    """A hand-written ``grad_segments_fn``: the default pass's segments in
    ``order``, then ``extra`` (index, blocks-from) pairs."""

    def produce(params, batch, layout):
        grads = torch.func.vmap(lambda b: fp._t_grad(params, b))(batch)
        for i in order:
            yield i, layout.segment_blocks_batched(grads, i)
        for i, j in extra:
            yield i, layout.segment_blocks_batched(grads, j)

    return produce


def test_grad_segments_hook():
    """A hook yielding the segments in reverse gives the default round bit
    for bit; a duplicate, an unknown and a missing segment raise."""
    ref = fp.port_engine("fedqcs-ea", cohort_kw=_stream_kw())
    ref.run_round()

    def hooked(fn):
        x, y, parts, params = fp._data()
        return teng.CohortEngine(
            {k: T(v) for k, v in params.items()}, fp._t_grad,
            teng.ArrayClientData(x, y, parts, batch_size=4, device="cpu"),
            fed_cfg=tcomp.FedQCSConfig(**fp.FED),
            cohort=teng.CohortConfig(method="fedqcs-ea", **_stream_kw()),
            server=fp.TSrv(kind="fedadam", lr=fp.LR, b1=0.9, b2=0.999, eps=1e-8),
            grad_segments_fn=fn, device="cpu", a=ref.codec.a)

    eng = hooked(_hand_producer([1, 0]))
    eng.run_round()
    assert torch.equal(eng.residuals, ref.residuals) and torch.equal(eng.last_ghat, ref.last_ghat)
    for fn, match in ((_hand_producer([0, 1], extra=[(1, 1)]), "twice"),
                      (_hand_producer([0, 1], extra=[(2, 1)]), "index 2"),
                      (_hand_producer([1]), r"never yielded segments \[0\]")):
        with pytest.raises(ValueError, match=match):
            hooked(fn).run_round()


def test_make_interleaved_segments_raises():
    """The factory gives the interleaved producer over the model's own
    layout (``tests/test_torch_interleave.py`` holds what it yields), and
    raises for a layout that is not the model's parameter tree."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models.segment_tap import InterleavedSegments, interleaved_layout

    cfg = smoke_config("qwen3-0.6b")
    layout = interleaved_layout(cfg, 8, layer_chunks=2)
    prod = teng.make_interleaved_segments(cfg, layout, layer_chunks=2)
    assert isinstance(prod, InterleavedSegments) and prod.layout is layout
    assert prod.stage_names == ["embed", "layers[0:1]", "layers[1:2]", "head"]
    with pytest.raises(ValueError, match="does not describe"):
        teng.make_interleaved_segments(cfg, TLayout.per_tensor({"w": torch.zeros(3)}, 8))
