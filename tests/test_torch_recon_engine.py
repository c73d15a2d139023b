"""Port parity, the reference's default route: the XLA-algorithm encode
(``use_kernels=False``), the chunked / early-stop / two-phase EA engine
(``core/recon_engine.py``), the ``core/api.py`` facade and
``run_federated``'s default config, against the JAX reference on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages; the
reference's sensing matrix (and MLP init) is carried across with
``convert.from_reference``.  Contracts, each with its reason:

  * sparsify masks (exact top-S with ties planted at the S-th magnitude,
    and the 24-halving threshold): bit-identical -- the same fp32 compares,
    and a stable sort breaks ties by the lower index as ``lax.top_k`` does;
  * XLA-route encode: residual bit-identical, alpha to rtol 1e-6, a code
    may differ only on a lane within 1e-5 of a threshold (scalar) or of a
    centroid-score tie (vq), because the GEMM sums in another order;
  * the engine: the reference's own contracts (``tests/test_recon.py``):
    chunked vs monolithic NMSE <= 1e-4, packed == unpacked bit for bit,
    early stop bit-identical to the fixed trip count, the two-phase sweep
    within NMSE 1e-6 of its composition, dead rows converged and zero; and
    each output within NMSE 1e-4 of the reference's (DESIGN.md #Kernels);
  * one default-config round (``run_federated`` with no ``fed_cfg``) per
    method: differing wire lanes only near a threshold, the decoded
    aggregate within NMSE 1e-4 of the reference's, parameters allclose
    (atol 1e-6 where |ghat| > 1e-4 max|ghat|, as tests/test_torch_round.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import gamp as jgamp  # noqa: E402
from repro.core import recon_engine as jre  # noqa: E402
from repro.core import reconstruction as jrec  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro.fed import engine as jeng  # noqa: E402
from repro.fed.channel import ChannelConfig as JChan  # noqa: E402
from repro.fed.partition import PartitionConfig as JPart  # noqa: E402
from repro.fed.partition import partition_indices as j_partition  # noqa: E402
from repro.fed.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro.fed.server_opt import ServerOptConfig as JSrv  # noqa: E402
from repro.paper import mlp as jmlp  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import gamp as tgamp  # noqa: E402
from repro_torch.core import recon_engine as tre  # noqa: E402
from repro_torch.core import reconstruction as trec  # noqa: E402
from repro_torch.core import sensing as tsens  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.paper import mlp as tmlp  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

T = torch.as_tensor
J = jnp.asarray


def _nmse(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.sum((x - ref) ** 2) / max(np.sum(ref**2), 1e-30))


def decision_gap(x, cb, codes_a, codes_b):
    """Per code lane: how far the projection ``x`` lies from the decision
    between the two codes -- the nearest threshold (scalar, after the
    dither) or the gap between the two centroid scores (vq)."""
    x = np.asarray(x, np.float32)
    if cb.dim > 1:
        c = cb.centroids.astype(np.float32)
        x3 = x.reshape(x.shape[:-1] + (cb.dim, -1))
        sc = np.einsum("...jg,lj->...gl", x3, c) - 0.5 * np.sum(c * c, axis=1)
        pick = lambda k: np.take_along_axis(sc, k[..., None].astype(np.int64), -1)[..., 0]
        return np.abs(pick(np.asarray(codes_a)) - pick(np.asarray(codes_b)))
    if cb.dither is not None:
        x = x + cb.dither.astype(np.float32)
    return np.min(np.abs(x[..., None] - cb.thresholds.astype(np.float32)), axis=-1)


def assert_codes_near(codes_t, codes_j, x, cb):
    """Codes equal except on lanes within 1e-5 of a decision; returns the
    count of differing lanes."""
    diff = np.asarray(codes_t) != np.asarray(codes_j)
    if diff.any():
        gap = decision_gap(x, cb, codes_t, codes_j)
        assert gap[diff].max() < 1e-5, gap[diff].max()
    return int(diff.sum())


# ---------------------------------------------------------------------------
# sparsify
# ---------------------------------------------------------------------------


def _tied_blocks(rng, nb, n, s):
    """Rows with ties planted at the S-th magnitude: several entries (both
    signs) share the value the S-th largest has, straddling the cut."""
    x = rng.normal(0, 1, (nb, n)).astype(np.float32)
    for i in range(nb):
        order = np.argsort(-np.abs(x[i]), kind="stable")
        v = np.abs(x[i, order[min(s, n) - 1]])
        pos = rng.choice(n, min(6, n), replace=False)
        x[i, pos] = v * np.where(rng.random(pos.size) < 0.5, -1.0, 1.0).astype(np.float32)
    x[0, : n // 3] = 0.0  # zeros tie too (harmlessly)
    return x


@pytest.mark.parametrize("variant", ["topk", "bisect"])
@pytest.mark.parametrize("nb,n,s", [(8, 300, 30), (5, 1591, 159), (6, 64, 1), (4, 50, 49),
                                    (3, 40, 40)])
def test_sparsify_masks_bit_identical(variant, nb, n, s):
    x = _tied_blocks(np.random.default_rng(n + s), nb, n, s)
    fj = jsp.block_sparsify if variant == "topk" else jsp.block_sparsify_threshold
    ft = tsp.block_sparsify if variant == "topk" else tsp.block_sparsify_threshold
    sj, rj = fj(J(x), s)
    st, rt = ft(T(x), s)
    assert np.array_equal(np.asarray(sj), st.numpy())
    assert np.array_equal(np.asarray(rj), rt.numpy())
    if variant == "topk":
        mask_j = np.asarray(jsp.block_topk_mask(J(x), s))
        mask_t = tsp.block_topk_mask(T(x), s).numpy()
        assert np.array_equal(mask_j, mask_t)
        assert (mask_t.sum(axis=1) == min(s, n)).all()
    # the error-feedback identity (tests/test_core.py::test_sparsify_identity_and_count)
    assert torch.equal(st + rt, T(x))
    kept, drop = np.abs(st.numpy()), np.abs(rt.numpy())
    for i in range(nb):
        k, d = kept[i][kept[i] != 0], drop[i][drop[i] != 0]
        if k.size and d.size:
            assert k.min() >= d.max() - 1e-7


# ---------------------------------------------------------------------------
# the XLA-route encode
# ---------------------------------------------------------------------------


def _xla_codecs(family, sparsifier="topk", **kw):
    kw = dict(dict(block_size=300, reduction_ratio=3, bits=3, s_ratio=0.1, codebook=family,
                   sparsifier=sparsifier), **kw)
    jc = jcomp.BQCSCodec(jcomp.FedQCSConfig(**kw))
    _, a = from_reference({}, np.asarray(jc.a))
    return jc, tcomp.BQCSCodec(tcomp.FedQCSConfig(**kw), a=a, device="cpu")


def check_xla_encode(jc, tc, blocks, residual):
    """Both XLA-route encoders on the same inputs: packed and unpacked views
    agree, residual bit-identical, alpha rtol 1e-6, codes near decisions."""
    cj, aj, rj = jc.compress_blocks(J(blocks), J(residual))
    ct, at, rt = tc.compress_blocks(T(blocks), T(residual))
    wt, at2, rt2 = tc.compress_blocks_packed(T(blocks), T(residual))
    wj, _, _ = jc.compress_blocks_packed(J(blocks), J(residual))
    assert ct.dtype == torch.uint8 and wt.dtype == torch.uint32
    assert torch.equal(tc.unpack(wt), ct) and torch.equal(at2, at) and torch.equal(rt2, rt)
    assert wt.shape == tuple(wj.shape)
    assert np.array_equal(np.asarray(rj), rt.numpy())
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6, atol=0)
    sparse = T(blocks + residual) - rt
    x, _ = tsens.project_blocks(sparse, tc.a.T)
    return assert_codes_near(ct.numpy(), np.asarray(cj), x.numpy(), tc.codebook)


@pytest.mark.parametrize("sparsifier", ["topk", "bisect"])
@pytest.mark.parametrize("family", ["lloyd_max", "dithered_uniform", "vq"])
def test_xla_encode_matches_reference(family, sparsifier):
    jc, tc = _xla_codecs(family, sparsifier)
    rng = np.random.default_rng(17)
    blocks = rng.normal(0, 0.1, (24, 300)).astype(np.float32)
    residual = rng.normal(0, 0.02, (24, 300)).astype(np.float32)
    blocks[5] = residual[5] = 0.0  # a dead block: alpha 0
    check_xla_encode(jc, tc, blocks, residual)
    _, alpha, _ = tc.compress_blocks(T(blocks), T(residual))
    assert float(alpha[5]) == 0.0


def test_wire_bits_and_compress_tree_match_reference():
    """wire_bits from the true word count (tests/test_core.py:145) and the
    monolithic compress_tree payload (tests/test_core.py:167)."""
    rng = np.random.default_rng(0)
    for bits, m, nb in [(3, 256, 8), (2, 64, 4), (4, 97, 5), (8, 31, 3), (1, 128, 2)]:
        codes = rng.integers(0, 2**bits, (nb, m)).astype(np.uint8)
        pj = jcomp.CompressedGradient(jcomp.pack_codes(J(codes), bits), jnp.ones((nb,)), nb * 100,
                                      m, bits)
        pt = tcomp.CompressedGradient(tcomp.pack_codes(T(codes), bits), torch.ones(nb), nb * 100,
                                      m, bits)
        assert pt.wire_bits() == pj.wire_bits() == nb * (tcomp.packed_width(m, bits) * 32 + 32)
    kw = dict(block_size=128, reduction_ratio=4, bits=3, s_ratio=0.1, gamp_iters=10)
    jc = jcomp.BQCSCodec(jcomp.FedQCSConfig(**kw))
    _, a = from_reference({}, np.asarray(jc.a))
    tc = tcomp.BQCSCodec(tcomp.FedQCSConfig(**kw), a=a, device="cpu")
    tree = {"w": rng.normal(0, 0.1, (40, 10)).astype(np.float32),
            "b": rng.normal(0, 0.1, (7,)).astype(np.float32)}
    res_t = tc.zero_residual({k: T(v) for k, v in tree.items()})
    assert res_t.shape == (4, 128) and not res_t.any()
    pay_j, layout_j, nres_j = jc.compress_tree({k: J(v) for k, v in tree.items()},
                                               jc.zero_residual(tree))
    pay_t, layout_t, nres_t = tc.compress_tree({k: T(v) for k, v in tree.items()}, res_t)
    assert pay_t.codes.dtype == torch.uint32 and pay_t.codes.shape == tuple(pay_j.codes.shape)
    assert (pay_t.nbar, pay_t.m, pay_t.bits) == (pay_j.nbar, pay_j.m, pay_j.bits) == (407, 32, 3)
    assert pay_t.wire_bits() == pay_j.wire_bits()
    np.testing.assert_allclose(pay_t.alpha.numpy(), np.asarray(pay_j.alpha), rtol=1e-6)
    assert np.array_equal(nres_t.numpy(), np.asarray(nres_j))
    x, _ = tsens.project_blocks(layout_t.to_blocks({k: T(v) for k, v in tree.items()}) - nres_t,
                                tc.a.T)
    assert_codes_near(tc.unpack(pay_t.codes).numpy(), np.asarray(jc.unpack(pay_j.codes)),
                      x.numpy(), tc.codebook)
    assert np.array_equal(tc.dequantize(tc.unpack(pay_t.codes)).numpy(),
                          tc.dequantize_packed(pay_t.codes).numpy())
    assert tc.quantizer is tc.codebook and torch.equal(tc.pack(tc.unpack(pay_t.codes)),
                                                       pay_t.codes)


# ---------------------------------------------------------------------------
# the engine (tests/test_recon.py:276-379, held against the reference too)
# ---------------------------------------------------------------------------


def _payload(q, k=3, nb=2, n=256, seed=0):
    """tests/test_recon.py::_payload: the reference's XLA-route codes of
    sparse blocks, and the port's codec on the reference's A."""
    rng = np.random.default_rng(seed)
    kw = dict(block_size=n, reduction_ratio=4, bits=q, s_ratio=0.08)
    jc = jcomp.BQCSCodec(jcomp.FedQCSConfig(**kw))
    s = jc.cfg.s
    g = np.zeros((k, nb, n), np.float32)
    for i in range(k):
        for j in range(nb):
            g[i, j, rng.choice(n, s, replace=False)] = rng.normal(0, 0.1, s)
    codes, alphas, _ = jax.vmap(jc.compress_blocks)(J(g), jnp.zeros((k, nb, n), jnp.float32))
    words = jax.vmap(lambda c: jcomp.pack_codes(c, q))(codes)
    _, a = from_reference({}, np.asarray(jc.a))
    tc = tcomp.BQCSCodec(tcomp.FedQCSConfig(**kw), a=a, device="cpu")
    arrays = (np.array(codes), np.array(words), np.array(alphas), np.full((k,), 1.0 / k, np.float32))
    return jc, tc, arrays


@pytest.mark.parametrize("chunk", [4, 8, 64])  # padding, even split, chunk > rows
def test_chunked_decode_matches_monolithic(chunk):
    jc, tc, (codes, words, alphas, rhos) = _payload(3, k=7, nb=3)
    kw = dict(iters=10, variance_mode="scalar")
    mono = trec.estimate_and_aggregate(tc, T(codes), T(alphas), T(rhos), tgamp.GampConfig(**kw),
                                       chunk=0)
    ch_u = trec.estimate_and_aggregate(tc, T(codes), T(alphas), T(rhos), tgamp.GampConfig(**kw),
                                       chunk=chunk)
    ch_p = trec.estimate_and_aggregate_packed(tc, T(words), T(alphas), T(rhos),
                                              tgamp.GampConfig(**kw), chunk=chunk)
    assert torch.equal(ch_p, ch_u)
    assert _nmse(ch_u, mono) <= 1e-4
    ref = jrec.estimate_and_aggregate_packed(jc, J(words), J(alphas), J(rhos),
                                             jgamp.GampConfig(**kw), chunk=chunk)
    assert _nmse(ch_p, ref) <= 1e-4


def test_recon_chunk_config_knob(monkeypatch):
    """FedQCSConfig.recon_chunk is the default chunking of both EA entry
    points, and ReconSpec.resolve defers to it and to use_kernels."""
    jc, tc, (codes, words, alphas, rhos) = _payload(2, k=5, nb=2)
    gamp = tgamp.GampConfig(iters=8, variance_mode="scalar")
    tc4 = tcomp.BQCSCodec(dataclasses.replace(tc.cfg, recon_chunk=4), a=tc.a, device="cpu")
    calls = []
    solve = tre.chunked_rows

    def counting(fn, inputs, chunk, *args, **kw):
        calls.append(chunk)
        return solve(fn, inputs, chunk, *args, **kw)

    monkeypatch.setattr(tre, "chunked_rows", counting)
    out_cfg = trec.estimate_and_aggregate_packed(tc4, T(words), T(alphas), T(rhos), gamp)
    monkeypatch.undo()
    out_exp = trec.estimate_and_aggregate_packed(tc, T(words), T(alphas), T(rhos), gamp, chunk=4)
    assert calls == [4] and torch.equal(out_cfg, out_exp)
    spec = tre.ReconSpec(mode="ea").resolve(tc4.cfg)
    assert (spec.chunk, spec.use_kernels) == (4, False)
    assert tre.ReconSpec(mode="ea", chunk=0, use_kernels=True).resolve(tc4.cfg).chunk == 0


def test_early_stop_bitwise_matches_static_trip():
    """early_stop only removes post-freeze no-op iterations: bit-identical
    to the fixed trip count, and a chunk of dead rows runs 0 iterations."""
    jc, tc, (codes, words, alphas, rhos) = _payload(2, k=6, nb=2)
    kw = dict(iters=25, variance_mode="scalar", tol=1e-3)
    gamp = tgamp.GampConfig(**kw)
    es = dataclasses.replace(gamp, early_stop=True)
    out_s = trec.estimate_and_aggregate_packed(tc, T(words), T(alphas), T(rhos), gamp, chunk=4)
    out_e, info = trec.estimate_and_aggregate_packed(tc, T(words), T(alphas), T(rhos), es,
                                                     chunk=4, with_info=True)
    assert torch.equal(out_s, out_e)
    assert int(info.iters.min()) < 25 and info.iters.shape == (6, 2)
    ref = jrec.estimate_and_aggregate_packed(jc, J(words), J(alphas), J(rhos),
                                             jgamp.GampConfig(**kw, early_stop=True), chunk=4)
    assert _nmse(out_e, ref) <= 1e-4
    m = tc.cfg.m
    dead = tgamp._qem_gamp_xla(torch.zeros((3, m), dtype=torch.uint8), torch.zeros(3), tc.a,
                               tc.codebook, es)
    assert not dead[0].any() and dead[1].all() and not dead[2].any()


def test_two_phase_matches_its_composition():
    """The scalar pass everywhere, then the exact re-solve of exactly the
    unconverged blocks; converged blocks keep their scalar estimates."""
    jc, tc, (codes, words, alphas, rhos) = _payload(3, k=6, nb=2, seed=5)
    k, nb, m = codes.shape
    kw = dict(iters=6, variance_mode="scalar", tol=1e-2)
    gamp = tgamp.GampConfig(**kw)
    out, stats = tre.ea_decode_two_phase(tc, T(words), T(alphas), T(rhos), gamp, packed=True,
                                         chunk=4)
    assert out.shape == (nb, tc.cfg.block_size) and bool(torch.isfinite(out).all())
    assert 0 <= stats["phase2_rows"] <= stats["rows"] == k * nb
    flat_c, flat_a = T(codes.reshape(k * nb, m)), T(alphas.reshape(k * nb))
    ghat, conv, _ = tgamp._qem_gamp_xla(flat_c, flat_a, tc.a, tc.codebook, gamp)
    surv = torch.nonzero(~conv).flatten()
    assert surv.numel() == stats["phase2_rows"]
    if surv.numel():
        exact = dataclasses.replace(gamp, variance_mode="exact", early_stop=False)
        refined, _, _ = tgamp._qem_gamp_xla(flat_c[surv], flat_a[surv], tc.a, tc.codebook, exact)
        ghat = ghat.index_copy(0, surv, refined)
    expect = torch.einsum("k,kbn->bn", T(rhos), ghat.reshape(k, nb, -1))
    assert _nmse(out, expect) <= 1e-6
    out_u, stats_u = tre.ea_decode_two_phase(tc, T(codes), T(alphas), T(rhos), gamp,
                                             packed=False, chunk=0)
    assert stats_u["phase2_rows"] == stats["phase2_rows"] and _nmse(out_u, out) <= 1e-6
    ref, stats_j = jre.ea_decode_two_phase(jc, J(words), J(alphas), J(rhos),
                                           jgamp.GampConfig(**kw), packed=True, chunk=4)
    assert stats_j["phase2_rows"] == stats["phase2_rows"]
    assert _nmse(out, ref) <= 1e-4


def test_dead_rows_converged_zero_and_padding_invariant():
    """alpha == 0 rows come back converged and exactly zero, and the dead
    padding of the last chunk leaves the live rows' results unchanged."""
    jc, tc, (codes, words, alphas, rhos) = _payload(2, k=2, nb=2)
    k, nb, m = codes.shape
    flat_c = T(codes.reshape(k * nb, m))
    flat_a = T(alphas.reshape(k * nb)).clone()
    flat_a[1] = 0.0
    gamp = tgamp.GampConfig(iters=5, variance_mode="scalar")
    ghat, conv, iters = tgamp._qem_gamp_xla(flat_c, flat_a, tc.a, tc.codebook, gamp)
    assert bool(conv[1]) and int(iters[1]) == 0 and not ghat[1].any()
    gj, cj, _ = jgamp._qem_gamp_xla(J(codes.reshape(k * nb, m)), J(flat_a.numpy()), jc.a,
                                    jc.quantizer, jgamp.GampConfig(iters=5, variance_mode="scalar"))
    assert bool(cj[1]) and _nmse(ghat, gj) <= 1e-4
    padded = tre.ea_solve_flat(tc, flat_c, flat_a, gamp, packed=False, chunk=3)  # 4 rows: 3 + 1
    assert _nmse(padded, ghat) <= 1e-4 and not padded[1].any()


def _decode_from_stats_matches_reference(tc):
    """``decode_from_stats`` (ported since) on folded AE and EA statistics of
    one 5-client payload, against the reference's on the same inputs."""
    from repro.core import aggregator as jagg
    from repro_torch.core import aggregator as tagg

    kw = dict(block_size=256, reduction_ratio=4, gamp_iters=10, gamp_variance_mode="scalar")
    jc = jcomp.BQCSCodec(jcomp.FedQCSConfig(**kw))
    tc = tcomp.BQCSCodec(tcomp.FedQCSConfig(**kw), a=T(np.array(jc.a)), device="cpu")
    rng = np.random.default_rng(7)
    blocks = rng.normal(size=(5, 2, 256)).astype(np.float32)
    words, alphas, _ = jax.vmap(jc.compress_blocks_packed)(J(blocks), J(np.zeros_like(blocks)))
    w = np.asarray([0.5, 1.5, 0.0, 2.0, 1.0], np.float32)
    ghat = rng.normal(size=(5, 2, 256)).astype(np.float32)
    for js, ts, tol in (
        (jagg.ae_batch_stats(jc, words, alphas, J(w)),
         tagg.ae_batch_stats(tc, T(np.array(words)), T(np.array(alphas)), T(w)), 1e-6),
        (jagg.ea_batch_stats(J(ghat), J(w)), tagg.ea_batch_stats(T(ghat), T(w)), 1e-12),
    ):
        assert _nmse(tre.decode_from_stats(tc, ts), jre.decode_from_stats(jc, js)) <= tol


def _chunked_rows_over_a_mesh_matches_reference(tc):
    """``chunked_rows`` with a mesh (ported since): the chunks shared over a
    one-process ``recon`` axis (a gloo group) give the unsharded result and
    the reference's over its one-device ``recon`` mesh."""
    import tempfile

    import torch.distributed as dist
    from jax.sharding import Mesh as JMesh

    from repro_torch.launch.mesh import Mesh

    x = np.random.default_rng(2).normal(size=(10, 5)).astype(np.float32)
    want = jre.chunked_rows(lambda c: jnp.tanh(c) * 2.0, (J(x),), 3, 5,
                            mesh=JMesh(np.array(jax.devices()[:1]), ("recon",)))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", rank=0, world_size=1)
        try:
            got = tre.chunked_rows(lambda c: torch.tanh(c) * 2.0, (T(x),), 3, 5,
                                   mesh=Mesh({"recon": 1}))
        finally:
            dist.destroy_process_group()
    assert torch.equal(got, tre.chunked_rows(lambda c: torch.tanh(c) * 2.0, (T(x),), 3, 5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _segment_payloads(chunk=0):
    """Three clients' per-tensor payloads (N = 256) encoded by the reference,
    with the port's codec on the same A: (reference codec, port codec,
    reference layout, port layout, words, alphas, rhos)."""
    from repro.core.layout import GradientLayout as JLayout
    from repro_torch.core.layout import GradientLayout as TLayout

    kw = dict(block_size=256, reduction_ratio=4, gamp_iters=10, recon_chunk=chunk)
    jc = jcomp.BQCSCodec(jcomp.FedQCSConfig(**kw))
    tc = tcomp.BQCSCodec(tcomp.FedQCSConfig(**kw), a=T(np.array(jc.a)), device="cpu")
    rng = np.random.default_rng(11)
    tree = {"b": rng.normal(size=(40,)), "w": rng.standard_t(4, size=(30, 20)) * 0.1}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    jl = JLayout.per_tensor({k: J(v) for k, v in tree.items()}, 256)
    tl = TLayout.per_tensor({k: T(v) for k, v in tree.items()}, 256)
    blocks = np.stack([np.asarray(jl.to_blocks({k: J((i + 1) * v) for k, v in tree.items()}))
                       for i in range(3)])
    words, alphas, _ = jax.vmap(jc.compress_blocks_packed)(J(blocks), J(np.zeros_like(blocks)))
    rhos = np.asarray([0.5, 0.3, 0.2], np.float32)
    return jc, tc, jl, tl, np.array(words), np.array(alphas), rhos


def _ea_decode_segments_matches_reference(_tc):
    """``ea_decode_segments`` (ported since) with 2-row chunks against the
    reference's on the same words: NMSE <= 1e-4, one emit a segment."""
    jc, tc, jl, tl, words, alphas, rhos = _segment_payloads(chunk=2)
    seen = []
    got = tre.ea_decode_segments(tc, T(words), T(alphas), T(rhos), tl, packed=True, chunk=2,
                                 emit=lambda seg, leaves: seen.append(sorted(leaves)))
    want = jre.ea_decode_segments(jc, J(words), J(alphas), J(rhos), jl, packed=True, chunk=2)
    assert seen == [[0], [1]] and _nmse(got, want) <= 1e-4


def _reconstruct_emit_matches_reference(_tc):
    """``api.reconstruct(emit=)`` (ported since) against the reference's."""
    jc, tc, jl, tl, words, alphas, rhos = _segment_payloads()
    pays = [tcomp.CompressedGradient(T(w), T(a), tl.nbar, 64, 2) for w, a in zip(words, alphas)]
    jpays = [jcomp.CompressedGradient(J(w), J(a), jl.nbar, 64, 2) for w, a in zip(words, alphas)]
    fired = []
    got = tapi.reconstruct(tc, pays, rhos, tl, recon=tre.ReconSpec(mode="ea"),
                           emit=lambda seg, leaves: fired.append(seg.name))
    want = japi.reconstruct(jc, jpays, rhos, jl, recon=japi.ReconSpec(mode="ea"),
                            emit=lambda seg, leaves: None)
    assert fired == ["['b']", "['w']"]
    assert all(_nmse(got[k], want[k]) <= 1e-4 for k in want)


def _compress_tree_per_tensor_matches_reference(_tc):
    """``compress_tree`` over a per-tensor layout (ported since): the one-pass
    encode of that layout's grid, words equal to the reference's."""
    jc, tc, jl, tl, _, _, _ = _segment_payloads()
    rng = np.random.default_rng(5)
    tree = {"b": rng.normal(size=(40,)).astype(np.float32),
            "w": rng.normal(size=(30, 20)).astype(np.float32)}
    pay, spec, res = tc.compress_tree({k: T(v) for k, v in tree.items()},
                                      tc.zero_residual({}, tl), tl)
    jpay, _, jres = jc.compress_tree({k: J(v) for k, v in tree.items()},
                                     jnp.zeros((jl.rows, 256)), jl)
    assert spec is tl and tuple(pay.codes.shape) == (4, 4)  # 1 + 3 rows, 64 lanes of 2 bits
    assert np.array_equal(pay.codes.numpy(), np.asarray(jpay.codes))
    assert np.array_equal(res.numpy(), np.asarray(jres))


# Explicit ids keep each case's name from before ReconSpec(channel=...) (item
# 5), the AE decode in G groups (item 6), the decode from streamed
# statistics (item 7) and the per-tensor layouts (item 9) were ported: the
# first two cases became tests/test_torch_channel.py's api.reconstruct parity
# test and tests/test_torch_knobs.py's grouped-decode tests; routes 1, 2, 5
# and 6 now hold the ported function against the reference (item
# "ported"); route 0 (item 10) since the distributed steps were ported.
@pytest.mark.parametrize("route,item", [
    pytest.param(_chunked_rows_over_a_mesh_matches_reference, "ported", id="route0-item 10"),
    pytest.param(_ea_decode_segments_matches_reference, "ported", id="route1-item 9"),
    pytest.param(_decode_from_stats_matches_reference, "ported", id="route2-item 7"),
    pytest.param(_reconstruct_emit_matches_reference, "ported", id="route5-item 9"),
    pytest.param(_compress_tree_per_tensor_matches_reference, "ported", id="route6-item 9"),
])
def test_engine_routes_outside_the_slice_raise(route, item):
    tc = tcomp.BQCSCodec(tcomp.FedQCSConfig(block_size=256, reduction_ratio=4), device="cpu")
    if item == "ported":
        route(tc)
        return
    with pytest.raises(NotImplementedError, match=item):
        route(tc)


# ---------------------------------------------------------------------------
# the api facade (examples/quickstart.py's round, smaller)
# ---------------------------------------------------------------------------


def _quickstart(rng):
    grads = {
        "dense/w": (rng.standard_t(4, (96, 64)) * 0.01).astype(np.float32),
        "dense/b": (rng.standard_t(4, (64,)) * 0.01).astype(np.float32),
        "head/w": (rng.standard_t(4, (64, 32)) * 0.01).astype(np.float32),
    }
    return [{k: (v + rng.normal(0, 0.002, v.shape)).astype(np.float32) for k, v in grads.items()}
            for _ in range(3)]


@pytest.mark.parametrize("mode,info", [("ea", False), ("ae", False), ("ea", True), ("ae", True)])
def test_api_round_trip_matches_reference(mode, info):
    cfg_kw = dict(block_size=512, reduction_ratio=4, bits=2, s_ratio=0.05, gamp_iters=20)
    workers = _quickstart(np.random.default_rng(0))
    jcodec = japi.make_codec(jcomp.FedQCSConfig(**cfg_kw))
    _, a = from_reference({}, np.asarray(jcodec.a))
    tcodec = tapi.make_codec(tcomp.FedQCSConfig(**cfg_kw), device="cpu", a=a)
    rhos = [0.5, 0.3, 0.2]
    pays_j, pays_t = [], []
    for w in workers:
        pj, spec_j, _ = japi.compress(jcodec, {k: J(v) for k, v in w.items()},
                                      japi.init_state(jcodec, w))
        wt = {k: T(v) for k, v in w.items()}
        pt, spec_t, st = tapi.compress(tcodec, wt, tapi.init_state(tcodec, wt))
        assert pt.codes.dtype == torch.uint32 and pt.wire_bits() == pj.wire_bits()
        x, _ = tsens.project_blocks(spec_t.to_blocks(wt) - st.residual, tcodec.a.T)
        assert_codes_near(tcodec.unpack(pt.codes).numpy(), np.asarray(jcodec.unpack(pj.codes)),
                          x.numpy(), tcodec.codebook)
        np.testing.assert_allclose(pt.alpha.numpy(), np.asarray(pj.alpha), rtol=1e-6)
        pays_j.append(pj)
        # decode both from the reference's wire, so the GAMP contract applies
        pays_t.append(tcomp.CompressedGradient(T(np.array(pj.codes)), T(np.array(pj.alpha)),
                                               pj.nbar, pj.m, pj.bits))
    out_j = japi.reconstruct(jcodec, pays_j, rhos, spec_j,
                             recon=japi.ReconSpec(mode=mode, return_info=info))
    out_t = tapi.reconstruct(tcodec, pays_t, rhos, spec_t,
                             recon=tapi.ReconSpec(mode=mode, return_info=info))
    if info:
        (out_j, info_j), (out_t, info_t) = out_j, out_t
        assert set(info_t) == set(info_j)
        assert np.array_equal(info_t["converged"].numpy(), np.asarray(info_j["converged"]))
        for key in ("gamp_iters_mean", "gamp_iters_max", "gamp_converged_frac"):
            assert abs(float(info_t[key]) - float(info_j[key])) <= 0.05 * max(
                1.0, abs(float(info_j[key])))
    assert set(out_t) == set(out_j)
    num = sum(float(np.sum((out_t[k].numpy() - np.asarray(out_j[k])) ** 2)) for k in out_j)
    den = sum(float(np.sum(np.asarray(out_j[k]) ** 2)) for k in out_j)
    assert num / den <= 1e-4
    with pytest.warns(DeprecationWarning):
        tapi.reconstruct(tcodec, pays_t[:1], [1.0], spec_t, mode="ae")


# ---------------------------------------------------------------------------
# run_federated's default config, one round, both packages
# ---------------------------------------------------------------------------

K_DEFAULT = 10


@pytest.mark.parametrize("method", ["fedqcs-ae", "fedqcs-ea"])
def test_default_round_matches_reference(method, monkeypatch):
    """``run_federated`` with no ``fed_cfg`` is the reference's default (the
    XLA route, exact-variance GAMP): one round at K=10 from the reference's
    init and A, held against the reference's engine set up as its
    ``run_federated`` sets it up."""
    (xtr, ytr, _, _), _ = jmnist.load(0)
    parts = j_partition(ytr, K_DEFAULT, JPart(kind="paper", seed=0))
    cfg = jcomp.FedQCSConfig(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=25,
                             block_size=1591)
    params = jmlp.init_mlp(jax.random.PRNGKey(0))
    eng = jeng.CohortEngine(
        params, jmlp.mlp_grad_fn, jeng.ArrayClientData(xtr, ytr, parts, batch_size=1, seed=0),
        fed_cfg=cfg, cohort=jeng.CohortConfig(method=method, seed=0),
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
    stats_j = eng.run_round()
    pay = seen["payloads"]
    codes_j = np.asarray(pay["codes"] if "codes" in pay else jcomp.unpack_codes(pay["words"], 3,
                                                                                 530))
    ghat_j = np.asarray(seen["ghat"])
    params_t, a_t = from_reference({k: np.asarray(v) for k, v in params.items()},
                                   np.asarray(eng.codec.a))
    got = {}
    client_pass = teng.CohortEngine._client_pass

    def capture_t(self, *args):
        out = client_pass(self, *args)
        got.update(words=out[0]["words"], blocks=out[1], engine=self)
        return out

    monkeypatch.setattr(teng.CohortEngine, "_client_pass", capture_t)
    res = tmlp.run_federated(method, steps=1, k_devices=K_DEFAULT, device="cpu",
                             params=params_t, a=a_t)
    codec = got["engine"].codec
    assert dataclasses.asdict(codec.cfg) == dataclasses.asdict(cfg)
    assert not codec.cfg.use_kernels and codec.cfg.gamp_variance_mode == "exact"
    sparse, _ = tsp.block_sparsify(got["blocks"].reshape(-1, 1591), codec.cfg.s)
    x, _ = tsens.project_blocks(sparse, codec.a.T)
    n_diff = assert_codes_near(codec.unpack(got["words"]).reshape(-1, 530).numpy(),
                               codes_j.reshape(-1, 530), x.numpy(), codec.codebook)
    print(f"{method}: {n_diff} of {codes_j.size} wire lanes differ")
    ghat_t = res.last_ghat.numpy()
    assert _nmse(ghat_t, ghat_j) <= 1e-4
    assert abs(res.nmses[0] - float(stats_j["nmse"])) <= 1e-4 * max(1.0, float(stats_j["nmse"]))
    gj = dict(zip(("b1", "b2", "w1", "w2"), np.split(
        ghat_j.reshape(-1)[:15910], np.cumsum([20, 10, 15680])[:3])))
    big = 1e-4 * np.abs(ghat_j).max()
    for k, v in eng.params.items():
        v, got_k = np.asarray(v), got["engine"].params[k].numpy()
        mask = np.abs(gj[k].reshape(v.shape)) > big
        np.testing.assert_allclose(got_k[mask], v[mask], rtol=0, atol=1e-6)
        assert np.all(np.abs(got_k - v) <= 2 * 0.003 + 1e-6)
    assert res.bits_per_entry == 1.0
