"""Port parity, slice 2: the dithered_uniform and vq codebooks, the staged
encoder, and the reference's GAMP loop, against the JAX reference.

Both packages run on the CPU in one process; inputs are numpy arrays made
from a seed and handed to each.  The reference runs its kernel route as its
own tests do (interpret-mode Pallas through ``repro.kernels.ops``) and its
XLA loop ``core.gamp._gamp_run``; the port runs the plain versions its
wrappers take for CPU tensors and its plain-PyTorch port of that loop.
Contracts, each with its reason:

  * codebook tables (levels, thresholds, dither, centroids, gamma, psi):
    bit-identical -- the same numpy designs, copied;
  * wire round trip (encode -> pack -> unpack -> decode / decode_packed) for
    all three families: bit-identical on the same measurements (integer bit
    operations and table lookups; the dither add and the vq score are the
    same f32 operations in the same order);
  * encoders: resid and the staged sparse/resid bit-identical (the same
    fp32 bisection); alpha to rtol 1e-6; a code may differ only on a lane
    whose y lies within 1e-5 of a threshold (scalar) or whose two best
    centroid scores lie within 1e-5 of each other (vq), because the
    projection sums in another order;
  * the GAMP loop (exact variance, damping 0.7, the dithered EA decode):
    NMSE <= 1e-4 against the reference, and per-block iteration counts
    equal on >= 99% of blocks (a last-bit difference in a product can move
    one block's early freeze by one iteration);
  * one full-width round per method x family from the reference's A and
    init: 0 differing wire lanes expected (a lane may differ only within
    float rounding of a threshold or tie), and the round's ``nmse`` stat
    within 1e-4 relative of the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import codebook as jcb  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import gamp as jgamp  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro.fed import engine as jeng  # noqa: E402
from repro.fed.channel import ChannelConfig as JChan  # noqa: E402
from repro.fed.partition import PartitionConfig as JPart  # noqa: E402
from repro.fed.partition import partition_indices as j_partition  # noqa: E402
from repro.fed.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro.fed.server_opt import ServerOptConfig as JSrv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.paper import mlp as jmlp  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import gamp as tgamp  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.paper import mlp as tmlp  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

T = torch.as_tensor
J = jnp.asarray


def _nmse(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.sum((x - ref) ** 2) / max(np.sum(ref**2), 1e-30))


def _cfg_kw(codebook, n=1591, bits=3, **kw):
    return dict(block_size=n, reduction_ratio=3, bits=bits, s_ratio=0.1, use_kernels=True,
                gamp_variance_mode="scalar", codebook=codebook, **kw)


def _codebooks(codebook, **kw):
    jc = jcb.make_codebook(jcomp.FedQCSConfig(**_cfg_kw(codebook, **kw)))
    tc = tcb.make_codebook(tcomp.FedQCSConfig(**_cfg_kw(codebook, **kw)))
    return jc, tc


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,m,seed", [(1, 70, 0), (3, 530, 1234), (4, 83, 7), (8, 100, 3)])
def test_dithered_tables_bit_identical(bits, m, seed):
    j = jcb.design_dithered_uniform(bits, m, seed)
    t = tcb.design_dithered_uniform(bits, m, seed)
    for name in ("levels", "thresholds", "dither"):
        assert np.array_equal(getattr(j, name), getattr(t, name)), name
    assert (j.family, j.bits, j.dim, j.n_levels, j.gamma, j.psi, j.kappa) == (
        t.family, t.bits, t.dim, t.n_levels, t.gamma, t.psi, t.kappa)
    assert t.dither_t("cpu").dtype == torch.float32
    assert np.array_equal(t.dither_t("cpu").numpy(), np.asarray(j.jnp_dither()))


@pytest.mark.parametrize("levels,dim,seed", [(8, 2, 1234), (16, 2, 1), (5, 3, 9), (8, 4, 2)])
def test_vq_tables_bit_identical(levels, dim, seed):
    j = jcb.design_vq(levels, dim, seed)
    t = tcb.design_vq(levels, dim, seed)
    assert np.array_equal(j.centroids, t.centroids)
    assert (j.family, j.bits, j.dim, j.n_levels, j.gamma, j.psi, j.kappa) == (
        t.family, t.bits, t.dim, t.n_levels, t.gamma, t.psi, t.kappa)
    assert t.bits == jcb.index_bits(levels) == tcb.index_bits(levels)
    assert j.n_codes(6 * dim) == t.n_codes(6 * dim) == 6
    with pytest.raises(ValueError):
        t.n_codes(6 * dim + 1)


@pytest.mark.parametrize("kw", [
    dict(codebook="lloyd_max"), dict(codebook="dithered_uniform"),
    dict(codebook="vq"), dict(codebook="vq", vq_levels=5, vq_dim=2),
])
def test_config_codebooks_and_bits_per_entry_match(kw):
    cfg_kw = dict(block_size=1591, reduction_ratio=3, bits=3, **kw)
    jcfg, tcfg = jcomp.FedQCSConfig(**cfg_kw), tcomp.FedQCSConfig(**cfg_kw)
    assert jcfg.bits_per_entry == tcfg.bits_per_entry
    j, t = jcb.make_codebook(jcfg), tcb.make_codebook(tcfg)
    assert (j.family, j.bits, j.dim, j.n_levels, j.gamma, j.psi) == (
        t.family, t.bits, t.dim, t.n_levels, t.gamma, t.psi)
    assert j.n_codes(530) == t.n_codes(530)
    with pytest.raises(ValueError, match="unknown codebook"):
        tcb.make_codebook(tcomp.FedQCSConfig(codebook="trained"))


# ---------------------------------------------------------------------------
# wire round trip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,bits", [
    ("lloyd_max", 3), ("dithered_uniform", 2), ("dithered_uniform", 3), ("vq", 3), ("vq", 4),
])
def test_wire_round_trip_all_families(family, bits):
    jc, tc = _codebooks(family, bits=bits)
    m = 530
    y = np.random.default_rng(bits).normal(0, 1.2, (2, 7, m)).astype(np.float32)
    codes_j = np.asarray(jc.encode(J(y)))
    codes_t = tc.encode(T(y))
    assert codes_t.dtype == torch.uint8
    assert np.array_equal(codes_j, codes_t.numpy())
    assert codes_t.shape[-1] == tc.n_codes(m)
    words_j = np.asarray(jcomp.pack_codes(J(codes_j.reshape(14, -1)), jc.bits)).reshape(2, 7, -1)
    words_t = tcomp.pack_codes(codes_t.reshape(14, -1), tc.bits).reshape(2, 7, -1)
    assert np.array_equal(words_j, words_t.numpy())
    assert words_t.shape[-1] == tcomp.packed_width(tc.n_codes(m), tc.bits)
    assert torch.equal(tcomp.unpack_codes(words_t, tc.bits, tc.n_codes(m)), codes_t)
    deq_j = np.asarray(jc.decode(J(codes_j), m))
    assert np.array_equal(deq_j, tc.decode(codes_t, m).numpy())
    assert np.array_equal(np.asarray(jc.decode_packed(J(words_j), m)),
                          tc.decode_packed(words_t, m).numpy())
    assert np.array_equal(deq_j, tc.decode_packed(words_t, m).numpy())


# ---------------------------------------------------------------------------
# the encoders
# ---------------------------------------------------------------------------


def _vq_tie_gap(y, cb, codes_a, codes_b):
    """Score gap between the two codes a differing vq lane took (same y)."""
    c = cb.centroids.astype(np.float32)
    n_lev, d = c.shape
    g = y.shape[-1] // d
    y3 = y.reshape(y.shape[:-1] + (d, g))
    sc = np.einsum("...jg,lj->...gl", y3, c) - 0.5 * np.sum(c * c, axis=1)
    pick = lambda codes: np.take_along_axis(sc, codes[..., None].astype(np.int64), -1)[..., 0]
    return np.abs(pick(codes_a) - pick(codes_b))


def check_fused_parity(jc, tc, blocks, residual, a, s):
    """Both fused encoders on the same numpy inputs and codebook; returns the
    count of differing code lanes (each within rounding of a decision)."""
    m = a.shape[0]
    words_j, alpha_j, res_j = jops.bqcs_encode_fused(J(blocks), J(residual), J(a), jc, s)
    words_t, alpha_t, res_t = tops.bqcs_encode_fused(T(blocks), T(residual), T(a), tc, s)
    assert np.array_equal(np.asarray(res_j), res_t.numpy())
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), rtol=1e-6, atol=0)
    assert words_t.shape == tuple(words_j.shape)
    lanes = tc.n_codes(m)
    assert words_t.shape[1] == tcomp.packed_width(lanes, tc.bits)
    codes_j = np.asarray(jcomp.unpack_codes(words_j, tc.bits, lanes))
    codes_t = tcomp.unpack_codes(words_t, tc.bits, lanes).numpy()
    diff = codes_j != codes_t
    if diff.any():
        sparse, _ = tref.block_topk_ref(T(blocks + residual), s)
        y = ((sparse * alpha_t[:, None]) @ T(a).T).numpy()
        if tc.dim > 1:
            gap = _vq_tie_gap(y, tc, codes_j, codes_t)
        else:
            if tc.dither is not None:
                y = y + tc.dither.astype(np.float32)
            gap = np.min(np.abs(y[..., None] - tc.thresholds.astype(np.float32)), axis=-1)
        assert gap[diff].max() < 1e-5, gap[diff].max()
    # pad lanes past the code lanes are zero, as in the reference's words
    per_word = 32 // tc.bits
    full = tcomp.unpack_codes(words_t, tc.bits, words_t.shape[1] * per_word).numpy()
    assert not full[:, lanes:].any()
    return int(diff.sum())


@pytest.mark.parametrize("family,n,bits,vq_dim", [
    ("dithered_uniform", 256, 3, 2), ("dithered_uniform", 300, 4, 2),
    ("vq", 258, 3, 2), ("vq", 300, 4, 2), ("vq", 240, 3, 4),
])
def test_fused_encoder_branches_match_reference(family, n, bits, vq_dim):
    """Dither and vq branches at widths with pad lanes (M or G not a word
    multiple), with one dead block."""
    kw = dict(block_size=n, reduction_ratio=3, bits=bits, codebook=family, vq_dim=vq_dim)
    jcodec = jcomp.BQCSCodec(jcomp.FedQCSConfig(**kw))
    tc = tcb.make_codebook(tcomp.FedQCSConfig(**kw))
    rng = np.random.default_rng(n + bits)
    blocks = rng.normal(0, 0.1, (12, n)).astype(np.float32)
    residual = rng.normal(0, 0.03, (12, n)).astype(np.float32)
    blocks[3] = residual[3] = 0.0
    check_fused_parity(jcodec.codebook, tc, blocks, residual, np.asarray(jcodec.a), n // 10)


@pytest.mark.parametrize("family", ["dithered_uniform", "vq"])
def test_fused_encoder_branches_full_width(family):
    """The paper's geometry (N=1591, M=530, Q=3, S=159) on 30 rows from the
    reference's own sensing matrix: vq G = 265 code lanes in W = 27 words,
    dithered M = 530 lanes in W = 53."""
    jcodec = jcomp.BQCSCodec(jcomp.FedQCSConfig(**_cfg_kw(family)))
    tc = tcb.make_codebook(tcomp.FedQCSConfig(**_cfg_kw(family)))
    rng = np.random.default_rng(5)
    blocks = rng.normal(0, 0.05, (30, 1591)).astype(np.float32)
    n_diff = check_fused_parity(jcodec.codebook, tc, blocks, np.zeros_like(blocks),
                                np.asarray(jcodec.a), 159)
    w = tcomp.packed_width(tc.n_codes(530), tc.bits)
    assert w == {"vq": 27, "dithered_uniform": 53}[family]
    print(f"{family}: {n_diff} differing code lanes")


def test_encoder_a_t_pads_scalar_columns_only():
    """Scalar families: A^T and the dither zero-padded to the word multiple
    (M = 85 at Q = 3 -> Mp = 90); vq: A^T unpadded (the padding is at the
    code-lane level)."""
    _, lm = _codebooks("lloyd_max", n=256)
    a = torch.randn((85, 256))
    assert tuple(tops.encoder_a_t(a, lm).shape) == (256, 90)
    assert torch.equal(tops.encoder_a_t(a, lm)[:, :85], a.T)
    _, du = _codebooks("dithered_uniform", n=256)
    tables = tops.encoder_tables(du, 85, "cpu")
    assert tuple(tables.dither.shape) == (90,) and not tables.dither[85:].any()
    assert tables.half_norms is None
    _, vq = _codebooks("vq")
    a = torch.randn((530, 1591))
    assert torch.equal(tops.encoder_a_t(a, vq), a.T)
    tables = tops.encoder_tables(vq, 530, "cpu")
    assert tables.dither is None and tuple(tables.tab.shape) == (8, 2)
    assert torch.equal(tables.half_norms, 0.5 * torch.sum(tables.tab * tables.tab, dim=1))


@pytest.mark.parametrize("nb,n,s", [(12, 256, 26), (30, 1591, 159), (5, 100, 1)])
def test_staged_block_sparsify_bit_identical(nb, n, s):
    rng = np.random.default_rng(nb + n)
    x = rng.normal(0, 0.1, (nb, n)).astype(np.float32)
    x[1] = 0.0
    x[2, :5] = 0.3  # a tie at the row max
    sp_j, res_j = jops.block_sparsify(J(x), s)
    sp_t, res_t = tops.block_sparsify(T(x), s)
    assert np.array_equal(np.asarray(sp_j), sp_t.numpy())
    assert np.array_equal(np.asarray(res_j), res_t.numpy())


@pytest.mark.parametrize("nb,n,m,bits", [(12, 256, 85, 3), (30, 1591, 530, 3), (7, 300, 100, 2)])
def test_staged_bqcs_encode_matches_reference(nb, n, m, bits):
    rng = np.random.default_rng(nb + m)
    x = rng.normal(0, 0.1, (nb, n)).astype(np.float32)
    x[0] = 0.0
    a = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    jc, tc = _codebooks("lloyd_max", bits=bits)
    codes_j, alpha_j = jops.bqcs_encode(J(x), J(a), jc)
    codes_t, alpha_t = tops.bqcs_encode(T(x), T(a), tc)
    assert codes_t.dtype == torch.uint8 and codes_t.shape == tuple(codes_j.shape)
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), rtol=1e-6, atol=0)
    assert alpha_t[0] == 0.0
    diff = np.asarray(codes_j) != codes_t.numpy()
    if diff.any():
        y = (x * alpha_t.numpy()[:, None]) @ a.T
        gap = np.min(np.abs(y[..., None] - tc.thresholds.astype(np.float32)), axis=-1)
        assert gap[diff].max() < 1e-5
    # bf16 blocks are upcast to f32, as the reference's wrapper does
    codes_b, _ = tops.bqcs_encode(T(x).to(torch.bfloat16), T(a), tc)
    codes_r, _ = tref.bqcs_encode_ref(T(x).to(torch.bfloat16).float(), T(a).T.contiguous(),
                                      tc.thresholds_t("cpu"))
    assert torch.equal(codes_b, codes_r)
    with pytest.raises(ValueError, match="undithered scalar"):
        tops.bqcs_encode(T(x), T(a), _codebooks("vq")[1])


def test_staged_path_matches_fused_wire():
    """block_sparsify -> bqcs_encode -> pack_codes (the reference's unfused
    baseline) against the fused encoder on the same input: resid
    bit-identical, alpha to 1e-6, codes equal except near a threshold."""
    rng = np.random.default_rng(2)
    jc, tc = _codebooks("lloyd_max")
    blocks = T(rng.normal(0, 0.05, (30, 1591)).astype(np.float32))
    resid = T(rng.normal(0, 0.01, (30, 1591)).astype(np.float32))
    a = T((rng.standard_normal((530, 1591)) / np.sqrt(530)).astype(np.float32))
    words_f, alpha_f, res_f = tops.bqcs_encode_fused(blocks, resid, a, tc, 159)
    sparse, res_s = tops.block_sparsify(blocks + resid, 159)
    codes_s, alpha_s = tops.bqcs_encode(sparse, a, tc)
    words_s = tcomp.pack_codes(codes_s, tc.bits)
    assert torch.equal(res_s, res_f)
    torch.testing.assert_close(alpha_s, alpha_f, rtol=1e-6, atol=0)
    diff = (tcomp.unpack_codes(words_s, 3, 530) != tcomp.unpack_codes(words_f, 3, 530)).numpy()
    if diff.any():
        y = ((sparse * alpha_f[:, None]) @ a.T).numpy()
        gap = np.min(np.abs(y[..., None] - tc.thresholds.astype(np.float32)), axis=-1)
        assert gap[diff].max() < 1e-5


# ---------------------------------------------------------------------------
# the GAMP loop
# ---------------------------------------------------------------------------


def _payload(family, nb=120, n=384, seed=0, bits=3):
    """Encoded sparse blocks from the reference codec: (jcodec, tcodec-side
    codebook and A, words, alpha, codes, true blocks)."""
    kw = _cfg_kw(family, n=n, bits=bits)
    kw["s_ratio"] = 0.08
    jcodec = jcomp.BQCSCodec(jcomp.FedQCSConfig(**kw))
    tc = tcb.make_codebook(tcomp.FedQCSConfig(**kw))
    rng = np.random.default_rng(seed)
    g = np.zeros((nb, n), np.float32)
    for i in range(nb):
        g[i, rng.choice(n, 30, replace=False)] = rng.normal(0, 0.1, 30)
    g[1] = 0.0  # a dead block
    words, alpha, _ = jcodec.compress_blocks_packed(J(g), jnp.zeros_like(J(g)))
    return jcodec, tc, np.asarray(jcodec.a), np.asarray(words), np.asarray(alpha), g


def _check_info_and_nmse(out_t, out_j, label):
    (gh_t, info_t), (gh_j, info_j) = out_t, out_j
    e = _nmse(gh_t.numpy(), gh_j)
    it_t, it_j = info_t.iters.numpy(), np.asarray(info_j.iters)
    same = float(np.mean(it_t == it_j))
    print(f"{label}: NMSE {e:.3g}, iteration counts equal on {same:.3f} of blocks, "
          f"mean iters port {it_t.mean():.2f} reference {it_j.mean():.2f}")
    assert e <= 1e-4, e
    assert same >= 0.99, same
    assert info_t.iters.dtype == torch.int32 and info_t.converged.dtype == torch.bool
    return it_t


def test_gamp_loop_exact_variance_matches_reference():
    """AE on the plain loop with exact (per-entry) variances: em_gamp."""
    rng = np.random.default_rng(3)
    nb, n, m = 120, 384, 128
    a = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    g = np.where(rng.random((nb, n)) < 0.1, rng.normal(0, 0.1, (nb, n)), 0.0).astype(np.float32)
    y = g @ a.T + rng.normal(0, 0.01, (nb, m)).astype(np.float32)
    nu = np.full((nb,), 1e-4, np.float32)
    init_var = (np.sum(g * g, axis=1) / n).astype(np.float32)
    cfg_j, cfg_t = jgamp.GampConfig(variance_mode="exact"), tgamp.GampConfig(variance_mode="exact")
    out_j = jgamp.em_gamp(J(y), J(nu), J(a), cfg_j, init_var=J(init_var), with_info=True)
    out_t = tgamp.em_gamp(T(y), T(nu), T(a), cfg_t, init_var=T(init_var), with_info=True)
    it = _check_info_and_nmse(out_t, out_j, "exact AE")
    assert it.min() < cfg_t.iters  # some blocks froze early: the freeze is exercised


@pytest.mark.parametrize("family", ["lloyd_max", "vq"])
def test_gamp_loop_damped_ea_matches_reference(family):
    """EA on the plain loop with damping 0.7 (scalar variance), for the exact
    scalar channel and the vq AWGN fallback, with a dead block."""
    jcodec, tc, a, words, alpha, _ = _payload(family, seed=4)
    cfg = dict(variance_mode="scalar", damping=0.7)
    out_j = jgamp.qem_gamp_packed(J(words), J(alpha), J(a), jcodec.codebook,
                                  jgamp.GampConfig(**cfg), 128, use_pallas=True, with_info=True)
    out_t = tgamp.qem_gamp_packed(T(words), T(alpha), T(a), tc, tgamp.GampConfig(**cfg), 128,
                                  use_kernels=True, with_info=True)
    _check_info_and_nmse(out_t, out_j, f"damped EA {family}")
    assert not out_t[0][1].any() and bool(out_t[1].converged[1])


def test_dithered_ea_takes_the_gamp_loop_in_both_packages(monkeypatch):
    """The dithered EA decode with use_kernels=True runs the plain loop: the
    step kernel has no per-lane edge shift.  Pinned for both packages (the
    reference's XLA loop and the port's), then held against each other."""
    jcodec, tc, a, words, alpha, _ = _payload("dithered_uniform", seed=5)
    calls = {"j": 0, "t": 0}
    j_loop, t_loop = jgamp._gamp_run, tgamp._gamp_run

    def j_counted(*args, **kw):
        calls["j"] += 1
        return j_loop(*args, **kw)

    def t_counted(*args, **kw):
        calls["t"] += 1
        return t_loop(*args, **kw)

    def no_kernel(*args, **kw):
        raise AssertionError("the dithered EA decode must not take the step kernel")

    monkeypatch.setattr(jgamp, "_gamp_run", j_counted)
    monkeypatch.setattr(tgamp, "_gamp_run", t_counted)
    monkeypatch.setattr(jops, "qgamp_ea_run_packed", no_kernel)
    monkeypatch.setattr(tops, "qgamp_ea_run_packed", no_kernel)
    monkeypatch.setattr(tops, "gamp_ae_run", no_kernel)
    cfg = dict(variance_mode="scalar")
    out_j = jgamp.qem_gamp_packed(J(words), J(alpha), J(a), jcodec.codebook,
                                  jgamp.GampConfig(**cfg), 128, use_pallas=True, with_info=True)
    out_t = tgamp.qem_gamp_packed(T(words), T(alpha), T(a), tc, tgamp.GampConfig(**cfg), 128,
                                  use_kernels=True, with_info=True)
    assert calls == {"j": 1, "t": 1}
    _check_info_and_nmse(out_t, out_j, "dithered EA")
    assert not out_t[0][1].any()


def test_qem_gamp_codes_and_packed_agree():
    """qem_gamp on unpacked codes and qem_gamp_packed on the words give the
    same blocks on every route the port dispatches to."""
    for family, use_kernels in (("lloyd_max", True), ("lloyd_max", False), ("vq", True),
                                ("dithered_uniform", True)):
        _, tc, a, words, alpha, _ = _payload(family, nb=12, seed=6)
        codes = tcomp.unpack_codes(T(words), tc.bits, tc.n_codes(128))
        cfg = tgamp.GampConfig(variance_mode="scalar")
        gp = tgamp.qem_gamp_packed(T(words), T(alpha), T(a), tc, cfg, 128, use_kernels)
        gc = tgamp.qem_gamp(codes, T(alpha), T(a), tc, cfg, use_kernels)
        torch.testing.assert_close(gp, gc, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# one full-width round per method x family
# ---------------------------------------------------------------------------

K = 30


@pytest.fixture(scope="module")
def data():
    (xtr, ytr, _, _), _ = jmnist.load(0)
    return xtr, ytr, j_partition(ytr, K, JPart(kind="paper", seed=0))


def _reference_round(method, fed_kw, data):
    xtr, ytr, parts = data
    params = jmlp.init_mlp(jax.random.PRNGKey(0))
    eng = jeng.CohortEngine(
        params, jmlp.mlp_grad_fn, jeng.ArrayClientData(xtr, ytr, parts, batch_size=1, seed=0),
        fed_cfg=jcomp.FedQCSConfig(**fed_kw), cohort=jeng.CohortConfig(method=method, seed=0),
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
    pay = seen["payloads"]
    q = eng.codec.codebook
    lanes = q.n_codes(eng.fed_cfg.m)
    codes = pay["codes"] if "codes" in pay else jcomp.unpack_codes(pay["words"], q.bits, lanes)
    params_np = {k: np.asarray(v) for k, v in params.items()}
    return params_np, np.asarray(eng.codec.a), stats, np.asarray(seen["ghat"]), np.asarray(codes)


@pytest.mark.parametrize("family", ["dithered_uniform", "vq"])
@pytest.mark.parametrize("method", ["fedqcs-ae", "fedqcs-ea"])
def test_one_full_width_round_matches_reference(method, family, data):
    xtr, ytr, parts = data
    fed_kw = _cfg_kw(family)
    params_np, a_np, stats_j, ghat_j, codes_j = _reference_round(method, fed_kw, data)
    params_t, a_t = from_reference(params_np, a_np)
    eng = teng.CohortEngine(
        params_t, tmlp.mlp_grad_fn,
        teng.ArrayClientData(xtr, ytr, parts, batch_size=1, seed=0, device="cpu"),
        fed_cfg=tcomp.FedQCSConfig(**fed_kw), cohort=teng.CohortConfig(method=method, seed=0),
        sched=tmlp.SchedulerConfig(kind="full", seed=0),
        server=tmlp.ServerOptConfig(kind="fedadam", lr=0.003, b1=0.9, b2=0.999, eps=1e-8),
        device="cpu", a=a_t,
    )
    seen = {}
    client_pass = eng._client_pass

    def capture(*args):
        out = client_pass(*args)
        seen["words"] = out[0]["words"]
        return out

    eng._client_pass = capture
    stats_t = eng.run_round()
    codes_t = eng.codec.unpack(seen["words"]).numpy()
    assert codes_t.shape == codes_j.shape == (K, 10, {"vq": 265, "dithered_uniform": 530}[family])
    n_diff = int(np.sum(codes_t != codes_j))
    nmse_t, nmse_j = stats_t["nmse"], float(stats_j["nmse"])
    e = _nmse(eng.last_ghat.numpy(), ghat_j)
    print(f"{method} {family}: {n_diff} of {codes_j.size} wire lanes differ; nmse port "
          f"{nmse_t:.6f} reference {nmse_j:.6f}; decoded gradient NMSE vs reference {e:.3g}")
    assert n_diff == 0
    assert abs(nmse_t - nmse_j) <= 1e-4 * abs(nmse_j)
    assert stats_t["cohort"] == K and stats_t["participating"] == K


@pytest.mark.parametrize("family,bits", [("dithered_uniform", 1.0), ("vq", 0.5)])
def test_run_federated_codebooks_on_the_cpu(family, bits):
    cfg = tcomp.FedQCSConfig(**_cfg_kw(family))
    res = tmlp.run_federated("fedqcs-ea", steps=1, k_devices=6, device="cpu", fed_cfg=cfg)
    assert res.bits_per_entry == bits
    assert len(res.nmses) == 1 and np.isfinite(res.nmses[0])
    assert res.last_ghat.shape == (10, 1591) and bool(torch.isfinite(res.last_ghat).all())
