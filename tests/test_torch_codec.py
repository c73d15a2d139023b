"""Port parity, client side: the PyTorch codec against the JAX reference.

Both packages run on the CPU in one process; inputs are numpy arrays made
from a seed and handed to each.  The reference runs its kernel route as its
own tests do (interpret-mode Pallas through ``repro.kernels.ops``); the port
runs the plain versions its wrappers take for CPU tensors.  Contracts:

  * Lloyd-Max tables and the wire pack/unpack/decode: bit-identical both
    ways (numpy designs and integer bit operations -- nothing to round).
  * Fused encode: resid bit-identical (same fp32 bisection, same subtract);
    alpha to rtol 1e-6 and codes equal except on lanes whose y lies within
    1e-5 of a threshold (the projection sums in another order).
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core.codebook import make_codebook as j_make_codebook  # noqa: E402
from repro.core.quantizer import LloydMaxQuantizer  # noqa: E402
from repro.core.quantizer import design_lloyd_max as j_design  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core.codebook import ScalarCodebook  # noqa: E402
from repro_torch.core.codebook import make_codebook as t_make_codebook  # noqa: E402
from repro_torch.core.quantizer import design_lloyd_max as t_design  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@functools.lru_cache(maxsize=None)
def _design(bits):
    """One Lloyd-Max design per Q for the encoder tests (the Q=8 design takes
    seconds); the tables test below pins it equal to the reference's."""
    return t_design(bits)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 6])  # Q=8 takes ~15 s per design
def test_lloyd_max_tables_bit_identical(bits):
    j, t = j_design(bits), _design(bits)
    assert np.array_equal(j.levels, t.levels)
    assert np.array_equal(j.thresholds, t.thresholds)
    assert (j.gamma, j.psi, j.kappa) == (t.gamma, t.psi, t.kappa)


def test_codebook_constants_match():
    cfg = dict(block_size=1591, reduction_ratio=3, bits=3)
    jcb = j_make_codebook(jcomp.FedQCSConfig(**cfg))
    tcb = t_make_codebook(tcomp.FedQCSConfig(**cfg))
    assert (jcb.bits, jcb.n_levels, jcb.gamma, jcb.psi, jcb.kappa) == (
        tcb.bits, tcb.n_levels, tcb.gamma, tcb.psi, tcb.kappa)
    assert jcb.n_codes(530) == tcb.n_codes(530) == 530
    y = np.random.default_rng(0).normal(0, 1.3, (7, 530)).astype(np.float32)
    codes_j = np.asarray(jcb.encode(jnp.asarray(y)))
    codes_t = tcb.encode(torch.as_tensor(y)).numpy()
    assert np.array_equal(codes_j, codes_t)
    assert np.array_equal(np.asarray(jcb.decode(jnp.asarray(codes_j))),
                          tcb.decode(torch.as_tensor(codes_t)).numpy())


@pytest.mark.parametrize("bits,m", [(1, 70), (2, 33), (3, 530), (3, 83), (4, 17), (5, 40), (8, 83)])
def test_wire_pack_unpack_bit_identical_both_ways(bits, m):
    rng = np.random.default_rng(bits * 1000 + m)
    codes = rng.integers(0, 1 << bits, (2, 5, m)).astype(np.uint8)
    levels = np.sort(rng.normal(0, 1, 1 << bits)).astype(np.float32)
    words_j = np.asarray(jcomp.pack_codes(jnp.asarray(codes[0]), bits))
    words_t = tcomp.pack_codes(torch.as_tensor(codes[0]), bits)
    assert words_t.dtype == torch.uint32
    assert np.array_equal(words_j, words_t.numpy())
    assert tcomp.packed_width(m, bits) == jcomp.packed_width(m, bits) == words_j.shape[1]
    # port words unpack identically in JAX, and JAX words in the port
    assert np.array_equal(np.asarray(jcomp.unpack_codes(jnp.asarray(words_t.numpy()), bits, m)),
                          codes[0])
    assert np.array_equal(tcomp.unpack_codes(torch.as_tensor(words_j), bits, m).numpy(), codes[0])
    # stacked (K, nb, W) payloads and the level lookup straight from words
    stacked = np.stack([np.asarray(jcomp.pack_codes(jnp.asarray(c), bits)) for c in codes])
    deq_j = np.asarray(jcomp.decode_packed(jnp.asarray(stacked), bits, m, jnp.asarray(levels)))
    deq_t = tcomp.decode_packed(torch.as_tensor(stacked), bits, m, torch.as_tensor(levels))
    assert np.array_equal(deq_j, deq_t.numpy())


def _mlp_params(seed=0):
    from repro.paper.mlp import init_mlp

    return {k: np.asarray(v) for k, v in init_mlp(jax.random.PRNGKey(seed)).items()}


def test_flatten_uses_sorted_key_order():
    """The reference flattens a dict pytree in sorted-key order (b1, b2, w1,
    w2): that order IS the block-grid wire layout, whatever order the dict
    was built in."""
    params_np = _mlp_params()
    rng = np.random.default_rng(1)
    grads_np = {k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params_np.items()}
    blocks_j, _, nbar_j = jcomp.flatten_to_blocks({k: jnp.asarray(v) for k, v in grads_np.items()},
                                                  1591)
    insertion = {k: torch.as_tensor(grads_np[k]) for k in ("w1", "b1", "w2", "b2")}
    blocks_t, layout, nbar_t = tcomp.flatten_to_blocks(insertion, 1591)
    assert nbar_j == nbar_t == 15910 and layout.rows == 10
    assert np.array_equal(np.asarray(blocks_j), blocks_t.numpy())
    back = tcomp.blocks_to_tree(blocks_t, layout)
    assert all(torch.equal(back[k], insertion[k]) for k in insertion)


def check_encoder_parity(blocks, residual, a, bits, s):
    """Runs both encoders on the same numpy inputs and checks the contract.
    Returns the number of code lanes that differ (all near a threshold)."""
    m = a.shape[0]
    t = _design(bits)
    q = LloydMaxQuantizer(t.bits, t.levels, t.thresholds, t.gamma, t.psi)
    words_j, alpha_j, res_j = jops.bqcs_encode_fused(
        jnp.asarray(blocks), jnp.asarray(residual), jnp.asarray(a), q, s)
    taus = torch.as_tensor(q.thresholds.astype(np.float32))
    at = torch.as_tensor(a)
    words_t, alpha_t, res_t = tops.bqcs_encode_fused(
        torch.as_tensor(blocks), torch.as_tensor(residual), at,
        ScalarCodebook("lloyd_max", bits, 1, t.n_levels, t.gamma, t.psi, t.levels, t.thresholds),
        s)
    assert np.array_equal(np.asarray(res_j), res_t.numpy())  # bit-identical
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), rtol=1e-6, atol=0)
    assert words_t.shape == tuple(words_j.shape)
    codes_j = np.asarray(jcomp.unpack_codes(words_j, bits, m))
    codes_t = tcomp.unpack_codes(words_t, bits, m).numpy()
    diff = codes_j != codes_t
    if diff.any():
        sparse, _ = tref.block_topk_ref(torch.as_tensor(blocks + residual), s)
        y = ((sparse * alpha_t[:, None]) @ at.T).numpy()
        gap = np.min(np.abs(y[..., None] - q.thresholds.astype(np.float32)), axis=-1)
        assert gap[diff].max() < 1e-5, gap[diff].max()
    # pad lanes past M are zero in the port's words as in the reference's
    per_word = 32 // bits
    full = tcomp.unpack_codes(words_t, bits, words_t.shape[1] * per_word).numpy()
    assert not full[:, m:].any()
    return int(diff.sum())


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_fused_encode_matches_reference(bits):
    """Q sweep at a width where M is not a word multiple for every Q
    (Mp > M: zero pad lanes), with one all-zero (dead) block."""
    rng = np.random.default_rng(100 + bits)
    nb, n, m, s = 12, 256, 83, 26
    blocks = rng.normal(0, 0.1, (nb, n)).astype(np.float32)
    residual = rng.normal(0, 0.03, (nb, n)).astype(np.float32)
    blocks[3] = 0.0
    residual[3] = 0.0
    a = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    assert tcomp.packed_width(m, bits) * (32 // bits) > m or bits == 8
    check_encoder_parity(blocks, residual, a, bits, s)


def test_fused_encode_full_width_rows():
    """The paper's block geometry (N=1591, M=530, Q=3, S=159) on 20 rows,
    with the reference's own sensing matrix carried across."""
    cfg = jcomp.FedQCSConfig(block_size=1591, reduction_ratio=3, bits=3, use_kernels=True,
                             gamp_variance_mode="scalar")
    a = np.asarray(jcomp.BQCSCodec(cfg).a)
    rng = np.random.default_rng(5)
    blocks = rng.normal(0, 0.05, (20, 1591)).astype(np.float32)
    residual = np.zeros_like(blocks)
    n_diff = check_encoder_parity(blocks, residual, a, 3, cfg.s)
    print("differing code lanes:", n_diff)


def test_scale_factor_matches_reference():
    from repro.core.sensing import scale_factor as j_scale
    from repro_torch.core.sensing import scale_factor as t_scale

    blocks = np.random.default_rng(4).normal(0, 0.1, (6, 300)).astype(np.float32)
    blocks[2] = 0.0  # a zero block gets alpha = 0
    alpha_t = t_scale(torch.as_tensor(blocks), 100).numpy()
    np.testing.assert_allclose(alpha_t, np.asarray(j_scale(jnp.asarray(blocks), 100)), rtol=1e-6)
    assert alpha_t[2] == 0.0


def test_codec_with_injected_matrix_matches_reference_codec():
    cfg_kw = dict(block_size=300, reduction_ratio=3, bits=3, s_ratio=0.1, use_kernels=True,
                  gamp_variance_mode="scalar")
    jcodec = jcomp.BQCSCodec(jcomp.FedQCSConfig(**cfg_kw))
    _, a_t = from_reference({}, np.asarray(jcodec.a))
    tcodec = tcomp.BQCSCodec(tcomp.FedQCSConfig(**cfg_kw), a=a_t, device="cpu")
    rng = np.random.default_rng(9)
    blocks = rng.normal(0, 0.1, (6, 300)).astype(np.float32)
    res = rng.normal(0, 0.01, (6, 300)).astype(np.float32)
    cj, aj, rj = jcodec.compress_blocks(jnp.asarray(blocks), jnp.asarray(res))
    ct, at_, rt = tcodec.compress_blocks(torch.as_tensor(blocks), torch.as_tensor(res))
    assert ct.dtype == torch.uint8 and ct.shape == tuple(cj.shape)
    assert np.array_equal(np.asarray(rj), rt.numpy())
    np.testing.assert_allclose(at_.numpy(), np.asarray(aj), rtol=1e-6)
    assert np.mean(np.asarray(cj) != ct.numpy()) < 1e-3


@pytest.mark.parametrize("bad", [
    dict(bits=0), dict(s_ratio=0.0), dict(reduction_ratio=2000, block_size=1000),
    dict(wire_mode="x"), dict(recon_mode="ea", wire_mode="psum_dequant"),
    dict(gamp_variance_mode="fast"), dict(recon_chunk=-1),
])
def test_config_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        jcomp.FedQCSConfig(**bad).validate()
    with pytest.raises(ValueError):
        tcomp.FedQCSConfig(**bad).validate()
    fields = {f.name: f.default for f in dataclasses.fields(jcomp.FedQCSConfig)}
    assert fields == {f.name: f.default for f in dataclasses.fields(tcomp.FedQCSConfig)}


@pytest.mark.parametrize("kw,item", [
    (dict(use_kernels=False), "item 1"),
    (dict(use_kernels=False, codebook="vq"), "item 1"),
    (dict(use_kernels=False, codebook="dithered_uniform"), "item 1"),
])
def test_routes_outside_the_slice_raise(kw, item):
    """These codec routes raised until ROADMAP queue 1 ``item`` ported them:
    with ``use_kernels=False`` the codec now encodes as the reference's XLA
    route for each codebook -- residual bit-identical, alpha to rtol 1e-6,
    a code differing only within 1e-5 of a decision (threshold or vq
    centroid-score tie), as the fused encoder's contract."""
    cfg_kw = dict(block_size=64, reduction_ratio=2, **kw)
    jcodec = jcomp.BQCSCodec(jcomp.FedQCSConfig(**cfg_kw))
    _, a = from_reference({}, np.asarray(jcodec.a))
    tcodec = tcomp.BQCSCodec(tcomp.FedQCSConfig(**cfg_kw), a=a, device="cpu")
    rng = np.random.default_rng(len(item) + len(kw))
    blocks = rng.normal(0, 0.1, (9, 64)).astype(np.float32)
    res = rng.normal(0, 0.02, (9, 64)).astype(np.float32)
    blocks[4] = res[4] = 0.0  # a dead block
    cj, aj, rj = jcodec.compress_blocks(jnp.asarray(blocks), jnp.asarray(res))
    wt, at_, rt = tcodec.compress_blocks_packed(torch.as_tensor(blocks), torch.as_tensor(res))
    assert wt.dtype == torch.uint32 and float(at_[4]) == 0.0
    assert np.array_equal(np.asarray(rj), rt.numpy())
    np.testing.assert_allclose(at_.numpy(), np.asarray(aj), rtol=1e-6)
    ct = tcodec.unpack(wt).numpy()
    diff = ct != np.asarray(cj)
    if diff.any():
        x = ((torch.as_tensor(blocks + res) - rt) @ tcodec.a.T * at_[:, None]).numpy()
        cb = tcodec.codebook
        if cb.dim > 1:
            c = cb.centroids.astype(np.float32)
            sc = np.einsum("rjg,lj->rgl", x.reshape(9, cb.dim, -1), c) - 0.5 * (c * c).sum(1)
            pick = lambda k: np.take_along_axis(sc, k[..., None].astype(np.int64), -1)[..., 0]
            gap = np.abs(pick(ct) - pick(np.asarray(cj)))
        else:
            x = x if cb.dither is None else x + cb.dither.astype(np.float32)
            gap = np.min(np.abs(x[..., None] - cb.thresholds.astype(np.float32)), axis=-1)
        assert gap[diff].max() < 1e-5


def test_exact_variance_on_the_kernel_route_warns_once(monkeypatch):
    """use_kernels=True with the default exact variance decodes on the plain
    GAMP loop; the codec says so once per process, as the reference does."""
    monkeypatch.setattr(tcomp, "_KERNEL_BYPASS_WARNED", False)
    kw = dict(block_size=64, reduction_ratio=2, use_kernels=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tcomp.BQCSCodec(tcomp.FedQCSConfig(gamp_variance_mode="scalar", **kw), device="cpu")
        # the default route never warns: exact variance is its own algorithm
        tcomp.BQCSCodec(tcomp.FedQCSConfig(block_size=64, reduction_ratio=2), device="cpu")
    with pytest.warns(UserWarning, match="gamp_variance_mode='scalar'"):
        tcomp.BQCSCodec(tcomp.FedQCSConfig(**kw), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tcomp.BQCSCodec(tcomp.FedQCSConfig(**kw), device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tcomp.FedQCSConfig(block_size=64, reduction_ratio=2, use_kernels=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tcomp.BQCSCodec(cfg)  # device defaults to "cuda"
