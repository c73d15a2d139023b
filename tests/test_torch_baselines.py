"""Port parity, the paper's baselines (``core/baselines.py``) and their
rounds through the cohort engine, against the JAX reference on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages; the
reference's random protocol state (the dither codec's signs and rows, the
per-client dither draws, the sensing matrix) is injected into the port.
Contracts, each with its reason:

  * SignSGD compress and vote: bit-identical (sign compares and an int32
    sum), ties and -0.0 included;
  * the FWHT: to 1e-6 relative -- the same butterflies in the same order;
  * ``DitherCodec`` project / backproject / reconstruct: to 1e-5 relative;
    a code may differ only on a lane whose ``(y + dither) / delta`` lies
    within 1e-4 of a half step (the projection's sums in another order);
  * ``Codebook.quantize``: the same codes, and values to 1e-7;
  * ``qiht_reconstruct``: the support identical and the values to NMSE
    1e-4 (products in another order over 50 iterations);
  * one engine round per baseline method: see ``torch_fed_parity.check_round``
    (decoded aggregate to NMSE 1e-6 -- 1e-4 for QIHT -- stats to 1e-5
    relative, residuals, parameters).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core.codebook import make_codebook as t_make_codebook  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.paper import mlp as tmlp  # noqa: E402
from torch_fed_parity import check_round, engines, nmse  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def T(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# SignSGD
# ---------------------------------------------------------------------------


def test_signsgd_compress_and_vote_bit_identical():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(4, 3, 50)).astype(np.float32)
    g[0, 0, :5] = 0.0
    g[1, 0, :5] = -0.0
    g[2, 1, 7] = np.float32(-1e-30)  # tiny but normal (XLA flushes subnormals)
    sj = np.asarray(jb.signsgd_compress(jnp.asarray(g)))
    st = tb.signsgd_compress(torch.tensor(g))
    assert st.dtype == torch.int8 and np.array_equal(st.numpy(), sj)
    assert (st[:2, 0, :5] == 1).all()  # 0.0 and -0.0 vote +1
    # K = 4 voters: plant exact ties (2 vs 2), which go to +1
    signs = sj.copy()
    signs[:, 2, :10] = np.array([1, -1, 1, -1], np.int8)[:, None]
    for scale in (1.0, 0.37):
        vj = np.asarray(jb.signsgd_aggregate(jnp.asarray(signs), lr_scale=scale))
        vt = tb.signsgd_aggregate(torch.tensor(signs), lr_scale=scale)
        assert vt.dtype == torch.float32 and np.array_equal(vt.numpy(), vj)
        assert np.all(vt.numpy()[2, :10] == np.float32(scale))


# ---------------------------------------------------------------------------
# QCS-Dither
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2 ** e for e in range(1, 12)])
def test_fwht_matches_reference(n):
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    want = np.asarray(jax.jit(jb._fwht)(jnp.asarray(x)))
    got = tb._fwht(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", [3, 6, 1000])
def test_fwht_rejects_other_lengths(n):
    with pytest.raises(ValueError, match="power-of-2"):
        tb._fwht(torch.zeros((2, n)))


@pytest.mark.parametrize("n,m,bits", [(64, 21, 3), (2048, 682, 3), (256, 128, 1)])
def test_dither_codec_matches_reference(n, m, bits):
    jd = jb.DitherCodec(n=n, m=m, bits=bits)
    td = tb.DitherCodec(n, m, bits, rademacher=T(jd.rademacher), rows=T(jd.rows))
    rng = np.random.default_rng(n + m)
    blocks = rng.normal(0, 0.1, (5, n)).astype(np.float32)
    y_j = np.asarray(jax.jit(jd._project)(jnp.asarray(blocks)))
    y_t = td._project(torch.tensor(blocks)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-6 * np.abs(y_j).max())
    back_j = np.asarray(jax.jit(jd._backproject, static_argnums=1)(jnp.asarray(y_j), 5))
    back_t = td._backproject(torch.tensor(y_j), 5).numpy()
    np.testing.assert_allclose(back_t, back_j, rtol=1e-5, atol=1e-6 * np.abs(back_j).max())

    key = jax.random.PRNGKey(m)
    q_j, delta_j, dith_j = jax.jit(jd.compress)(jnp.asarray(blocks), key)
    unit = jax.random.uniform(key, y_j.shape, minval=-0.5, maxval=0.5)
    q_t, delta_t, dith_t = td.compress(torch.tensor(blocks), T(unit))
    assert q_t.dtype == torch.int32
    np.testing.assert_allclose(delta_t.numpy(), np.asarray(delta_j), rtol=1e-5)
    np.testing.assert_allclose(dith_t.numpy(), np.asarray(dith_j), rtol=1e-5, atol=1e-9)
    diff = q_t.numpy() != np.asarray(q_j)
    if diff.any():  # only where (y + dither) / delta sits on a half step
        v = (y_j + np.asarray(dith_j)) / np.asarray(delta_j)
        assert np.abs(v - np.round(v - 0.5) - 0.5)[diff].max() < 1e-4
    rec_j = np.asarray(jax.jit(jd.reconstruct)(q_j, delta_j, dith_j))
    rec_t = td.reconstruct(T(q_j), T(delta_j), T(dith_j)).numpy()
    np.testing.assert_allclose(rec_t, rec_j, rtol=1e-5, atol=1e-6 * np.abs(rec_j).max())


def test_dither_codec_own_draws_are_a_permutation():
    td = tb.DitherCodec(64, 21, 3, seed=7)
    assert set(td.rademacher.tolist()) == {-1.0, 1.0}
    rows = td.rows.tolist()
    assert len(set(rows)) == 21 and all(0 <= r < 64 for r in rows)
    again = tb.DitherCodec(64, 21, 3, seed=7)
    assert torch.equal(td.rows, again.rows) and torch.equal(td.rademacher, again.rademacher)


# ---------------------------------------------------------------------------
# Codebook.quantize and QIHT
# ---------------------------------------------------------------------------

FAMILIES = {
    "lloyd_max": dict(bits=3),
    "dithered_uniform": dict(bits=3),
    "vq": dict(bits=3, vq_dim=2),
}


@functools.lru_cache(maxsize=None)
def _codecs(family):
    """(reference codec, port config, port codebook) at N = 256, M = 64; the
    codebook designs run once per family."""
    fkw = dict(block_size=256, reduction_ratio=4, s_ratio=0.1, codebook=family,
               **FAMILIES[family])
    tc = tcomp.FedQCSConfig(**fkw)
    return jcomp.BQCSCodec(jcomp.FedQCSConfig(**fkw)), tc, t_make_codebook(tc)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_codebook_quantize_matches_reference(family):
    jcodec, tc, tq = _codecs(family)
    jq = jcodec.codebook
    x = np.random.default_rng(1).normal(size=(7, tc.m)).astype(np.float32)
    want = np.asarray(jq.quantize(jnp.asarray(x)))
    got = tq.quantize(torch.tensor(x))
    assert tuple(got.shape) == x.shape
    # Q(x) = decode(encode(x)) in both; the same codes decode identically
    codes = tq.encode(torch.tensor(x))
    assert np.array_equal(codes.numpy(), np.asarray(jq.encode(jnp.asarray(x))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    assert torch.equal(got, tq.decode(codes, tc.m))


def _qiht_inputs(family, nb=6, seed=2):
    codec, tc, tq = _codecs(family)
    rng = np.random.default_rng(seed)
    blocks = rng.normal(0, 0.1, (nb, tc.block_size)).astype(np.float32)
    blocks[1] = 0.0  # a dead row: alpha == 0
    codes, alpha, _ = codec.compress_blocks(jnp.asarray(blocks), jnp.zeros_like(blocks))
    return codec, tc, tq, np.asarray(codes), np.asarray(alpha)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_qiht_reconstruct_matches_reference(family):
    codec, tc, tq, codes, alpha = _qiht_inputs(family)
    assert alpha[1] == 0.0
    want = np.asarray(jb.qiht_reconstruct(jnp.asarray(codes), jnp.asarray(alpha), codec.a,
                                          codec.codebook, tc.s))
    got = tb.qiht_reconstruct(T(codes), T(alpha), T(codec.a), tq, tc.s)
    got = got.numpy()
    assert np.array_equal(got != 0, want != 0), "QIHT supports differ"
    assert not got[1].any()
    assert nmse(got, want) <= 1e-4, nmse(got, want)
    np.testing.assert_allclose(np.linalg.norm(got[alpha > 0], axis=-1),
                               np.sqrt(tc.m) / alpha[alpha > 0], rtol=1e-5)


# ---------------------------------------------------------------------------
# one engine round per baseline, the reference's draws injected
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,tol", [
    ("qcs-qiht", 1e-4), ("qcs-dither", 1e-6), ("signsgd", 1e-12), ("none", 1e-12),
])
def test_baseline_round_matches_reference(method, tol):
    je, te = engines(method)
    assert (te.codec is None) == (method != "qcs-qiht")
    stats_t, _ = check_round(je, te, tol)
    assert ("nmse" in stats_t) == (method != "none")


def test_qiht_round_with_a_dropped_client_matches_reference():
    """A scheduler dropout: rho = 0 for that slot, its residual carries the
    full gradient, and it abstains from the aggregate."""
    je, te = engines("qcs-qiht", dropout=0.3)
    stats_t, _ = check_round(je, te, 1e-4)
    assert 0 < stats_t["participating"] < stats_t["cohort"]


@pytest.mark.parametrize("method,bits", [("none", 32.0), ("signsgd", 1.0),
                                         ("qcs-dither", 1.0), ("qcs-qiht", 1.0)])
def test_run_federated_baselines_on_the_cpu(method, bits):
    res = tmlp.run_federated(method, steps=1, k_devices=4, eval_every=1, device="cpu")
    assert res.bits_per_entry == bits
    assert len(res.accs) == 1 and len(res.round_ms) == 1
    assert len(res.nmses) == (0 if method == "none" else 1)
    assert res.last_ghat.shape == (10, 1591) and bool(torch.isfinite(res.last_ghat).all())


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        teng.CohortEngine({"w": torch.zeros(3)}, None, None,
                          cohort=teng.CohortConfig(method="fedsgd"), device="cpu")
