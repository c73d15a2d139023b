"""Port parity, PS side: the PyTorch GAMP decoders against the JAX reference.

Inputs are numpy arrays made from a seed and handed to both packages.  The
reference runs its kernel route (interpret-mode Pallas through
``repro.kernels.ops``); the port runs the plain versions its wrappers take
for CPU tensors.  Contracts, each with its reason:

  * shared numerics (channel moments, GM posterior, EM, Bussgang): allclose
    at float32 rounding -- the same formulas, libm/XLA ulps apart;
  * one GAMP step: the reference's own kernel-vs-oracle tolerances
    (qgamp rtol 1e-3 / atol 1e-5, gamp rtol 2e-4 / atol 1e-6);
  * 25-step drivers on the same words: NMSE <= 1e-4 (DESIGN.md #Kernels),
    with a dead row that must come out exactly zero;
  * FedAdam server update: allclose rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bussgang as jbus  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import gamp as jgamp  # noqa: E402
from repro.core import reconstruction as jrec  # noqa: E402
from repro.core.quantizer import design_lloyd_max  # noqa: E402
from repro.fed import server_opt as jsrv  # noqa: E402
from repro.kernels import gm_prior as jgm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import qgamp_step as jq  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import bussgang as tbus  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import gamp as tgamp  # noqa: E402
from repro_torch.core import reconstruction as trec  # noqa: E402
from repro_torch.fed import server_opt as tsrv  # noqa: E402
from repro_torch.kernels import gm_prior as tgm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.gamp_step import CLUSTERS, ROWS, launch_shape  # noqa: E402
from repro_torch.kernels.gamp_step import gamp_step as t_gamp_step  # noqa: E402
from repro_torch.kernels.qgamp_step import qgamp_step as t_qgamp_step  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

T = torch.as_tensor
J = jnp.asarray


def _nmse(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.sum((x - ref) ** 2) / max(np.sum(ref**2), 1e-30))


def _close(t, j, rtol, atol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def test_trunc_channel_moments_all_regimes():
    """In-bin, straddling, one-sided tail and far-tail (fallback) bins.

    Compared standardized -- (xpost - phat)/sd and nu_x/nu_p -- since that is
    what the formulas compute.  Bins with mass above 1e-4 agree to 1e-4
    (XLA's and PyTorch's erfc are a few ulps apart and the ratios divide by
    the mass); far-tail bins take the erfc-free fallback and agree to 1e-6.
    Bins in between (mass below 1e-4 but inside the clip) are ill-posed in
    f32 in both packages and are not compared ulp for ulp -- the reference's
    own step test makes the same exclusion.
    """
    import math

    rng = np.random.default_rng(0)
    k = 4000
    phat = rng.normal(0, 3, k).astype(np.float32)
    nu_p = rng.uniform(0.01, 2.0, k).astype(np.float32)
    lo = rng.normal(0, 3, k).astype(np.float32)
    hi = (lo + rng.uniform(0.05, 4.0, k)).astype(np.float32)
    xj, vj = jgamp.trunc_channel_moments(J(phat), J(nu_p), J(lo), J(hi))
    xt, vt = tgamp.trunc_channel_moments(T(phat), T(nu_p), T(lo), T(hi))
    sd = np.sqrt(nu_p.astype(np.float64))
    a, b = (lo - phat) / sd, (hi - phat) / sd
    mass = np.array([0.5 * (math.erfc(-y / math.sqrt(2)) - math.erfc(-x / math.sqrt(2)))
                     for x, y in zip(a, b)])
    far = (a > 9.0) | (b < -9.0)
    well = (mass > 1e-4) & ~far
    assert well.sum() > 2000 and far.sum() > 50
    std = lambda x, v: ((np.asarray(x) - phat) / sd, np.asarray(v) / nu_p)
    (rt, nt), (rj, nj) = std(xt, vt), std(xj, vj)
    np.testing.assert_allclose(rt[well], rj[well], rtol=1e-4, atol=1e-5)
    # nu_x / nu_p = 1 + ratio2 - ratio1^2 cancels: ~eps * ratio^2 absolute
    np.testing.assert_allclose(nt[well], nj[well], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(np.asarray(xt)[far], np.asarray(xj)[far], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(vt)[far], np.asarray(vj)[far], rtol=1e-6, atol=0)


def test_protocol_constants():
    taus = design_lloyd_max(3).thresholds.astype(np.float32)
    for t_out, j_out in zip(tgamp.tau_tables(T(taus)), jgamp.tau_tables(J(taus))):
        assert np.array_equal(t_out.numpy(), np.asarray(j_out))
    alpha = np.array([0.0, 0.5, 2.0, 1.3], np.float32)
    assert np.array_equal(tgamp.block_prior_energy(T(alpha), 530, 1591).numpy(),
                          np.asarray(jgamp.block_prior_energy(J(alpha), 530, 1591)))
    g = np.random.default_rng(1).normal(0, 1, (4, 50)).astype(np.float32)
    exp = np.array([1.0, 100.0, 0.1, 3.0], np.float32)
    _close(tgamp.norm_guard(T(g), T(exp)), jgamp.norm_guard(J(g), J(exp)), 1e-6, 1e-7)


def test_gm_prior_posterior_em_and_init():
    rng = np.random.default_rng(2)
    nb, n, L = 5, 300, 3
    rhat = rng.normal(0, 0.3, (nb, n)).astype(np.float32)
    v = rng.uniform(0.001, 0.1, (nb, 1)).astype(np.float32)
    init_var = rng.uniform(0.001, 0.1, nb).astype(np.float32)
    th_j = jgm.pack_init_theta(nb, L, J(init_var), 0.9)
    th_t = tgm.pack_init_theta(nb, L, T(init_var), 0.9)
    _close(th_t, th_j, 1e-6, 0)
    gj, nj, pj = jgm.gm_input_channel(J(rhat), J(v), jgm.unpack_theta(th_j, L))
    gt, nt, pt = tgm.gm_input_channel(T(rhat), T(v), tgm.unpack_theta(th_t, L))
    _close(gt, gj, 1e-5, 1e-7)
    _close(nt, nj, 1e-5, 1e-9)
    _close(tgm.em_refresh(pt, n), jgm.em_refresh(pj, n), 1e-5, 1e-9)


def _state(nb, n, m, L, seed):
    rng = np.random.default_rng(seed)
    ghat = rng.normal(0, 0.1, (nb, n)).astype(np.float32)
    nug = rng.uniform(0.01, 0.1, (nb, n)).astype(np.float32)
    shat = rng.normal(0, 0.1, (nb, m)).astype(np.float32)
    theta = np.concatenate([np.full((nb, 1), 0.9), np.full((nb, L), 0.1 / L),
                            rng.normal(0, 0.1, (nb, L)), np.full((nb, L), 0.01)],
                           axis=1).astype(np.float32)
    a = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    return rng, ghat, nug, shat, theta, a


@pytest.mark.parametrize("nb,n,r,L,q", [(8, 256, 4, 3, 3), (8, 128, 2, 2, 2), (16, 512, 3, 4, 4)])
def test_qgamp_step_matches_reference(nb, n, r, L, q):
    m = n // r
    rng, ghat, nug, shat, theta, a = _state(nb, n, m, L, nb * n + q)
    alpha = rng.uniform(0.8, 1.25, (nb, 1)).astype(np.float32)
    # codes consistent with the state (x ~ N(phat, nu_p)), as the reference's
    # own step test draws them
    x = alpha * (ghat @ a.T) + rng.normal(0, 0.1, (nb, m)).astype(np.float32)
    taus = design_lloyd_max(q).thresholds.astype(np.float32)
    codes = np.searchsorted(taus, x, side="left").astype(np.int32)
    lo, hi = (np.asarray(t) for t in jgamp.tau_tables(J(taus)))
    words = np.asarray(jcomp.pack_codes(J(codes.astype(np.uint8)), q))
    out_j = jq.qgamp_step_pallas(J(ghat), J(nug), J(shat), J(theta), J(words), J(alpha), J(lo),
                                 J(hi), J(a), n_components=L, tb=8, interpret=True, bits=q)
    out_t = t_qgamp_step(T(ghat), T(nug), T(shat), T(theta), T(words), T(alpha), T(lo), T(hi),
                         T(a), n_components=L, bits=q)
    out_u = t_qgamp_step(T(ghat), T(nug), T(shat), T(theta), T(codes), T(alpha), T(lo), T(hi),
                         T(a), n_components=L, bits=0)
    for t_, u_, j_ in zip(out_t, out_u, out_j):
        _close(t_, j_, 1e-3, 1e-5)
        assert torch.equal(t_, u_)  # the packed observation unpacks exactly


@pytest.mark.parametrize("nb,n,r,L", [(8, 256, 4, 3), (4, 128, 2, 2), (16, 512, 4, 4)])
def test_gamp_step_matches_reference(nb, n, r, L):
    m = n // r
    rng, ghat, nug, shat, theta, a = _state(nb, n, m, L, nb * n)
    y = rng.normal(0, 1, (nb, m)).astype(np.float32)
    nud = np.full((nb, 1), 0.05, np.float32)
    out_j = jops.gamp_step(J(ghat), J(nug), J(shat), J(theta), J(y), J(nud), J(a), n_components=L)
    out_t = t_gamp_step(T(ghat), T(nug), T(shat), T(theta), T(y), T(nud), T(a), n_components=L)
    for t_, j_ in zip(out_t, out_j):
        _close(t_, j_, 2e-4, 1e-6)


@pytest.mark.parametrize("L,em", [(1, True), (8, True), (3, False)])
def test_gamp_step_components_and_em_match_reference(L, em):
    """The fewest and most mixture components the kernels take, and a step
    without the EM refresh (theta passes through)."""
    nb, n, m = 8, 256, 64
    rng, ghat, nug, shat, theta, a = _state(nb, n, m, L, 100 + L)
    y = rng.normal(0, 1, (nb, m)).astype(np.float32)
    nud = np.full((nb, 1), 0.05, np.float32)
    out_j = jops.gamp_step(J(ghat), J(nug), J(shat), J(theta), J(y), J(nud), J(a),
                           n_components=L, em=em)
    out_t = t_gamp_step(T(ghat), T(nug), T(shat), T(theta), T(y), T(nud), T(a),
                        n_components=L, em=em)
    for t_, j_ in zip(out_t, out_j):
        _close(t_, j_, 2e-4, 1e-6)
    if not em:
        assert torch.equal(out_t[3], T(theta))


@pytest.mark.parametrize("nb", [1, 10, 300, 3000])
def test_gamp_launch_shape_is_legal(nb):
    """The chooser's (rows per tile, blocks per cluster) on a 132-SM H100:
    shapes the kernel instantiates, and at the AE decode's 10 rows a grid of
    at least 64 blocks (the whole-row form used 10)."""
    rows, cluster = launch_shape(nb, 132)
    assert rows in ROWS and cluster in CLUSTERS
    blocks = -(-nb // rows) * cluster
    if nb == 10:
        assert blocks >= 64
    assert launch_shape(nb, 132) == (rows, cluster)  # a pure function


def _sparse_blocks(rng, nb, n, s):
    g = np.zeros((nb, n), np.float32)
    for i in range(nb):
        g[i, rng.choice(n, s, replace=False)] = rng.normal(0, 0.1, s)
    return g


def _codecs(n, seed=1234):
    kw = dict(block_size=n, reduction_ratio=3, bits=3, s_ratio=0.08, use_kernels=True,
              gamp_variance_mode="scalar", seed=seed)
    jc = jcomp.BQCSCodec(jcomp.FedQCSConfig(**kw))
    _, a = from_reference({}, np.asarray(jc.a))
    return jc, tcomp.BQCSCodec(tcomp.FedQCSConfig(**kw), a=a, device="cpu")


def test_ea_driver_matches_reference_on_the_same_words():
    """25 qgamp_step launches from the packed words, incl. a dead row."""
    rng = np.random.default_rng(7)
    nb, n = 12, 384
    jc, tc = _codecs(n)
    g = _sparse_blocks(rng, nb, n, 30)
    words, alpha, _ = jc.compress_blocks_packed(J(g), jnp.zeros_like(J(g)))
    alpha = np.asarray(alpha).copy()
    alpha[2] = 0.0
    words = np.asarray(words)
    taus = np.asarray(jc.quantizer.thresholds, np.float32)
    gh_j = jops.qgamp_ea_run_packed(J(words), J(alpha), jc.a, J(taus), bits=3, m=jc.cfg.m)
    gh_t = tops.qgamp_ea_run_packed(T(words), T(alpha), tc.a, T(taus), bits=3, m=tc.cfg.m)
    assert _nmse(gh_t, gh_j) <= 1e-4
    assert not gh_t[2].any()


def test_ae_driver_matches_reference():
    rng = np.random.default_rng(5)
    nb, n = 6, 384
    jc, tc = _codecs(n)
    g = _sparse_blocks(rng, nb, n, 30)
    y = g @ np.asarray(jc.a).T + rng.normal(0, 0.01, (nb, jc.cfg.m)).astype(np.float32)
    nu = np.full((nb,), 1e-4, np.float32)
    init_var = (np.sum(g * g, axis=1) / n).astype(np.float32)
    gh_j = jops.gamp_ae_run(J(y), J(nu), jc.a, J(init_var))
    gh_t = tops.gamp_ae_run(T(y), T(nu), tc.a, T(init_var))
    assert _nmse(gh_t, gh_j) <= 1e-4


def _round_payload(rng, jc, k, nb, n):
    words, alphas, codes = [], [], []
    for _ in range(k):
        g = _sparse_blocks(rng, nb, n, 30)
        w, a, _ = jc.compress_blocks_packed(J(g), jnp.zeros_like(J(g)))
        words.append(np.asarray(w))
        alphas.append(np.asarray(a))
        codes.append(np.asarray(jcomp.unpack_codes(w, 3, jc.cfg.m)))
    rhos = np.array([0.5, 0.3, 0.2], np.float32)[:k]
    return np.stack(words), np.stack(alphas), np.stack(codes), rhos


def test_reconstruction_strategies_match_reference():
    """EA from packed words (K*nb rows, one solve, rho-sum) and AE (Bussgang
    combine, one EM-GAMP) against the reference's kernel route."""
    rng = np.random.default_rng(11)
    n, k, nb = 384, 3, 4
    jc, tc = _codecs(n)
    words, alphas, codes, rhos = _round_payload(rng, jc, k, nb, n)
    ea_j = jrec.estimate_and_aggregate_packed(jc, J(words), J(alphas), J(rhos))
    ea_t = trec.estimate_and_aggregate_packed(tc, T(words), T(alphas), T(rhos))
    assert _nmse(ea_t, ea_j) <= 1e-4
    ae_j = jrec.aggregate_and_estimate(jc, J(codes), J(alphas), J(rhos))
    ae_t = trec.aggregate_and_estimate(tc, T(codes), T(alphas), T(rhos))
    assert _nmse(ae_t, ae_j) <= 1e-4


def test_bussgang_aggregation_matches_reference():
    rng = np.random.default_rng(3)
    n, k, nb = 384, 3, 4
    jc, tc = _codecs(n)
    words, alphas, codes, rhos = _round_payload(rng, jc, k, nb, n)
    alphas[1, 2] = 0.0  # an empty block contributes nothing
    q_j, q_t = jc.codebook, tc.codebook
    m = jc.cfg.m
    _close(tbus.aggregate_packed(T(words), T(alphas), T(rhos), q_t, m),
           jbus.aggregate_packed(J(words), J(alphas), J(rhos), q_j, m), 1e-6, 1e-6)
    _close(tbus.aggregate_codes(T(codes), T(alphas), T(rhos), q_t),
           jbus.aggregate_codes(J(codes), J(alphas), J(rhos), q_j), 1e-6, 1e-6)
    _close(tbus.effective_noise_var(T(alphas), T(rhos), q_t),
           jbus.effective_noise_var(J(alphas), J(rhos), q_j), 1e-6, 0)
    _close(tbus.signal_energy(T(alphas), T(rhos), m, n),
           jbus.signal_energy(J(alphas), J(rhos), m, n), 1e-6, 0)


@pytest.mark.parametrize("step", [0, 7])
def test_fedadam_server_update_matches_reference(step):
    rng = np.random.default_rng(step)
    shapes = {"w1": (784, 20), "b1": (20,), "w2": (20, 10), "b2": (10,)}
    p = {k: rng.normal(0, 0.1, s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.normal(0, 0.01, s).astype(np.float32) for k, s in shapes.items()}
    m0 = {k: rng.normal(0, 0.001, s).astype(np.float32) for k, s in shapes.items()}
    v0 = {k: rng.uniform(0, 1e-5, s).astype(np.float32) for k, s in shapes.items()}
    cfg_j = jsrv.ServerOptConfig(kind="fedadam", lr=0.003)
    cfg_t = tsrv.ServerOptConfig(kind="fedadam", lr=0.003)
    jd = lambda d: {k: J(v) for k, v in d.items()}
    td = lambda d: {k: T(v) for k, v in d.items()}
    pj, sj = jsrv.server_update(cfg_j, jd(g), {"m": jd(m0), "v": jd(v0)}, jd(p), step)
    pt, st = tsrv.server_update(cfg_t, td(g), {"m": td(m0), "v": td(v0)}, td(p), step)
    for k in shapes:
        _close(pt[k], pj[k], 1e-6, 0)
        _close(st["m"][k], sj["m"][k], 1e-6, 0)
        _close(st["v"][k], sj["v"][k], 1e-6, 0)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("kw,item", [
    (dict(variance_mode="scalar", early_stop=True), "item 2"),
    (dict(variance_mode="exact", early_stop=True), "item 2"),
])
def test_gamp_routes_outside_the_slice_raise(kw, item, use_kernels):
    """early_stop=True (the reference's data-dependent trip count) raised
    until ROADMAP queue 1 ``item`` ported it.  On either route it now runs
    the plain loop (the kernels have a fixed trip count), ends once every
    block froze, and is bit-identical to the fixed trip count; the
    reference's early-stopped decode agrees to NMSE 1e-4."""
    rng = np.random.default_rng(3)
    nb, n = 6, 384
    jc, tc = _codecs(n)
    g = _sparse_blocks(rng, nb, n, 30)
    y = g @ np.asarray(jc.a).T + rng.normal(0, 0.01, (nb, jc.cfg.m)).astype(np.float32)
    y[2] = 0.0  # a block with nothing to find
    nu = np.full((nb,), 1e-4, np.float32)
    es = tgamp.GampConfig(tol=1e-3, **kw)
    fixed = dataclasses.replace(es, early_stop=False)
    got, info = tgamp.em_gamp(T(y), T(nu), tc.a, es, use_kernels=use_kernels, with_info=True)
    want, info_f = tgamp.em_gamp(T(y), T(nu), tc.a, fixed, use_kernels=False, with_info=True)
    assert torch.equal(got, want)
    assert torch.equal(info.iters, info_f.iters) and torch.equal(info.converged, info_f.converged)
    assert int(info.iters.max()) < es.iters  # every block froze before the cap
    ref = jgamp.em_gamp(J(y), J(nu), jc.a, jgamp.GampConfig(tol=1e-3, **kw),
                        use_pallas=use_kernels)
    assert _nmse(got, ref) <= 1e-4
