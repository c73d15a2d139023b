"""Port parity: public names of ported modules that the reference has and
the port lacked until now (``core/sensing.py::sensing_matrix_t``, the
codebook family registry, ``core/gamp.py::GampState`` and the one-step and
code-index GAMP entry points of ``kernels/ops.py``, the names of
``models/segment_tap.py``), on the CPU.

The ``ops`` entry points are held against the reference's own (its Pallas
kernels in interpret mode) on the same inputs: one step of each at the
tolerances of the reference's kernel-vs-plain tests
(``tests/test_kernels.py``), and a fixed-trip EA solve on a codec's codes
(NMSE <= 1e-8 to the reference's, a dead block exactly zero, and bit for
bit the packed-word solve).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import codebook as jcb  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import gamp as jgamp  # noqa: E402
from repro.core import sensing as jsensing  # noqa: E402
from repro.core.quantizer import design_lloyd_max, encode  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import gamp as tgamp  # noqa: E402
from repro_torch.core import sensing as tsensing  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402


def _t(x):
    return torch.tensor(np.asarray(x))


def test_sensing_matrix_t_is_the_transpose():
    """Both packages: A^T has A's entries; the port's module exports the
    reference's names."""
    assert set(tsensing.__all__) == set(jsensing.__all__)
    a = tsensing.sensing_matrix(3, 12, 40, device="cpu")
    at = tsensing.sensing_matrix_t(3, 12, 40, device="cpu")
    assert at.shape == (40, 12) and torch.equal(at, a.T)
    key = jax.random.PRNGKey(3)
    assert np.array_equal(np.asarray(jsensing.sensing_matrix_t(key, 12, 40)),
                          np.asarray(jsensing.sensing_matrix(key, 12, 40)).T)
    blocks = torch.randn((5, 40), generator=torch.Generator().manual_seed(1))
    x, alpha = tsensing.project_blocks(blocks, at)
    jx, jalpha = jsensing.project_blocks(blocks.numpy(), at.numpy())
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=1e-6)


def test_codebook_family_registry_matches_reference():
    """``CODEBOOK_FAMILIES`` is the one registry ``make_codebook`` reads: the
    reference's three families, and a family registered in both packages is
    built by both (here Lloyd-Max tables under another name, bit for bit)."""
    assert "register_codebook_family" in tcb.__all__
    assert set(jcb.__all__) <= set(tcb.__all__)
    assert sorted(tcb.CODEBOOK_FAMILIES) == sorted(jcb.CODEBOOK_FAMILIES)
    jcb.register_codebook_family("lm_alias", jcb.CODEBOOK_FAMILIES["lloyd_max"])
    tcb.register_codebook_family("lm_alias", tcb.CODEBOOK_FAMILIES["lloyd_max"])
    try:
        want = jcb.make_codebook(jcomp.FedQCSConfig(codebook="lm_alias", bits=3))
        got = tcb.make_codebook(tcomp.FedQCSConfig(codebook="lm_alias", bits=3))
        assert np.array_equal(got.thresholds, np.asarray(want.thresholds))
        assert np.array_equal(got.levels, np.asarray(want.levels))
    finally:
        del jcb.CODEBOOK_FAMILIES["lm_alias"], tcb.CODEBOOK_FAMILIES["lm_alias"]
    with pytest.raises(ValueError, match="unknown codebook"):
        tcb.make_codebook(tcomp.FedQCSConfig(codebook="lm_alias"))


def test_segment_tap_exports_the_reference_names():
    """``models/segment_tap.py`` keeps the reference module's public names
    and its private helpers' names."""
    from repro.models import segment_tap as jtap
    from repro_torch.models import segment_tap as ttap

    assert ttap.__all__ == jtap.__all__
    for name in ("_chunk_bounds", "_subtree_ranges", "_stack_chunk_stages", "_Contrib"):
        assert hasattr(ttap, name) and hasattr(jtap, name), name
    assert ttap._chunk_bounds(28, 4) == jtap._chunk_bounds(28, 4) == [(0, 7), (7, 14), (14, 21),
                                                                      (21, 28)]
    assert ttap._chunk_bounds(5, 3) == jtap._chunk_bounds(5, 3)
    fields = lambda c: [f.name for f in dataclasses.fields(c)]  # noqa: E731
    assert fields(ttap._Contrib) == fields(jtap._Contrib)
    assert fields(ttap.Stage) == fields(jtap.Stage)


def test_gamp_state_is_the_reference_carry_type():
    assert set(jgamp.__all__) <= set(tgamp.__all__)
    state = tgamp.GampState((1, 2, 3))
    assert isinstance(state, tuple) and tuple(state) == (1, 2, 3)


def _step_case(seed, nb, n, m, L):
    rng = np.random.default_rng(seed)
    theta = np.concatenate([np.full((nb, 1), 0.9), np.full((nb, L), 0.1 / L),
                            rng.normal(0, 0.1, (nb, L)), np.full((nb, L), 0.01)], axis=1)
    return (rng.normal(0, 0.1, (nb, n)).astype(np.float32),
            rng.uniform(0.01, 0.1, (nb, n)).astype(np.float32),
            rng.normal(0, 0.1, (nb, m)).astype(np.float32), theta.astype(np.float32),
            np.asarray(jsensing.sensing_matrix(jax.random.PRNGKey(2), m, n)), rng)


def test_ops_gamp_step_matches_reference():
    """``ops.gamp_step``, one AE iteration, against the reference's
    (interpret-mode kernel) at rtol 2e-4 / atol 1e-6."""
    nb, n, m, L = 8, 256, 64, 3
    ghat, nug, shat, theta, a, rng = _step_case(1, nb, n, m, L)
    y = rng.normal(0, 1, (nb, m)).astype(np.float32)
    nud = np.full((nb, 1), 0.05, np.float32)
    want = jops.gamp_step(ghat, nug, shat, theta, y, nud, a, n_components=L)
    got = tops.gamp_step(*map(_t, (ghat, nug, shat, theta, y, nud, a)), n_components=L)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=1e-6)


def test_ops_qgamp_step_matches_reference():
    """``ops.qgamp_step`` on (nb, M) int32 codes consistent with the state
    (as the reference's test draws them), against the reference's at rtol
    1e-3 / atol 1e-5."""
    nb, n, m, L, q = 8, 256, 64, 3, 3
    ghat, nug, shat, theta, a, rng = _step_case(2, nb, n, m, L)
    alpha = rng.uniform(0.8, 1.25, (nb, 1)).astype(np.float32)
    quant = design_lloyd_max(q)
    x_obs = alpha * (ghat @ a.T) + rng.normal(0, 0.1, (nb, m)).astype(np.float32)
    codes = np.asarray(encode(jnp.asarray(x_obs), quant)).astype(np.int32)
    lo, hi = jgamp.tau_tables(quant.jnp_thresholds())
    want = jops.qgamp_step(ghat, nug, shat, theta, codes, alpha, lo, hi, a, n_components=L)
    got = tops.qgamp_step(*map(_t, (ghat, nug, shat, theta, codes, alpha, lo, hi, a)),
                          n_components=L)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-5)


def test_qgamp_ea_run_matches_reference():
    """``ops.qgamp_ea_run`` on a codec's codes (block 2 dead): NMSE <= 1e-8
    to the reference's, the dead block exactly zero, and bit for bit
    ``qgamp_ea_run_packed`` on the same codes packed."""
    rng = np.random.default_rng(7)
    nb, n, s = 5, 256, 20
    g = np.zeros((nb, n), np.float32)
    for i in range(nb):
        g[i, rng.choice(n, s, replace=False)] = rng.normal(0, 0.1, s)
    cfg = jcomp.FedQCSConfig(block_size=n, reduction_ratio=3, bits=3, s_ratio=s / n)
    codec = jcomp.BQCSCodec(cfg)
    codes, alpha, _ = codec.compress_blocks(jnp.asarray(g), jnp.zeros((nb, n), jnp.float32))
    alpha = np.asarray(alpha).copy()
    alpha[2] = 0.0
    taus = np.asarray(codec.quantizer.jnp_thresholds())
    want = np.asarray(jops.qgamp_ea_run(codes, alpha, codec.a, taus, iters=8))
    a = _t(codec.a)
    got = tops.qgamp_ea_run(_t(codes), _t(alpha), a, _t(taus), iters=8)
    err = float(np.sum((got.numpy() - want) ** 2) / np.sum(want ** 2))
    assert err <= 1e-8, err
    assert bool((got[2] == 0).all())
    words = tcomp.pack_codes(_t(codes).to(torch.uint8), 3)
    packed = tops.qgamp_ea_run_packed(words, _t(alpha), a, _t(taus), bits=3, m=codes.shape[1],
                                      iters=8)
    assert torch.equal(got, packed)


def test_ops_steps_refuse_other_devices():
    """On neither a CPU nor a CUDA tensor the step entry points raise (no
    fallback)."""
    nb, n, m, L = 2, 8, 4, 3
    meta = lambda *shape: torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.gamp_step(meta(nb, n), meta(nb, n), meta(nb, m), meta(nb, 1 + 3 * L),
                       meta(nb, m), meta(nb, 1), meta(m, n))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.qgamp_step(meta(nb, n), meta(nb, n), meta(nb, m), meta(nb, 1 + 3 * L),
                        torch.empty((nb, m), dtype=torch.int32, device="meta"), meta(nb, 1),
                        meta(8), meta(8), meta(m, n))
