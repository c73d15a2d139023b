"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when
there is no card (decided inside the fixture, never at import, so every
pytest worker collects the same tests).  On a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

Tolerances, each with its reason:
  * encoder: resid and the kept set are bit-identical (the bisection is the
    same fp32 arithmetic); alpha to rtol 1e-6 and a differing code only on a
    lane whose y lies within 1e-5 of a threshold (sums in another order).
  * one GAMP step: allclose rtol 1e-3 / atol 1e-5 (the reference's own
    kernel-vs-oracle tolerance; products and row sums in another order,
    CUDA erfcf/expf a few ulps from PyTorch's).
  * 25-step drivers: NMSE <= 1e-4 against the plain drivers (the
    DESIGN.md #Kernels contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compression import packed_width, unpack_codes  # noqa: E402
from repro_torch.core.gamp import tau_tables  # noqa: E402
from repro_torch.core.quantizer import design_lloyd_max  # noqa: E402
from repro_torch.kernels import gm_prior, ops, ref  # noqa: E402
from repro_torch.kernels.bqcs_encode_fused import bqcs_encode_fused  # noqa: E402
from repro_torch.kernels.gamp_step import gamp_step  # noqa: E402
from repro_torch.kernels.qgamp_step import qgamp_step  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _nmse(x, ref_):
    return float(torch.sum((x - ref_) ** 2) / torch.clamp(torch.sum(ref_**2), min=1e-30))


def _encode_inputs(nb, n, m, q, seed, dev):
    rng = np.random.default_rng(seed)
    blocks = rng.normal(0, 0.1, (nb, n)).astype(np.float32)
    blocks[0] = 0.0  # a dead row
    resid = rng.normal(0, 0.02, (nb, n)).astype(np.float32)
    resid[0] = 0.0
    a = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    taus = design_lloyd_max(q).thresholds.astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=dev)
    return t(blocks), t(resid), t(a), t(taus)


def check_encoder(blocks, residual, a, taus, s, bits):
    """Kernel vs plain version on the same CUDA inputs; returns the count of
    differing code lanes (each within 1e-5 of a threshold)."""
    m = a.shape[0]
    a_t = ops.encoder_a_t(a, bits)
    words, alpha, resid = bqcs_encode_fused(blocks, residual, a_t, taus, s, m, bits)
    w_r, al_r, res_r = ref.bqcs_encode_fused_ref(blocks, residual, a.T.contiguous(), taus, s, bits)
    torch.cuda.synchronize()
    assert torch.equal(resid, res_r)
    torch.testing.assert_close(alpha, al_r, rtol=1e-6, atol=0.0)
    codes, codes_r = unpack_codes(words, bits, m), unpack_codes(w_r, bits, m)
    diff = codes != codes_r
    if diff.any():
        sparse, _ = ref.block_topk_ref(blocks + residual, s)
        y = (sparse * al_r[:, None]) @ a.T
        gap = torch.amin(torch.abs(y[..., None] - taus), dim=-1)
        assert float(gap[diff].max()) < 1e-5
    # pad lanes past M carry code 0
    assert not unpack_codes(words, bits, words.shape[1] * (32 // bits))[:, m:].any()
    return int(diff.sum())


@pytest.mark.parametrize("q", [1, 2, 3, 4, 8])
def test_encoder_small_shapes(cuda, q):
    blocks, resid, a, taus = _encode_inputs(37, 300, 97, q, seed=q, dev=cuda)
    check_encoder(blocks, resid, a, taus, s=30, bits=q)


def test_encoder_main_path_shape(cuda):
    blocks, resid, a, taus = _encode_inputs(300, 1591, 530, 3, seed=0, dev=cuda)
    check_encoder(blocks, resid, a, taus, s=159, bits=3)


def _gamp_state(nb, n, m, L, seed, dev):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    ghat = t(rng.normal(0, 0.1, (nb, n)))
    nug = t(rng.uniform(0.01, 0.1, (nb, n)))
    shat = t(rng.normal(0, 0.1, (nb, m)))
    theta = t(np.concatenate([
        np.full((nb, 1), 0.9), np.full((nb, L), 0.1 / L),
        rng.normal(0, 0.1, (nb, L)), np.full((nb, L), 0.01)], axis=1))
    a = t(rng.standard_normal((m, n)) / np.sqrt(m))
    return rng, ghat, nug, shat, theta, a


# nb >= 263 gives 2 rows per block on a 132-SM H100 (an odd nb leaves a
# ragged last block); smaller nb gives 1
@pytest.mark.parametrize("nb,n,m,q", [
    (8, 256, 64, 3), (13, 300, 100, 2), (37, 512, 171, 4), (300, 1591, 530, 3),
    (301, 256, 85, 3),
])
@pytest.mark.parametrize("packed", [True, False])
def test_qgamp_step_matches_plain(cuda, nb, n, m, q, packed):
    L = 3
    rng, ghat, nug, shat, theta, a = _gamp_state(nb, n, m, L, nb + q, cuda)
    alpha = torch.as_tensor(rng.uniform(0.8, 1.25, (nb, 1)).astype(np.float32), device=cuda)
    x = alpha * (ghat @ a.T) + torch.as_tensor(
        rng.normal(0, 0.1, (nb, m)).astype(np.float32), device=cuda)
    taus = torch.as_tensor(design_lloyd_max(q).thresholds.astype(np.float32), device=cuda)
    codes = torch.searchsorted(taus, x.contiguous()).to(torch.int32)
    lo, hi = tau_tables(taus)
    if packed:
        from repro_torch.core.compression import pack_codes

        obs, bits = pack_codes(codes, q), q
        assert obs.shape[1] == packed_width(m, q)
    else:
        obs, bits = codes, 0
    out_k = qgamp_step(ghat, nug, shat, theta, obs, alpha, lo, hi, a, L, True, bits)
    out_r = ref.qgamp_step_ref(ghat, nug, shat, theta, codes, alpha, lo, hi, a, L, True)
    for k, r in zip(out_k, out_r):
        torch.testing.assert_close(k, r, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("nb,n,m", [(8, 256, 64), (10, 1591, 530), (301, 300, 100)])
def test_gamp_step_matches_plain(cuda, nb, n, m):
    L = 3
    rng, ghat, nug, shat, theta, a = _gamp_state(nb, n, m, L, nb, cuda)
    y = torch.as_tensor(rng.normal(0, 1, (nb, m)).astype(np.float32), device=cuda)
    nud = torch.full((nb, 1), 0.05, device=cuda)
    out_k = gamp_step(ghat, nug, shat, theta, y, nud, a, L, True)
    out_r = ref.gamp_step_ref(ghat, nug, shat, theta, y, nud, a, L, True)
    for k, r in zip(out_k, out_r):
        torch.testing.assert_close(k, r, rtol=2e-4, atol=1e-6)


def _plain_ea_run(words, alpha, a, taus, bits, m, iters):
    """The EA driver with every step on the plain version (CUDA tensors)."""
    n = a.shape[1]
    lo, hi = tau_tables(taus)
    alive = alpha > 0
    safe = torch.where(alive, alpha, torch.ones_like(alpha))
    init_var = torch.where(alive, m / (n * safe * safe), torch.ones_like(alpha))
    theta = gm_prior.pack_init_theta(alpha.shape[0], 3, init_var, 0.9)
    ghat = torch.zeros((alpha.shape[0], n), device=a.device)
    nug = torch.clamp(init_var, min=1e-12)[:, None].expand_as(ghat).contiguous()
    shat = torch.zeros((alpha.shape[0], m), device=a.device)
    codes = unpack_codes(words, bits, m)
    for _ in range(iters):
        ghat, nug, shat, theta = ref.qgamp_step_ref(
            ghat, nug, shat, theta, codes, safe[:, None], lo, hi, a)
    return torch.where(alive[:, None], ghat, torch.zeros_like(ghat))


def test_ea_driver_nmse(cuda):
    """25 launches of qgamp_step vs 25 plain steps on the same words,
    including a dead row: NMSE <= 1e-4 and the dead row exactly zero."""
    nb, n, m, q, s = 40, 1591, 530, 3, 159
    blocks, resid, a, taus = _encode_inputs(nb, n, m, q, seed=3, dev=cuda)
    words, alpha, _ = bqcs_encode_fused(blocks, resid, ops.encoder_a_t(a, q), taus, s, m, q)
    ghat_k = ops.qgamp_ea_run_packed(words, alpha, a, taus, bits=q, m=m)
    ghat_r = _plain_ea_run(words, alpha, a, taus, q, m, 25)
    # the driver's norm guard only clips diverged rows; compare before it
    assert float(alpha[0]) == 0.0 and not bool(ghat_k[0].any())
    assert _nmse(ghat_k, ghat_r) <= 1e-4


def test_ae_driver_nmse(cuda):
    nb, n, m = 10, 1591, 530
    rng, ghat, _, _, _, a = _gamp_state(nb, n, m, 3, 11, cuda)
    g = torch.where(torch.rand((nb, n), device=cuda) < 0.1, ghat, torch.zeros_like(ghat))
    y = g @ a.T + 0.01 * torch.randn((nb, m), device=cuda)
    nu = torch.full((nb,), 1e-4, device=cuda)
    init_var = torch.sum(g * g, dim=1) / n
    out_k = ops.gamp_ae_run(y, nu, a, init_var)
    ghat_p, nug, shat = (torch.zeros((nb, n), device=cuda),
                         torch.clamp(init_var, min=1e-12)[:, None].expand(nb, n).contiguous(),
                         torch.zeros((nb, m), device=cuda))
    theta = gm_prior.pack_init_theta(nb, 3, init_var, 0.9)
    for _ in range(25):
        ghat_p, nug, shat, theta = ref.gamp_step_ref(ghat_p, nug, shat, theta, y, nu[:, None], a)
    from repro_torch.core.gamp import norm_guard

    out_r = norm_guard(ghat_p, torch.sqrt(init_var * n))
    assert _nmse(out_k, out_r) <= 1e-4


@pytest.mark.parametrize("method", ["fedqcs-ae", "fedqcs-ea"])
def test_round_on_the_card(cuda, method):
    from repro_torch.paper.mlp import run_federated

    res = run_federated(method, steps=1, device="cuda")
    assert len(res.nmses) == 1 and np.isfinite(res.nmses[0]) and res.nmses[0] < 1.0
    assert 0.0 <= res.accs[0] <= 1.0
