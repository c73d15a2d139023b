"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when
there is no card (decided inside the fixture, never at import, so every
pytest worker collects the same tests).  On a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

Tolerances, each with its reason:
  * encoder: resid and the kept set are bit-identical (the bisection is the
    same fp32 arithmetic); alpha to rtol 1e-6 and a differing code only on a
    lane whose y lies within 1e-5 of a threshold (sums in another order).
  * one GAMP step: allclose rtol 1e-3 / atol 1e-5 for qgamp_step, rtol 2e-4
    / atol 1e-6 for gamp_step (the reference's own kernel-vs-oracle
    tolerances; products and row sums in another order, CUDA erfcf/expf a
    few ulps from PyTorch's); both kernels at every (rows, cluster) shape,
    and bit-identical from one launch to the next (no atomics).
  * 25-step drivers: NMSE <= 1e-4 against the plain drivers (the
    DESIGN.md #Kernels contract).
  * the encoder's dither and vq branches: as the scalar branch; a vq code
    may differ only where its two candidate centroid scores lie within
    1e-5 of each other.  block_topk: bit-identical.  Both at several
    bisection depths, since the bisection runs in passes of kLevels levels
    and the last pass is shorter where kLevels does not divide the depth.
  * bqcs_encode (staged): alpha rtol 1e-6, codes as the encoder's, at every
    cluster size, and bit-identical from one launch to the next (the
    cluster adds its partial tiles in rank order, no atomics).
  * the train step's shapes (N = 255, 65,536 rows): the step kernels at the
    tolerances above against the float64 step (two fp32 evaluations part
    on a few of 5.6M outputs); one smoke-config step per impl on the card
    against the CPU: loss 1e-5, residual 1e-5, parameters within 2 lr (on
    one device, and as the (2, 2, 2) mesh's eight ranks on the card against
    the same world on the CPU).
  * the threefry draws (``repro_torch.prng``): bits, integers, keys and
    permutations bit-identical to the CPU's; the normal, exponential and
    Gumbel transforms on all 2**23 inputs and ``init_params``' leaves
    bit-identical too (a bound of 0 ulp).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compression import packed_width, unpack_codes  # noqa: E402
from repro_torch.core.gamp import tau_tables  # noqa: E402
from repro_torch.core.quantizer import design_lloyd_max  # noqa: E402
from repro_torch.kernels import gm_prior, ops, ref  # noqa: E402
from repro_torch.kernels.bqcs_encode import CLUSTERS as STAGED_CLUSTERS  # noqa: E402
from repro_torch.kernels.bqcs_encode_fused import BISECT_ITERS, bqcs_encode_fused  # noqa: E402
from repro_torch.kernels.gamp_step import CLUSTERS as GAMP_CLUSTERS  # noqa: E402
from repro_torch.kernels.gamp_step import ROWS as GAMP_ROWS  # noqa: E402
from repro_torch.kernels.gamp_step import gamp_step  # noqa: E402
from repro_torch.kernels.qgamp_step import qgamp_step  # noqa: E402

pytestmark = pytest.mark.gpu

# bisection depths for the top-S cases: 0 (the row max only), 1, 7 and 30,
# which the pass size kLevels does not divide, and the paths' 26
BISECT_CASES = [0, 1, 7, BISECT_ITERS, 30]


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
    a_t = ops.encoder_a_t(a, _codebook("lloyd_max", 3 * m, bits))
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


# the per-tensor layout's launches: one pass over 30 clients x 13 rows, and
# a one-row segment of 30 clients at S and at a bias budget of s = 79
@pytest.mark.parametrize("nb,s", [(390, 159), (30, 159), (30, 79)])
def test_encoder_layout_shapes(cuda, nb, s):
    blocks, resid, a, taus = _encode_inputs(nb, 1591, 530, 3, seed=nb + s, dev=cuda)
    check_encoder(blocks, resid, a, taus, s=s, bits=3)


def test_encoder_train_step_shape(cuda):
    """The train step's encode: N = 255 (odd), M = 85, Q = 3 (W = 9 words),
    S = 12, on 65,536 rows."""
    blocks, resid, a, taus = _encode_inputs(65536, 255, 85, 3, seed=7, dev=cuda)
    check_encoder(blocks, resid, a, taus, s=12, bits=3)


def test_encoder_segments_match_one_pass(cuda):
    """Each block row is its own CTA: launches over the segments' rows (30,
    300 and 60 of 390) give the one-pass launch's words, alphas and
    residuals bit for bit."""
    blocks, resid, a, taus = _encode_inputs(390, 1591, 530, 3, seed=5, dev=cuda)
    a_t = ops.encoder_a_t(a, _codebook("lloyd_max", 1590, 3))
    one = bqcs_encode_fused(blocks, resid, a_t, taus, 159, 530, 3)
    parts = [bqcs_encode_fused(blocks[lo:hi].contiguous(), resid[lo:hi].contiguous(), a_t, taus,
                               159, 530, 3) for lo, hi in ((0, 30), (30, 330), (330, 390))]
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts]), one[i])


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


# every (rows per tile, blocks per cluster) the kernel takes, and the
# chooser's own pick (None, None); N = 1591, 300, 512 and 256 split unevenly
# over some cluster sizes > 1, and nb = 301 leaves a ragged last tile
@pytest.mark.parametrize("rows,cluster", [(None, None)] + [
    (r, c) for r in GAMP_ROWS for c in GAMP_CLUSTERS])
@pytest.mark.parametrize("nb,n,m,q,em", [
    (8, 256, 64, 3, True), (13, 300, 100, 2, True), (37, 512, 171, 4, True),
    (300, 1591, 530, 3, True), (301, 256, 85, 3, True), (300, 1591, 530, 3, False),
    (80, 1591, 530, 3, True),  # one fold of the streamed EA decode (8 clients x 10 blocks)
    # the per-tensor layout (13 rows a client): the one-pass EA decode (a
    # partial last tile of 4 rows), a segment-local decode, a streamed fold
    (390, 1591, 530, 3, True), (30, 1591, 530, 3, True), (104, 1591, 530, 3, True),
])
@pytest.mark.parametrize("packed", [True, False])
def test_qgamp_step_matches_plain(cuda, nb, n, m, q, em, packed, rows, cluster):
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
    args = (ghat, nug, shat, theta, obs, alpha, lo, hi, a, L, em, bits)
    out_k = qgamp_step(*args, _rows=rows, _cluster=cluster)
    out_r = ref.qgamp_step_ref(ghat, nug, shat, theta, codes, alpha, lo, hi, a, L, em)
    for k, r in zip(out_k, out_r):
        torch.testing.assert_close(k, r, rtol=1e-3, atol=1e-5)
    # no atomics: a second launch gives the same bits
    again = qgamp_step(*args, _rows=rows, _cluster=cluster)
    assert all(torch.equal(k, k2) for k, k2 in zip(out_k, again))


@pytest.mark.parametrize("rows,cluster", [(3, 1), (1, 3), (1, 32)])
def test_qgamp_step_refused_shape_raises(cuda, rows, cluster):
    """A shape the kernel does not take raises; nothing falls back."""
    rng, ghat, nug, shat, theta, a = _gamp_state(10, 300, 100, 3, 0, cuda)
    codes = torch.zeros((10, 100), dtype=torch.int32, device=cuda)
    alpha = torch.ones((10, 1), device=cuda)
    lo, hi = tau_tables(torch.as_tensor(design_lloyd_max(3).thresholds.astype(np.float32),
                                        device=cuda))
    with pytest.raises(RuntimeError, match="qgamp_step_launch failed"):
        qgamp_step(ghat, nug, shat, theta, codes, alpha, lo, hi, a, 3, True, 0,
                   _rows=rows, _cluster=cluster)


# every (rows per tile, blocks per cluster) the kernel takes, and the
# chooser's own pick (None, None); N = 1591 and 300 split unevenly over
# every cluster size > 1
@pytest.mark.parametrize("rows,cluster", [(None, None)] + [
    (r, c) for r in GAMP_ROWS for c in GAMP_CLUSTERS])
@pytest.mark.parametrize("nb,n,m,L,em", [
    (8, 256, 64, 3, True), (10, 1591, 530, 3, True), (301, 300, 100, 3, True),
    (1, 1591, 530, 3, True), (300, 1591, 530, 3, True), (10, 300, 100, 1, True),
    (10, 300, 100, 8, True), (10, 1591, 530, 3, False),
    (30, 1591, 530, 3, True), (100, 1591, 530, 3, True),  # the AE decode at G = 3 and 10
    (13, 1591, 530, 3, True),  # the per-tensor AE decode
])
def test_gamp_step_matches_plain(cuda, nb, n, m, L, em, rows, cluster):
    rng, ghat, nug, shat, theta, a = _gamp_state(nb, n, m, L, nb + L, cuda)
    y = torch.as_tensor(rng.normal(0, 1, (nb, m)).astype(np.float32), device=cuda)
    nud = torch.full((nb, 1), 0.05, device=cuda)
    out_k = gamp_step(ghat, nug, shat, theta, y, nud, a, L, em, _rows=rows, _cluster=cluster)
    out_r = ref.gamp_step_ref(ghat, nug, shat, theta, y, nud, a, L, em)
    for k, r in zip(out_k, out_r):
        torch.testing.assert_close(k, r, rtol=2e-4, atol=1e-6)
    # no atomics: a second launch gives the same bits
    again = gamp_step(ghat, nug, shat, theta, y, nud, a, L, em, _rows=rows, _cluster=cluster)
    assert all(torch.equal(k, k2) for k, k2 in zip(out_k, again))


@pytest.mark.parametrize("rows,cluster", [(3, 1), (1, 3), (1, 32)])
def test_gamp_step_refused_shape_raises(cuda, rows, cluster):
    """A shape the kernel does not take raises; nothing falls back."""
    rng, ghat, nug, shat, theta, a = _gamp_state(10, 300, 100, 3, 0, cuda)
    y = torch.zeros((10, 100), device=cuda)
    nud = torch.full((10, 1), 0.05, device=cuda)
    with pytest.raises(RuntimeError, match="gamp_step_launch failed"):
        gamp_step(ghat, nug, shat, theta, y, nud, a, 3, True, _rows=rows, _cluster=cluster)


# The train step's decodes (N = 255, M = 85, Q = 3 -> W = 9): 65,536 of
# their millions of rows, which the chooser tiles as it tiles them all
# (4 x 1).  Each output is held at the tolerance above against the plain
# step evaluated in float64, at every (rows per tile, cluster): at 5.6M
# outputs, two fp32 evaluations -- the kernel and the plain step, each
# summing in its own order -- part past rtol 2e-4 / atol 1e-6 on 1-2
# elements of gamp_step's shat (no element of either is outside it against
# float64; PERF.md §6), so the exact step is the reference here; the
# plain fp32 step is held to it too.
@pytest.mark.parametrize("rows,cluster", [(None, None)] + [
    (r, c) for r in GAMP_ROWS for c in GAMP_CLUSTERS])
@pytest.mark.parametrize("kind", ["gamp", "qgamp"])
def test_step_kernels_at_the_train_step_shape(cuda, kind, rows, cluster):
    nb, n, m, L, q = 65536, 255, 85, 3, 3
    rng, ghat, nug, shat, theta, a = _gamp_state(nb, n, m, L, nb + (L if kind == "gamp" else q),
                                                 cuda)
    d = lambda x: x.double()  # noqa: E731
    if kind == "gamp":
        y = torch.as_tensor(rng.normal(0, 1, (nb, m)).astype(np.float32), device=cuda)
        nud = torch.full((nb, 1), 0.05, device=cuda)
        out_k = gamp_step(ghat, nug, shat, theta, y, nud, a, L, True, _rows=rows,
                          _cluster=cluster)
        out_p = ref.gamp_step_ref(ghat, nug, shat, theta, y, nud, a, L, True)
        exact = ref.gamp_step_ref(d(ghat), d(nug), d(shat), d(theta), d(y), d(nud), d(a), L, True)
        rtol, atol = 2e-4, 1e-6
    else:
        from repro_torch.core.compression import pack_codes

        alpha = torch.as_tensor(rng.uniform(0.8, 1.25, (nb, 1)).astype(np.float32), device=cuda)
        x = alpha * (ghat @ a.T) + torch.as_tensor(
            rng.normal(0, 0.1, (nb, m)).astype(np.float32), device=cuda)
        taus = torch.as_tensor(design_lloyd_max(q).thresholds.astype(np.float32), device=cuda)
        codes = torch.searchsorted(taus, x.contiguous()).to(torch.int32)
        lo, hi = tau_tables(taus)
        out_k = qgamp_step(ghat, nug, shat, theta, pack_codes(codes, q), alpha, lo, hi, a, L,
                           True, q, _rows=rows, _cluster=cluster)
        out_p = ref.qgamp_step_ref(ghat, nug, shat, theta, codes, alpha, lo, hi, a, L, True)
        exact = ref.qgamp_step_ref(d(ghat), d(nug), d(shat), d(theta), codes, d(alpha), d(lo),
                                   d(hi), d(a), L, True)
        rtol, atol = 1e-3, 1e-5
    for k, p, e in zip(out_k, out_p, exact):
        torch.testing.assert_close(k.double(), e, rtol=rtol, atol=atol)
        torch.testing.assert_close(p.double(), e, rtol=rtol, atol=atol)


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
    a_t = ops.encoder_a_t(a, _codebook("lloyd_max", n, q))
    words, alpha, _ = bqcs_encode_fused(blocks, resid, a_t, taus, s, m, q)
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


# -- slice 2: the encoder's dither and vq branches, the staged encoder ----------


@functools.lru_cache(maxsize=None)
def _codebook(family, n, bits, vq_dim=2):
    from repro_torch.core.codebook import make_codebook
    from repro_torch.core.compression import FedQCSConfig

    return make_codebook(FedQCSConfig(block_size=n, reduction_ratio=3, bits=bits,
                                      codebook=family, vq_dim=vq_dim))


def _vq_score_gap(y, cb, codes_a, codes_b):
    """|score(code_a) - score(code_b)| of each lane, scored on the same y."""
    c = cb.centroids_t(y.device)
    n_lev, d = c.shape
    y3 = y.reshape(y.shape[0], d, -1)
    sc = torch.einsum("rjg,lj->rgl", y3, c) - cb.half_norms_t(y.device)
    pick = lambda codes: torch.gather(sc, 2, codes.long()[..., None])[..., 0]
    return torch.abs(pick(codes_a) - pick(codes_b))


def check_encoder_family(blocks, residual, a, cb, s, iters=BISECT_ITERS):
    """Fused kernel vs its plain version for any codebook family; returns
    the count of differing code lanes (each within 1e-5 of a decision)."""
    m = a.shape[0]
    a_t = ops.encoder_a_t(a, cb)
    tables = ops.encoder_tables(cb, m, a.device)
    dither = None if tables.dither is None else tables.dither[:m]
    words, alpha, resid = bqcs_encode_fused(blocks, residual, a_t, tables.tab, s, m, cb.bits,
                                            iters, dither=tables.dither,
                                            half_norms=tables.half_norms)
    if cb.dim > 1:
        w_r, al_r, res_r = ref.bqcs_encode_fused_ref(
            blocks, residual, a_t, None, s, cb.bits, iters, centroids=tables.tab,
            half_norms=tables.half_norms)
    else:
        w_r, al_r, res_r = ref.bqcs_encode_fused_ref(
            blocks, residual, a.T.contiguous(), tables.tab, s, cb.bits, iters, dither=dither)
    torch.cuda.synchronize()
    assert torch.equal(resid, res_r)
    torch.testing.assert_close(alpha, al_r, rtol=1e-6, atol=0.0)
    lanes = cb.n_codes(m)
    assert words.shape == w_r.shape == (blocks.shape[0], packed_width(lanes, cb.bits))
    codes, codes_r = unpack_codes(words, cb.bits, lanes), unpack_codes(w_r, cb.bits, lanes)
    diff = codes != codes_r
    if diff.any():
        sparse, _ = ref.block_topk_ref(blocks + residual, s, iters)
        y = (sparse * al_r[:, None]) @ a.T
        if cb.dim > 1:
            gap = _vq_score_gap(y, cb, codes, codes_r)
        else:
            yd = y if dither is None else y + dither
            gap = torch.amin(torch.abs(yd[..., None] - tables.tab), dim=-1)
        assert float(gap[diff].max()) < 1e-5
    full = unpack_codes(words, cb.bits, words.shape[1] * (32 // cb.bits))
    assert not full[:, lanes:].any()
    return int(diff.sum())


@pytest.mark.parametrize("family,n,bits,vq_dim", [
    ("dithered_uniform", 300, 3, 2), ("dithered_uniform", 256, 4, 2),
    ("dithered_uniform", 1591, 3, 2),
    ("vq", 258, 3, 2), ("vq", 300, 4, 2), ("vq", 240, 3, 4), ("vq", 1591, 3, 2),
])
def test_encoder_dither_and_vq_branches(cuda, family, n, bits, vq_dim):
    m = n // 3
    nb = 300 if n == 1591 else 37
    blocks, resid, a, _ = _encode_inputs(nb, n, m, bits, seed=n + bits, dev=cuda)
    check_encoder_family(blocks, resid, a, _codebook(family, n, bits, vq_dim), max(1, n // 10))


def _tied_rows(blocks, resid):
    """Rows 1-3 of blocks + resid: four entries tied at the row max; a third
    of the row tied at the row max, so more than S entries are kept and the
    warps' slices of the kept list are uneven; magnitudes 1 ulp apart."""
    resid[1:4] = 0.0
    top = float(blocks[1:3].abs().max()) + 0.01
    blocks[1, 0:4:2], blocks[1, 1:4:2] = top, -top
    blocks[2, ::3] = top
    n = blocks.shape[1]
    ulp = 1.0 + torch.arange(n, device=blocks.device, dtype=torch.float32) * 2.0**-23
    blocks[3] = torch.where(torch.arange(n, device=blocks.device) % 2 == 0, ulp, -ulp)
    return blocks, resid


@pytest.mark.parametrize("iters", BISECT_CASES)
@pytest.mark.parametrize("nb,n,s", [(37, 300, 30), (300, 1591, 159), (5, 7000, 700),
                                    (37, 300, 300), (37, 300, 301)])
def test_block_topk_bit_identical(cuda, nb, n, s, iters):
    from repro_torch.kernels.block_topk import block_topk

    blocks, resid, _, _ = _encode_inputs(nb, n, 3, 3, seed=nb, dev=cuda)
    blocks, resid = _tied_rows(blocks, resid)
    x = blocks + resid
    sparse, res = block_topk(x, s, iters)
    sp_r, res_r = ref.block_topk_ref(x, s, iters)
    torch.cuda.synchronize()
    assert torch.equal(sparse, sp_r) and torch.equal(res, res_r)


# the bisection's passes at iters that kLevels divides and that it does not
# (a shorter last pass), the tied rows above, S >= N (every entry kept), and
# N = 7002 (the encoder's shared memory above 48 KB, A^T wider than one
# projection chunk; M = N / 3 even, as vq's d = 2 needs)
@pytest.mark.parametrize("family", ["lloyd_max", "dithered_uniform", "vq"])
@pytest.mark.parametrize("nb,n,s,iters", [(300, 1591, 159, it) for it in BISECT_CASES] + [
    (37, 300, 300, BISECT_ITERS), (37, 300, 301, BISECT_ITERS), (5, 7002, 700, BISECT_ITERS)])
def test_encoder_bisection_passes_and_wide_rows(cuda, family, nb, n, s, iters):
    blocks, resid, a, _ = _encode_inputs(nb, n, n // 3, 3, seed=n + iters, dev=cuda)
    blocks, resid = _tied_rows(blocks, resid)
    check_encoder_family(blocks, resid, a, _codebook(family, n, 3), s, iters)


# every cluster size the kernel takes, and the chooser's own pick (None);
# nb = 301 and 37 leave a ragged last row tile, m = 530, 100, 65 and 1 a
# ragged column tile, and N = 33, 40 and 288 leave the last ranks of a
# cluster of 4 or 8 without a K step (empty K ranges)
@pytest.mark.parametrize("cluster", (None,) + STAGED_CLUSTERS)
@pytest.mark.parametrize("nb,n,m,q", [
    (37, 300, 100, 3), (300, 1591, 530, 3), (19, 129, 65, 2), (301, 1591, 530, 3),
    (1, 7002, 2334, 3), (5, 33, 1, 3), (9, 40, 70, 2), (9, 288, 70, 3),
])
def test_staged_encode_matches_plain(cuda, nb, n, m, q, cluster):
    from repro_torch.kernels.bqcs_encode import bqcs_encode

    blocks, _, a, taus = _encode_inputs(nb, n, m, q, seed=m, dev=cuda)
    if nb == 1:  # one live row (the inputs' row 0 is dead)
        rng = np.random.default_rng(n)
        blocks = torch.as_tensor(rng.normal(0, 0.1, (1, n)).astype(np.float32), device=cuda)
    a_t = a.T.contiguous()
    codes, alpha = bqcs_encode(blocks, a_t, taus, _cluster=cluster)
    codes_r, alpha_r = ref.bqcs_encode_ref(blocks, a_t, taus)
    torch.cuda.synchronize()
    torch.testing.assert_close(alpha, alpha_r, rtol=1e-6, atol=0.0)
    assert nb == 1 or float(alpha[0]) == 0.0
    diff = codes != codes_r
    if diff.any():
        y = (blocks * alpha_r[:, None]) @ a_t
        gap = torch.amin(torch.abs(y[..., None] - taus), dim=-1)
        assert float(gap[diff].max()) < 1e-5
    # no atomics: a second launch gives the same bits
    codes2, alpha2 = bqcs_encode(blocks, a_t, taus, _cluster=cluster)
    assert torch.equal(codes, codes2) and torch.equal(alpha, alpha2)


@pytest.mark.parametrize("cluster", [3, 16, 32])
def test_staged_encode_refused_shape_raises(cuda, cluster):
    """A shape the kernel does not take raises; nothing falls back."""
    from repro_torch.kernels.bqcs_encode import bqcs_encode

    blocks, _, a, taus = _encode_inputs(10, 300, 100, 3, seed=0, dev=cuda)
    with pytest.raises(RuntimeError, match="bqcs_encode_launch failed"):
        bqcs_encode(blocks, a.T.contiguous(), taus, _cluster=cluster)


def test_staged_path_matches_fused_wire(cuda):
    cb = _codebook("lloyd_max", 1591, 3)
    blocks, resid, a, taus = _encode_inputs(300, 1591, 530, 3, seed=8, dev=cuda)
    words_f, alpha_f, res_f = ops.bqcs_encode_fused(blocks, resid, a, cb, 159)
    sparse, res_s = ops.block_sparsify(blocks + resid, 159)
    codes_s, alpha_s = ops.bqcs_encode(sparse, a, cb)
    from repro_torch.core.compression import pack_codes

    words_s = pack_codes(codes_s, 3)
    torch.cuda.synchronize()
    assert torch.equal(res_s, res_f)
    torch.testing.assert_close(alpha_s, alpha_f, rtol=1e-6, atol=0.0)
    diff = unpack_codes(words_s, 3, 530) != unpack_codes(words_f, 3, 530)
    if diff.any():
        y = (sparse * alpha_f[:, None]) @ a.T
        gap = torch.amin(torch.abs(y[..., None] - taus), dim=-1)
        assert float(gap[diff].max()) < 1e-5


@pytest.mark.parametrize("family", ["dithered_uniform", "vq"])
@pytest.mark.parametrize("method", ["fedqcs-ae", "fedqcs-ea"])
def test_codebook_round_on_the_card(cuda, method, family):
    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.paper.mlp import run_federated

    cfg = FedQCSConfig(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=25, use_kernels=True,
                       gamp_variance_mode="scalar", codebook=family)
    res = run_federated(method, steps=1, device="cuda", fed_cfg=cfg)
    assert len(res.nmses) == 1 and np.isfinite(res.nmses[0]) and res.nmses[0] < 1.0
    assert res.bits_per_entry == {"vq": 0.5, "dithered_uniform": 1.0}[family]


def test_gamp_loop_on_the_card_matches_the_cpu(cuda):
    """The plain GAMP loop (exact variance, early freeze) on CUDA tensors
    against the same loop on the CPU: the same algorithm, sums in another
    order, so NMSE <= 1e-4 and iteration counts equal on >= 99% of blocks."""
    from repro_torch.core import gamp

    rng = np.random.default_rng(12)
    nb, n, m = 300, 384, 128
    a = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    g = np.where(rng.random((nb, n)) < 0.1, rng.normal(0, 0.1, (nb, n)), 0.0).astype(np.float32)
    y = g @ a.T + rng.normal(0, 0.01, (nb, m)).astype(np.float32)
    nu = np.full((nb,), 1e-4, np.float32)
    cfg = gamp.GampConfig(variance_mode="exact")
    outs = [gamp.em_gamp(torch.as_tensor(y, device=d), torch.as_tensor(nu, device=d),
                         torch.as_tensor(a, device=d), cfg, with_info=True)
            for d in (cuda, torch.device("cpu"))]
    (g_c, info_c), (g_p, info_p) = outs
    assert _nmse(g_c.cpu(), g_p) <= 1e-4
    assert float((info_c.iters.cpu() == info_p.iters).float().mean()) >= 0.99


# -- slice 7: the default (XLA-algorithm) route, the chunked and early-stop decode --------


def _xla_and_cpu_codecs(family, cuda, **kw):
    from repro_torch.core.compression import BQCSCodec, FedQCSConfig

    cfg = FedQCSConfig(block_size=1591, reduction_ratio=3, bits=3, s_ratio=0.1, codebook=family,
                       **kw)
    card = BQCSCodec(cfg, device=cuda)
    return card, BQCSCodec(cfg, a=card.a.cpu(), device="cpu")


@pytest.mark.parametrize("sparsifier", ["topk", "bisect"])
@pytest.mark.parametrize("family", ["lloyd_max", "dithered_uniform", "vq"])
def test_default_route_encode_matches_its_cpu_run(cuda, family, sparsifier):
    """The XLA-route encode (sort top-S or bisection, cuBLAS fp32 GEMM,
    searchsorted, pack) on the card against the same codec on the CPU: no
    kernel launches, resid bit-identical, alpha rtol 1e-6, a code differing
    only within 1e-5 of a decision (the GEMMs sum in other orders)."""
    from repro_torch.core import sensing
    from repro_torch.kernels import bqcs_encode_fused as enc_mod

    card, cpu = _xla_and_cpu_codecs(family, cuda, sparsifier=sparsifier)
    blocks, resid, _, _ = _encode_inputs(300, 1591, 530, 3, seed=21, dev=cuda)
    n0 = enc_mod.launches
    words, alpha, res = card.compress_blocks_packed(blocks, resid)
    torch.cuda.synchronize()
    assert enc_mod.launches == n0
    words_c, alpha_c, res_c = cpu.compress_blocks_packed(blocks.cpu(), resid.cpu())
    assert torch.equal(res.cpu(), res_c)
    torch.testing.assert_close(alpha.cpu(), alpha_c, rtol=1e-6, atol=0.0)
    codes, codes_c = card.unpack(words), card.unpack(words_c.to(cuda))
    diff = codes != codes_c
    if diff.any():
        y, _ = sensing.project_blocks(blocks + resid - res, card.a.T)
        cb = card.codebook
        if cb.dim > 1:
            gap = _vq_score_gap(y, cb, codes, codes_c)
        else:
            yd = y if cb.dither is None else y + cb.dither_t(cuda)
            gap = torch.amin(torch.abs(yd[..., None] - cb.thresholds_t(cuda)), dim=-1)
        assert float(gap[diff].max()) < 1e-5


def _ea_payload(family, cuda, seed=4):
    from repro_torch.core.compression import BQCSCodec, FedQCSConfig

    cfg = FedQCSConfig(block_size=1591, reduction_ratio=3, bits=3, s_ratio=0.1, codebook=family,
                       use_kernels=True, gamp_variance_mode="scalar")
    codec = BQCSCodec(cfg, device=cuda)
    blocks, resid, _, _ = _encode_inputs(300, 1591, 530, 3, seed=seed, dev=cuda)
    words, alpha, _ = codec.compress_blocks_packed(blocks, resid)
    rhos = torch.full((30,), 1.0 / 30, device=cuda)
    return codec, words.reshape(30, 10, -1), alpha.reshape(30, 10), rhos


@pytest.mark.parametrize("family,kernel", [("lloyd_max", "qgamp_step"), ("vq", "gamp_step")])
def test_chunked_kernel_ea_matches_unchunked(cuda, family, kernel):
    """recon_chunk=64 over 300 rows: 5 chunks, the last with 20 dead rows,
    25 step launches each; NMSE <= 1e-4 against the monolithic decode (the
    reference's chunked-vs-monolithic contract), dead row 0 exactly zero."""
    import importlib

    from repro_torch.core.recon_engine import ea_solve_flat
    from repro_torch.core.reconstruction import estimate_and_aggregate_packed, gamp_config_from

    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    codec, words, alpha, rhos = _ea_payload(family, cuda)
    mono = estimate_and_aggregate_packed(codec, words, alpha, rhos, chunk=0)
    n0 = mod.launches
    chunked = estimate_and_aggregate_packed(codec, words, alpha, rhos, chunk=64)
    torch.cuda.synchronize()
    assert mod.launches - n0 == 25 * 5
    assert _nmse(chunked, mono) <= 1e-4
    flat = ea_solve_flat(codec, words.reshape(300, -1), alpha.reshape(300),
                         gamp_config_from(codec), packed=True, use_kernels=True, chunk=64)
    assert not flat[0].any()


@pytest.mark.parametrize("variance", ["exact", "scalar"])
def test_early_stop_bit_identical_on_the_card(cuda, variance):
    from repro_torch.core.gamp import GampConfig
    from repro_torch.core.reconstruction import estimate_and_aggregate_packed

    codec, words, alpha, rhos = _ea_payload("lloyd_max", cuda, seed=6)
    cfg = GampConfig(iters=25, variance_mode=variance, tol=1e-2)
    fixed, info_f = estimate_and_aggregate_packed(codec, words, alpha, rhos, cfg,
                                                  use_kernels=False, chunk=64, with_info=True)
    early, info = estimate_and_aggregate_packed(
        codec, words, alpha, rhos, GampConfig(iters=25, variance_mode=variance, tol=1e-2,
                                              early_stop=True),
        use_kernels=True, chunk=64, with_info=True)  # early_stop keeps the plain loop
    torch.cuda.synchronize()
    assert torch.equal(early, fixed)
    assert torch.equal(info.iters, info_f.iters) and torch.equal(info.converged, info_f.converged)


def test_two_phase_on_the_card_matches_its_composition(cuda):
    """The two-phase sweep from the packed words on the card (its survivor
    gather reads uint32 rows) against its composition: the scalar pass,
    then the exact re-solve of the unconverged rows; NMSE <= 1e-6."""
    import dataclasses

    from repro_torch.core.gamp import GampConfig, _qem_gamp_xla
    from repro_torch.core.recon_engine import ea_decode_two_phase

    codec, words, alpha, rhos = _ea_payload("lloyd_max", cuda, seed=9)
    cfg = GampConfig(iters=25, variance_mode="scalar", tol=1e-3)
    out, stats = ea_decode_two_phase(codec, words, alpha, rhos, cfg, packed=True)
    codes, flat_a = codec.unpack(words.reshape(300, -1)), alpha.reshape(300)
    ghat, conv, _ = _qem_gamp_xla(codes, flat_a, codec.a, codec.codebook, cfg)
    surv = torch.nonzero(~conv).flatten()
    assert surv.numel() == stats["phase2_rows"] > 0
    exact = dataclasses.replace(cfg, variance_mode="exact")
    refined, _, _ = _qem_gamp_xla(codes[surv], flat_a[surv], codec.a, codec.codebook, exact)
    ghat = ghat.index_copy(0, surv, refined)
    assert _nmse(out, torch.einsum("k,kbn->bn", rhos, ghat.reshape(30, 10, -1))) <= 1e-6


# -- slice 8: the baselines and the noisy uplinks -------------------------------


@pytest.mark.parametrize("method", ["qcs-dither", "signsgd", "none"])
def test_baseline_round_on_the_card_matches_the_cpu(cuda, method):
    """One default-config baseline round on the card against the same round
    on the CPU (the same A, weights and draws): the decoded aggregate to
    NMSE <= 1e-3, and no kernel.  QIHT's round is chaotic in a near-tie at
    its thresholds; ``test_qiht_on_the_card_follows_the_cpu`` holds it."""
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.paper.mlp import run_federated

    enc_mod.launches = g_mod.launches = 0
    card = run_federated(method, steps=1, k_devices=10, device="cuda")
    assert enc_mod.launches == 0 and g_mod.launches == 0
    cpu = run_federated(method, steps=1, k_devices=10, device="cpu")
    assert _nmse(card.last_ghat.cpu(), cpu.last_ghat) <= 1e-3
    assert card.bits_per_entry == cpu.bits_per_entry


def test_qiht_on_the_card_follows_the_cpu(cuda):
    """QIHT (``baselines.qiht_step``, 50 iterations, 300 rows of the paper's
    width) on the card and on the CPU in lockstep from the same codes.  Its
    iterates are piecewise linear in rounding: they can part only where the
    two devices take different discrete branches -- a requantization code
    of Q(alpha A g), or an entry of the top-S.  Contract: up to and at the
    first such branch, alpha A g and the update agree to 1e-4 of their max,
    and every flipped item lies within its row's largest card-vs-CPU
    difference of its decision (twice that for the top-S, whose threshold
    moves too): a near-tie that rounding decides."""
    from repro_torch.core.baselines import qiht_step
    from repro_torch.core.compression import BQCSCodec, FedQCSConfig

    codec = BQCSCodec(FedQCSConfig(block_size=1591, reduction_ratio=3, bits=3, s_ratio=0.1),
                      device="cpu")
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.standard_t(3, (300, 1591)).astype(np.float32) * 0.01)
    codes, alpha, _ = codec.compress_blocks(g, torch.zeros_like(g))
    s, m, cb = codec.cfg.s, codec.cfg.m, codec.codebook
    taus = torch.as_tensor(cb.thresholds, dtype=torch.float32)
    sides = [[torch.zeros_like(g).to(d), cb.decode(codes.to(d), m), codec.a.to(d),
              alpha[:, None].to(d)] for d in ("cuda", "cpu")]

    def agree(x, ref):  # -> each row's largest card-vs-CPU difference
        diff = torch.abs(x - ref)
        assert float(diff.max()) <= 1e-4 * float(torch.abs(ref).max())
        return diff.amax(dim=1, keepdim=True)

    for _ in range(50):
        xa, pre = [], []
        for side in sides:
            xa.append((side[3] * (side[0] @ side[2].T)).cpu())
            p, side[0] = qiht_step(side[0], side[1], side[2], side[3], cb, s)
            pre.append(p.cpu())
        row = agree(xa[0], xa[1])
        flips = cb.encode(xa[0]) != cb.encode(xa[1])
        if flips.any():
            gap = torch.amin(torch.abs(xa[1][..., None] - taus), dim=-1)
            assert bool((gap <= row)[flips].all())
            break
        row = agree(pre[0], pre[1])
        flips = (sides[0][0].cpu() != 0) != (sides[1][0] != 0)
        if flips.any():
            mag = torch.abs(pre[1])
            tau = torch.sort(mag, dim=1, descending=True).values[:, s - 1:s]
            assert bool((torch.abs(mag - tau) <= 2 * row)[flips].all())
            break


@pytest.mark.parametrize("kw", [
    dict(channel="awgn", snr_db=20.0),
    dict(channel="rayleigh", snr_db=20.0),
    dict(channel="mimo_mac", n_rx=8),
    dict(channel="mimo_mac", combiner="zf", n_rx=32, csi_error=0.01),
], ids=["awgn", "rayleigh", "mimo_mac-lmmse", "mimo_mac-zf"])
def test_noisy_channel_ae_round_kernels_match_plain(cuda, kw):
    """fedqcs-ae on the kernel route over each noisy uplink: the fused
    encoder once and gamp_step 25 times, and the decoded aggregate within
    NMSE 1e-3 of the same round with the plain versions (on the CPU, the
    same draws)."""
    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.paper.mlp import run_federated

    cfg = FedQCSConfig(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=25, use_kernels=True,
                       gamp_variance_mode="scalar")
    enc_mod.launches = g_mod.launches = 0
    card = run_federated("fedqcs-ae", steps=1, k_devices=10, device="cuda", fed_cfg=cfg, **kw)
    assert enc_mod.launches == 1 and g_mod.launches == 25
    plain = run_federated("fedqcs-ae", steps=1, k_devices=10, device="cpu", fed_cfg=cfg, **kw)
    assert _nmse(card.last_ghat.cpu(), plain.last_ghat) <= 1e-3


# -- slice 9: the AE decode in G groups, the loop oracle ---------------------------


def _kernel_cfg():
    from repro_torch.core.compression import FedQCSConfig

    return FedQCSConfig(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=25, use_kernels=True,
                        gamp_variance_mode="scalar")


@pytest.mark.parametrize("groups", [3, 10])
def test_ae_groups_round_on_the_card_matches_the_cpu(cuda, groups):
    """fedqcs-ae at G groups of K = 30: 25 gamp_step launches on G x 10
    rows, and the decoded aggregate within NMSE 1e-3 of the same round with
    the plain versions on the CPU."""
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.paper.mlp import run_federated

    g_mod.launches = 0
    card = run_federated("fedqcs-ae", steps=1, device="cuda", fed_cfg=_kernel_cfg(),
                         groups=groups)
    assert g_mod.launches == 25
    cpu = run_federated("fedqcs-ae", steps=1, device="cpu", fed_cfg=_kernel_cfg(), groups=groups)
    assert _nmse(card.last_ghat.cpu(), cpu.last_ghat) <= 1e-3


def test_loop_oracle_wire_matches_vmap_on_the_card(cuda, monkeypatch):
    """The per-client loop launches the fused encoder once per client at 10
    rows; each block row is its own CTA, so its words are the batched
    launch's bit for bit, and so are the parameters after 2 rounds."""
    from repro_torch.fed import engine as teng
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.paper.mlp import run_federated

    words = []
    client_pass = teng.CohortEngine._client_pass

    def capture(self, *args):
        out = client_pass(self, *args)
        words.append(out[0]["words"])
        return out

    monkeypatch.setattr(teng.CohortEngine, "_client_pass", capture)
    seen = {}
    for impl in ("vmap", "loop"):
        enc_mod.launches = 0
        res = run_federated("fedqcs-ae", steps=2, device="cuda", fed_cfg=_kernel_cfg(), impl=impl)
        seen[impl] = (enc_mod.launches, res)
    assert seen["vmap"][0] == 2 and seen["loop"][0] == 60
    assert torch.equal(words[0], words[2])
    assert res.nmses == seen["vmap"][1].nmses
    assert torch.equal(res.last_ghat, seen["vmap"][1].last_ghat)


# -- slice 10: the streamed rounds, the recorder ----------------------------------


@pytest.mark.parametrize("method", ["fedqcs-ae", "fedqcs-ea"])
def test_streamed_round_on_the_card_matches_the_cpu(cuda, method):
    """A streamed round in 8-client batches on the kernel route: the fused
    encoder once, then 25 gamp_step launches on 10 rows (the AE finalize)
    or 4 folds of 25 qgamp_step launches on 80 rows (EA); the decoded
    aggregate within NMSE 1e-3 of the same round with the plain versions on
    the CPU."""
    from repro_torch.fed.stream import StreamConfig
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.kernels import qgamp_step as q_mod
    from repro_torch.paper.mlp import run_federated

    stream = StreamConfig(batch_clients=8, buffer_batches=2, fanout=2, deadline=1e9)
    enc_mod.launches = g_mod.launches = q_mod.launches = 0
    card = run_federated(method, steps=1, device="cuda", fed_cfg=_kernel_cfg(), stream=stream)
    want = (25, 0) if method == "fedqcs-ae" else (0, 100)
    assert enc_mod.launches == 1 and (g_mod.launches, q_mod.launches) == want
    cpu = run_federated(method, steps=1, device="cpu", fed_cfg=_kernel_cfg(), stream=stream)
    assert _nmse(card.last_ghat.cpu(), cpu.last_ghat) <= 1e-3


def test_recorded_round_on_the_card_is_unchanged(cuda):
    """Recording (a device sync at the end of each phase, the decode
    health) changes no value of a round on the card."""
    from repro_torch.obs import InMemoryRecorder
    from repro_torch.paper.mlp import run_federated

    rec = InMemoryRecorder()
    recorded = run_federated("fedqcs-ea", steps=2, device="cuda", fed_cfg=_kernel_cfg(), obs=rec)
    plain = run_federated("fedqcs-ea", steps=2, device="cuda", fed_cfg=_kernel_cfg())
    assert recorded.nmses == plain.nmses and torch.equal(recorded.last_ghat, plain.last_ghat)
    rounds = [e for e in rec.events if e["kind"] == "round"]
    assert [set(e["phase_ms"]) for e in rounds] == [{"uplink", "client_pass", "decode",
                                                     "apply"}] * 2


# -- slice 11: the per-tensor layout, the streamed encode ---------------------


@pytest.mark.parametrize("method,kernel", [("fedqcs-ae", "gamp_step"), ("fedqcs-ea", "qgamp_step")])
def test_per_tensor_round_on_the_card_matches_the_cpu(cuda, method, kernel):
    """A round over the per-tensor layout (13 block rows a client): the
    fused encoder once at 390 rows, 25 step launches (gamp_step at 13 rows
    or qgamp_step at 390); the decoded aggregate within NMSE 1e-3 of the
    same round with the plain versions on the CPU."""
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import gamp_step as g_mod
    from repro_torch.kernels import qgamp_step as q_mod
    from repro_torch.paper.mlp import run_federated

    enc_mod.launches = g_mod.launches = q_mod.launches = 0
    card = run_federated(method, steps=1, device="cuda", fed_cfg=_kernel_cfg(),
                         layout="per_tensor")
    step = {"gamp_step": g_mod, "qgamp_step": q_mod}[kernel]
    assert enc_mod.launches == 1 and step.launches == 25
    cpu = run_federated(method, steps=1, device="cpu", fed_cfg=_kernel_cfg(), layout="per_tensor")
    assert tuple(card.last_ghat.shape) == (13, 1591)
    assert _nmse(card.last_ghat.cpu(), cpu.last_ghat) <= 1e-3


def test_encode_stream_wire_matches_one_pass_on_the_card(cuda, monkeypatch):
    """The segment-streamed encode launches the fused encoder once per
    segment (30, 30, 300 and 30 rows); its wire, and the round it feeds,
    are the one-pass encode's bit for bit."""
    from repro_torch.fed import engine as teng
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.paper.mlp import run_federated

    words = []
    client_pass = teng.CohortEngine._client_pass

    def capture(self, *args, **kwargs):
        out = client_pass(self, *args, **kwargs)
        words.append(out[0]["words"])
        return out

    monkeypatch.setattr(teng.CohortEngine, "_client_pass", capture)
    seen = {}
    for stream in (False, True):
        enc_mod.launches = 0
        res = run_federated("fedqcs-ea", steps=2, device="cuda", fed_cfg=_kernel_cfg(),
                            layout="per_tensor", encode_stream=stream)
        seen[stream] = (enc_mod.launches, res)
    assert seen[False][0] == 2 and seen[True][0] == 8
    assert torch.equal(words[0], words[2])
    assert seen[True][1].nmses == seen[False][1].nmses
    assert torch.equal(seen[True][1].last_ghat, seen[False][1].last_ghat)


# One smoke-config train step per impl on the card against the same step on
# the CPU (plain versions): the forward is fp32 on both, so the loss agrees
# to 1e-5 and the residual to 1e-5; the decoded aggregate can part in a
# near-zero entry's sign, which one Adam step turns into up to 2 lr.
_STEP_FED = dict(block_size=256, reduction_ratio=2, bits=4, s_ratio=0.08, gamp_iters=15,
                 gamp_variance_mode="scalar", use_kernels=True)


def _smoke_step(device, impl, fed_kw, pods, mesh):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.data.synthetic import TokenDataset
    from repro_torch.optim.adam import OptConfig
    from repro_torch.runtime import steps

    cfg, opt = smoke_config("qwen3-0.6b"), OptConfig(lr=3e-3, warmup_steps=2, decay_steps=100)
    fed = None if fed_kw is None else FedQCSConfig(**{**_STEP_FED, **fed_kw})
    state = steps.init_train_state(cfg, opt, fed, 0, n_pods=pods, mesh=mesh, impl=impl,
                                   device=device)
    fn = steps.make_train_step(cfg, opt, fed, mesh, impl=impl, device=device,
                               a=torch.randn((128, 256), generator=torch.Generator()
                                             .manual_seed(1)) / np.sqrt(128))
    return fn(state, TokenDataset(cfg.vocab_size, batch=16, seq=32, seed=7).get_batch(
        0, device=device))


@pytest.mark.parametrize("impl,fed_kw", [
    ("auto", {}), ("auto", {"recon_mode": "ea"}), ("auto_sharded", {}), ("baseline", None),
    ("shard_map", {}), ("shard_map", {"recon_mode": "ea"}),
])
def test_train_step_on_the_card_matches_the_cpu(cuda, tmp_path, impl, fed_kw):
    """impl="shard_map" runs at world size 1 over NCCL (one card) and is
    held against one pod's impl="auto" step on the CPU."""
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.launch.mesh import make_debug_mesh, make_single_device_mesh

    mesh, pods, cpu_impl = make_single_device_mesh(), 2, impl
    if impl == "shard_map":
        dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                                world_size=1)
        mesh, pods, cpu_impl = make_debug_mesh(1), 1, "auto"
    j_impl = "auto" if impl == "baseline" else impl
    try:
        enc_mod.launches = 0
        card, m_card = _smoke_step("cuda", j_impl, fed_kw, pods, mesh)
        torch.cuda.synchronize()
        launched = enc_mod.launches
    finally:
        if impl == "shard_map":
            dist.destroy_process_group()
    assert launched == (0 if fed_kw is None else pods)
    cpu, m_cpu = _smoke_step("cpu", "auto" if cpu_impl == "baseline" else cpu_impl, fed_kw,
                             pods, make_single_device_mesh())
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-5
    if fed_kw is not None:
        torch.testing.assert_close(card["residual"].cpu(), cpu["residual"], rtol=0, atol=1e-5)
    worst = max(float(torch.max(torch.abs(p.cpu() - tree_util.get(cpu["params"], path))))
                for path, p in tree_util.leaves(card["params"]))
    assert worst <= 2 * 3e-3, worst


@pytest.mark.parametrize("impl,fed_kw", [
    ("auto", {}), ("auto", {"recon_mode": "ea"}), ("auto_sharded", {}), ("baseline", None),
])
def test_inpod_step_on_the_card_matches_the_cpu(cuda, impl, fed_kw):
    """The reference's (2, 2, 2) mesh as eight gloo ranks, every one on the
    card (their collectives through host copies), against the same world on
    the CPU: one smoke-model step from seed 0; each rank launches the
    encoder once (none for the baseline)."""
    import torch_inpod_worker

    from repro_torch import tree as tree_util
    from repro_torch.launch.spawn import run_world

    fed = None if fed_kw is None else {**_STEP_FED, **fed_kw}
    j_impl = "auto" if impl == "baseline" else impl
    card, cpu = (run_world(torch_inpod_worker.one_step, 8, args=(j_impl, fed), device=dev,
                           timeout_s=300) for dev in ("cuda", "cpu"))
    assert all(r["launches"] == (0 if fed is None else 1) for r in card)
    for got, want in zip(card, cpu):
        assert abs(got["loss"] - want["loss"]) <= 1e-5
        if fed is not None:
            torch.testing.assert_close(got["residual"], want["residual"], rtol=0, atol=1e-5)
    worst = max(float(torch.max(torch.abs(p - tree_util.get(cpu[0]["params"], path))))
                for path, p in tree_util.leaves(card[0]["params"]))
    assert worst <= 2 * 3e-3, worst


@pytest.mark.parametrize("arch,state_dtype", [
    ("mamba2-1.3b", "float32"), ("zamba2-2.7b", "float32"), ("qwen3-0.6b", "int8"),
])
def test_inpod_family_step_on_the_card_matches_the_cpu(cuda, arch, state_dtype):
    """The SSM and hybrid smoke models, and the dense one with int8 Adam
    states, on the (2, 2, 2) world of eight ranks on the card against the
    same world on the CPU: one ``auto`` step from seed 0; each rank
    launches the encoder once; the loss within 1e-5, the kept sets equal
    and each unkept residual entry within 1e-5 of the CPU's beyond the gap
    between the two worlds' gradient rows there
    (``tests/test_torch_families.py``'s contract: the hybrid's gradient
    reaches ~40, where two orders of fp32 sums part by more than 1e-5),
    the parameters within 2 lr."""
    import torch_inpod_worker

    from repro_torch import tree as tree_util
    from repro_torch.launch.spawn import run_world

    card, cpu = (run_world(torch_inpod_worker.one_step, 8,
                           args=("auto", _STEP_FED, arch, state_dtype), device=dev,
                           timeout_s=300) for dev in ("cuda", "cpu"))
    assert all(r["launches"] == 1 for r in card)
    for got, want in zip(card, cpu):
        assert abs(got["loss"] - want["loss"]) <= 1e-5
        res, ref = got["residual"][0], want["residual"][0]
        assert torch.equal(res == 0, ref == 0)
        gap = torch.abs(got["blocks"] - want["blocks"])
        unkept = ref != 0
        assert bool(torch.all(torch.abs(res - ref)[unkept] <= 1e-5 + gap[unkept]))
    worst = max(float(torch.max(torch.abs(p - tree_util.get(cpu[0]["params"], path))))
                for path, p in tree_util.leaves(card[0]["params"]))
    assert worst <= 2 * 3e-3, worst


def test_inpod_whisper_step_on_the_card_matches_one_process(cuda):
    """Whisper-base's smoke model (the audio family: frames split over
    (pod, data) with the tokens, cross-attention on the rank's heads) on
    the (2, 2, 2) world of eight ranks on the card against one process's
    two-pod ``auto`` step on the card, both from seed 0 on
    ``torch_inpod_worker.family_batch``: each rank launches the encoder
    once; the loss within 1e-5; each rank's residual against its rows of
    one process's pod residual to ``tests/test_torch_families.py``'s
    contract (the kept sets equal, each unkept entry within 1e-5 beyond
    the two gradients' gap there); the parameters within 2 lr."""
    import torch_inpod_worker

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.launch.spawn import run_world
    from repro_torch.optim.adam import OptConfig
    from repro_torch.runtime import steps

    arch = "whisper-base"
    world = run_world(torch_inpod_worker.one_step, 8, args=("auto", _STEP_FED, arch),
                      device="cuda", timeout_s=300)
    assert all(r["launches"] == 1 for r in world)
    cfg, fed = smoke_config(arch), FedQCSConfig(**_STEP_FED)
    opt = OptConfig(lr=3e-3, warmup_steps=2, decay_steps=100)
    batch = {k: v.cuda() for k, v in torch_inpod_worker.family_batch(cfg).items()}
    state = steps.init_train_state(cfg, opt, fed, 0, n_pods=2, device="cuda")
    blocks = steps.pod_blocks(state["params"], batch, cfg, 2, fed.block_size, "cuda")[1].cpu()
    new, m = steps.make_train_step(cfg, opt, fed, make_single_device_mesh(),
                                   device="cuda")(state, batch)
    residual = new["residual"].cpu()
    rows = world[0]["residual"].shape[1]
    for rank, got in enumerate(world):
        assert abs(got["loss"] - float(m["loss"])) <= 1e-5
        pod, r = divmod(rank, 4)
        ref = residual[pod, r * rows:(r + 1) * rows]
        res = got["residual"][0]
        assert torch.equal(res == 0, ref == 0), rank
        gap = torch.abs(got["blocks"] - blocks[pod, r * rows:(r + 1) * rows])
        unkept = ref != 0
        assert bool(torch.all(torch.abs(res - ref)[unkept] <= 1e-5 + gap[unkept])), rank
    worst = max(float(torch.max(torch.abs(p - tree_util.get(new["params"], path).cpu())))
                for path, p in tree_util.leaves(world[0]["params"]))
    assert worst <= 2 * 3e-3, worst


def test_inpod_serve_on_the_card_matches_one_process(cuda):
    """The in-pod serve steps (prefill over (pod, data), split-KV decode
    over ``model``) of the dense smoke model on the (2, 2, 2) world of
    eight ranks on the card against one process's ``make_prefill_step`` /
    ``make_decode_step`` on the card, both from seed 0 on
    ``torch_inpod_worker.serve_batch``: 5 greedy steps from slot 6 of 16
    (``model`` rank 0's slots, then rank 1's); every rank's greedy tokens
    equal, its logits and cache shard within 1e-4 of its shards of one
    process's (fp32 products summed in another order on the card)."""
    import torch_inpod_worker as w

    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.spawn import run_world
    from repro_torch.models import model as model_api
    from repro_torch.models.sharding import local_shard, shard_cache
    from repro_torch.runtime import steps

    arch = "qwen3-0.6b"
    world = run_world(w.serve_world, 8, args=(arch,), device="cuda", timeout_s=300)
    cfg = smoke_config(arch)
    params = model_api.init_params(cfg, 0, "cuda")
    batch = {k: v.cuda() for k, v in w.serve_batch(cfg).items()}
    logits, cache = steps.make_prefill_step(cfg, None)(params, batch, w.SERVE_SMAX)
    decode = steps.make_decode_step(cfg, None)
    mesh = Mesh({"pod": 2, "data": 2, "model": 2})
    specs = {kind: steps.serve_specs(cfg, mesh, kind) for kind in ("prefill", "decode")}

    def close(got, want, what):
        assert got.shape == want.shape, what
        assert float(torch.max(torch.abs(got - want.cpu()))) <= 1e-4, what

    for rank, out in enumerate(world):
        mesh.rank = rank
        c = mesh.coords()
        close(out["logits"], local_shard(logits, specs["prefill"]["logits"], mesh.shape, c),
              ("prefill", rank))
        for k, v in shard_cache(cache, mesh).items():
            close(out["cache"][k], v, ("prefill cache", k, rank))
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for t in range(w.SERVE_STEPS):
        tok, lo, cache = decode(params, cache, tok, w.SERVE_S + t)
        for rank, out in enumerate(world):
            mesh.rank = rank
            c = mesh.coords()
            got = out["steps"][t]
            want = local_shard(tok, specs["decode"]["next_tok"], mesh.shape, c)
            assert torch.equal(got["next_tok"], want.cpu()), (t, rank)
            close(got["logits"], local_shard(lo, specs["decode"]["logits"], mesh.shape, c),
                  ("decode", t, rank))
            for k, v in shard_cache(cache, mesh).items():
                close(got["cache"][k], v, ("decode cache", t, k, rank))
    assert all(out["donated_in_place"] and out["kept_left_cache"] for out in world)


# The transformer family's MoE, MLA (+MTP) and VLM smoke configs and the
# SSM, hybrid and audio families' on the card against the same model on the
# CPU, both fp32 (TF32 off): the loss within 1e-5, every gradient leaf,
# prefill's logits and cache and 8 decode steps (each fed the CPU's greedy
# token) rtol 1e-4 / atol 1e-5 -- the same products in another summation
# order (an embedding row's gradient sums O(1) terms that cancel to ~1e-3,
# where the two orders part by ~3e-6).
_FAMILIES = ["qwen3-moe-235b-a22b", "deepseek-v3-671b", "qwen2-vl-7b", "mamba2-1.3b",
             "zamba2-2.7b", "whisper-base"]
_SSM_AUDIO = ("ssm", "hybrid", "audio")


def _prompt(cfg, batch):
    """The prefill input of a train batch: the frames (audio) or the
    tokens (with the VLM's patches and positions)."""
    if cfg.family == "audio":
        return {"frames": batch["frames"]}
    return {k: v for k, v in batch.items() if k != "labels"}


def _family_case(arch, device):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import model as M

    cfg = smoke_config(arch)
    params = M.init_params(cfg, seed=3, device=device)
    gen = torch.Generator().manual_seed(4)
    b, s, sv = 2, 24, (6 if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s - sv), generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (b, s - sv), generator=gen)}
    if sv:
        batch["patches"] = torch.randn((b, sv, cfg.d_model), generator=gen) * 0.02
        batch["positions"] = torch.stack([torch.arange(s), torch.arange(s) // 2,
                                          torch.arange(s) % 3])[:, None].expand(3, b, s)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((b, 20, cfg.d_model), generator=gen) * 0.02
    return cfg, params, {k: v.to(device) for k, v in batch.items()}


def _serve_run(arch, device, feed=None):
    """(loss, grads, prefill logits, prefill cache, 8 decode logits, the
    greedy tokens, the final cache) of ``arch``'s smoke config."""
    from repro_torch.models import model as M
    from repro_torch.runtime import steps

    cfg, params, batch = _family_case(arch, device)
    loss, grads = steps.value_and_grad(params, batch, cfg)
    logits, pc = steps.make_prefill_step(cfg, None)(params, _prompt(cfg, batch))
    # the next position: Whisper's prefill decoded BOS at 0
    s = 1 if cfg.family == "audio" else batch["tokens"].shape[1] + (
        batch["patches"].shape[1] if "patches" in batch else 0)
    cache = M.grow_cache(pc, s + 8)
    decode = steps.make_decode_step(cfg, None)
    tok, outs, toks = torch.argmax(logits[:, -1], -1)[:, None], [], []
    for t in range(8):
        tok = tok if feed is None else feed[t].to(device)
        toks.append(tok.cpu())
        tok, lo, cache = decode(params, cache, tok, s + t)
        outs.append(lo)
    return loss, grads, logits, pc, outs, toks, cache


@pytest.mark.parametrize("arch", _FAMILIES)
def test_serve_family_on_the_card_matches_the_cpu(cuda, arch):
    from repro_torch import tree as tree_util

    cpu = _serve_run(arch, "cpu")
    card = _serve_run(arch, "cuda", feed=cpu[5])
    assert abs(float(card[0]) - float(cpu[0])) <= 1e-5
    for path, g in tree_util.leaves(card[1]):
        want = tree_util.get(cpu[1], path)
        # the SSM, hybrid and audio families: atol 1e-5 x the leaf's largest
        # entry where that exceeds 1 (Zamba2's smoke gradients reach ~40,
        # where fp32 rounding alone is ~1e-6 of the leaf's scale)
        atol = (1e-5 * max(1.0, float(want.abs().max()))
                if arch in ("mamba2-1.3b", "zamba2-2.7b", "whisper-base") else 1e-5)
        torch.testing.assert_close(g.cpu(), want, rtol=1e-4, atol=atol,
                                   msg=lambda m, p=path: f"{p}: {m}")
    fwd = dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(card[2].cpu(), cpu[2], **fwd)
    for idx in (3, 6):  # the prefill cache, the cache after 8 decode steps
        for path, v in tree_util.leaves(card[idx]):
            torch.testing.assert_close(v.cpu(), tree_util.get(cpu[idx], path), **fwd)
    for t, (lo_card, lo_cpu) in enumerate(zip(card[4], cpu[4])):
        torch.testing.assert_close(lo_card.cpu(), lo_cpu, **fwd, msg=lambda m, t=t: f"{t}: {m}")


@pytest.mark.parametrize("mode", ["ae", "ea"])
@pytest.mark.parametrize("arch", _FAMILIES)
def test_family_train_step_on_the_card_matches_the_cpu(cuda, arch, mode):
    """One impl="auto" FedQCS step of each new family's smoke config on the
    kernel route (the encoder once a pod, then 15 gamp_step or qgamp_step
    launches) against the same step on the CPU (the plain versions): the
    aggregate the step applied (Adam's first moment, 0.1 x the clipped
    aggregate after a first step) to NMSE <= 1e-3, the loss, the residual
    and the parameters within 2 lr.  The SSM, hybrid and audio families'
    residual is held to atol 1e-5 beyond the two devices' gap in the
    gradient blocks it comes from (Zamba2's smoke gradients reach ~40,
    where fp32 rounding alone is ~5e-5)."""
    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.compression import FedQCSConfig
    from repro_torch.data.synthetic import TokenDataset
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import gamp_step as gamp_mod
    from repro_torch.kernels import qgamp_step as qgamp_mod
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.optim.adam import OptConfig
    from repro_torch.runtime import steps

    cfg, opt = smoke_config(arch), OptConfig(lr=3e-3, warmup_steps=2, decay_steps=100)
    fed = FedQCSConfig(**{**_STEP_FED, "recon_mode": mode})
    a = torch.randn((128, 256), generator=torch.Generator().manual_seed(1)) / np.sqrt(128)
    batch = TokenDataset(cfg.vocab_size, batch=8, seq=16, seed=7).get_batch(0, device="cpu")
    if cfg.family == "vlm":
        gen = torch.Generator().manual_seed(2)
        batch["patches"] = torch.randn((8, 4, cfg.d_model), generator=gen) * 0.02
        batch["positions"] = torch.arange(20).expand(3, 8, 20)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((8, 16, cfg.d_model),
                                      generator=torch.Generator().manual_seed(2)) * 0.02
    out, blocks = {}, {}
    for dev in ("cuda", "cpu"):
        for mod in (enc_mod, gamp_mod, qgamp_mod):
            mod.launches = 0
        state = steps.init_train_state(cfg, opt, fed, 0, n_pods=2, device=dev)
        fn = steps.make_train_step(cfg, opt, fed, make_single_device_mesh(), device=dev, a=a)
        on_dev = {k: v.to(dev) for k, v in batch.items()}
        blocks[dev] = steps.pod_blocks(state["params"], on_dev, cfg, 2, 256, dev)[1].cpu()
        new, m = fn(state, on_dev)
        out[dev] = (new, float(m["loss"]))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (enc_mod.launches, gamp_mod.launches, qgamp_mod.launches) == (
                2, 15 if mode == "ae" else 0, 15 if mode == "ea" else 0)
    (card, l_card), (cpu, l_cpu) = out["cuda"], out["cpu"]
    assert abs(l_card - l_cpu) <= 1e-5
    if cfg.family in _SSM_AUDIO:
        gap = torch.abs(blocks["cuda"] - blocks["cpu"])
        assert bool((torch.abs(card["residual"].cpu() - cpu["residual"]) <= 1e-5 + gap).all())
    else:
        torch.testing.assert_close(card["residual"].cpu(), cpu["residual"], rtol=0, atol=1e-5)
    worst = max(float(torch.max(torch.abs(p.cpu() - tree_util.get(cpu["params"], path))))
                for path, p in tree_util.leaves(card["params"]))
    assert worst <= 2 * 3e-3, worst
    moment = [torch.cat([v.cpu().flatten() for _, v in tree_util.leaves_in_order(st["opt"]["m"])])
              for st in (card, cpu)]
    assert float(torch.sum(moment[1] ** 2)) > 0
    assert _nmse(*moment) <= 1e-3


# -- slice 15: the cohort mode -------------------------------------------------


def test_cohort_round_on_the_card_matches_the_cpu(cuda):
    """One round of the launcher's cohort engine on Qwen3-0.6B's smoke config
    (4 clients of 2 x 16 tokens, fedqcs-ae at N = 255 on the kernel route:
    the encoder once over the cohort's rows, then 15 gamp_step launches)
    against the same round on the CPU (the plain versions), from the same
    parameters, A, batches and draws: the aggregate to NMSE <= 1e-3, the
    residuals to 1e-5, the parameters within 2 lr."""
    import dataclasses

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import gamp_step as gamp_mod
    from repro_torch.launch import train as tlaunch

    out = []
    for dev in ("cuda", "cpu"):
        args = tlaunch.parse_args(["--arch", "qwen3-0.6b", "--smoke", "--fed-cohort", "--clients",
                                   "4", "--seq", "16", "--device", dev])
        fed = dataclasses.replace(tlaunch.cohort_fed(args), use_kernels=True)
        engine = tlaunch.make_fed_cohort(args, smoke_config("qwen3-0.6b"), fed=fed)[0]
        enc_mod.launches = gamp_mod.launches = 0
        engine.run_round()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (enc_mod.launches, gamp_mod.launches) == (1, 15)
        out.append(engine)
    card, cpu = out
    assert _nmse(card.last_ghat.cpu(), cpu.last_ghat) <= 1e-3
    torch.testing.assert_close(card.residuals.cpu(), cpu.residuals, rtol=0, atol=1e-5)
    worst = max(float(torch.max(torch.abs(p.cpu() - tree_util.get(cpu.params, path))))
                for path, p in tree_util.leaves(card.params))
    assert worst <= 2 * 3e-3, worst


# -- slice 16: the backward-interleaved producer -------------------------------


def _interleaved_engine(dev, extra=()):
    """The launcher's ``--fed-cohort --interleave 2`` engine on Qwen3-0.6B's
    smoke config (4 clients of 2 x 16 tokens) on ``dev``, kernel route."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import train as tlaunch

    args = tlaunch.parse_args(["--arch", "qwen3-0.6b", "--smoke", "--fed-cohort", "--clients",
                               "4", "--seq", "16", "--interleave", "2", *extra, "--device", dev])
    fed = dataclasses.replace(tlaunch.cohort_fed(args), use_kernels=True)
    return tlaunch.make_fed_cohort(args, smoke_config("qwen3-0.6b"), fed=fed)[0]


def test_interleaved_wire_on_the_card_matches_its_one_pass(cuda):
    """On the card, the producer's segment stream encodes to the wire of the
    one-pass encode of its own ``grads_fn`` tree, bit for bit (payload and
    residuals): one encoder launch a segment."""
    from repro_torch.kernels import bqcs_encode_fused as enc_mod

    engine = _interleaved_engine("cuda")
    prod, layout = engine._grad_segments_fn, engine.layout
    ids = np.arange(4)
    batch = engine.data.cohort_batch(0, ids)
    gen = torch.Generator(device="cuda").manual_seed(1)
    res0 = torch.randn((4, engine.nb, engine.n), generator=gen, device="cuda") * 1e-3
    rhos = torch.ones(4, device="cuda")

    def one_pass(params, b, lo):
        tree = prod.grads_fn(params, b)
        for seg in lo.segments:
            yield seg.index, lo.segment_blocks_batched(tree, seg.index)

    enc_mod.launches = 0
    pay, _, res = engine._client_pass_streamed(batch, res0.clone(), rhos, rhos)
    torch.cuda.synchronize()
    assert enc_mod.launches == len(layout.segments)
    engine._grad_segments_fn = one_pass
    pay1, _, res1 = engine._client_pass_streamed(batch, res0.clone(), rhos, rhos)
    for k in pay:
        assert torch.equal(pay[k], pay1[k]), k
    assert torch.equal(res, res1)


def test_interleaved_round_on_the_card_matches_the_cpu(cuda):
    """One interleaved cohort round (``--interleave 2``, and with
    ``--grad-accum 2``) on the card against the same round on the CPU:
    the aggregate to NMSE <= 1e-3, the residuals to 1e-5, the parameters
    within 2 lr, as the one-pass cohort round is held."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels import bqcs_encode_fused as enc_mod
    from repro_torch.kernels import gamp_step as gamp_mod

    for extra in ((), ("--grad-accum", "2")):
        out = []
        for dev in ("cuda", "cpu"):
            engine = _interleaved_engine(dev, extra)
            enc_mod.launches = gamp_mod.launches = 0
            engine.run_round()
            if dev == "cuda":
                torch.cuda.synchronize()
                assert (enc_mod.launches, gamp_mod.launches) == (len(engine.layout.segments), 15)
            out.append(engine)
        card, cpu = out
        assert _nmse(card.last_ghat.cpu(), cpu.last_ghat) <= 1e-3, extra
        torch.testing.assert_close(card.residuals.cpu(), cpu.residuals, rtol=0, atol=1e-5)
        worst = max(float(torch.max(torch.abs(p.cpu() - tree_util.get(cpu.params, path))))
                    for path, p in tree_util.leaves(card.params))
        assert worst <= 2 * 3e-3, (extra, worst)


def _bit_patterns(x: torch.Tensor) -> torch.Tensor:
    """A tensor's raw words (f32 / bf16 patterns, ints as they are), int64."""
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    elif x.dtype == torch.float32:
        x = x.view(torch.int32)
    return x.to(torch.int64)


def test_prng_integer_draws_on_the_card_are_the_cpus(cuda):
    """The threefry draws are integer arithmetic: the card's bits, integers,
    keys and permutations equal the CPU's bit for bit (2**22 elements, a
    draws)."""
    from repro_torch import prng

    n = 1 << 22
    key_c, key_g = prng.PRNGKey(5), prng.PRNGKey(5, device=cuda)
    assert torch.equal(prng.random_bits(key_g, (n,)).cpu(), prng.random_bits(key_c, (n,)))
    assert torch.equal(prng.randint(key_g, (n,), 0, 151936).cpu(),
                       prng.randint(key_c, (n,), 0, 151936))
    assert torch.equal(prng.permutation(key_g, 1591).cpu(), prng.permutation(key_c, 1591))
    keys = prng.split(key_c, 1000)
    assert torch.equal(prng.split(keys.to(cuda), 3).cpu(), prng.split(keys, 3))
    assert torch.equal(prng.fold_in(keys.to(cuda), 9).cpu(), prng.fold_in(keys, 9))


@pytest.mark.parametrize("name", ["normal", "exponential", "gumbel"])
def test_prng_float_transforms_on_the_card_are_the_cpus(cuda, name):
    """The float transforms (XLA's log / log1p / erf_inv forms, their FMAs
    rounded once) on all 2**23 inputs: the card equals the CPU in every bit
    (the stated bound: 0 differing inputs, 0 ulp)."""
    from repro_torch import prng

    words = torch.arange(1 << 23, dtype=torch.int64) << 9
    card = prng.from_bits(name)(words.to(cuda)).cpu()
    cpu = prng.from_bits(name)(words)
    assert int((card.view(torch.int32) != cpu.view(torch.int32)).sum()) == 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b", "mamba2-1.3b",
                                  "whisper-base"])
def test_init_params_on_the_card_is_the_cpus(cuda, arch):
    """``init_params`` drawn on the card equals its CPU draw leaf for leaf,
    bit for bit (the transforms' bound above), at the smoke config."""
    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import model as model_api

    cfg = smoke_config(arch)
    card = model_api.init_params(cfg, 0, cuda)
    cpu = model_api.init_params(cfg, 0, "cpu")
    for path, v in tree_util.leaves(card):
        assert v.device.type == "cuda", path
        assert torch.equal(_bit_patterns(v.cpu()), _bit_patterns(tree_util.get(cpu, path))), path
