"""Port parity, the noisy uplinks (``fed/channel.py``) and fedqcs-ae rounds
over them through the cohort engine, against the JAX reference on the CPU.

The port draws its channel state through a draw seam; these tests hand it
the reference's draws, computed with ``jax.random`` along the reference's
own key path (``torch_fed_parity.reference_draw``).  Contracts, each with
its reason:

  * realizations, ``transmit`` and ``mimo_tx_gain``: to 1e-6 relative
    (elementwise fp32 arithmetic on the same draws);
  * ``mimo_combine``: to rtol 1e-4 (atol 1e-6 of the output's scale) --
    fp32 LU solves of the same 8 x 8 (lmmse) or 6 x 6 (zf) system in two
    libraries differ in the last bits, and the noise estimate sums squared
    mismatches of order 1e-7; zero-forcing's target mismatch is round-off
    in both (below 1e-10);
  * the gating ``ValueError``s and the registry's unknown-kind error: raised
    where the reference raises them;
  * one fedqcs-ae round over awgn, rayleigh (with an outage) and mimo_mac
    (lmmse, and zf with CSI error): the decoded aggregate to NMSE 1e-6 and
    the rest as ``torch_fed_parity.check_round``;
  * ``api.reconstruct`` with ``ReconSpec(channel=...)``: NMSE 1e-4 (the GAMP
    contract).

They compare outputs only: the reference's quality claims for a noisy round
at toy size (``nmse`` below a bound) are not restated here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.fed import channel as jch  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import recon_engine as tre  # noqa: E402
from repro_torch.fed import channel as tch  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.paper import mlp as tmlp  # noqa: E402
from torch_fed_parity import check_round, engines, reference_draw  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def T(x):
    return torch.tensor(np.asarray(x))


def key_draw(key):
    """The draws a reference realize/transmit hook takes from ``key``."""
    k_h, k_e = jax.random.split(key)
    table = {
        "gain": lambda s: jax.random.exponential(key, s, jnp.float32),
        "h": lambda s: jax.random.normal(k_h, s, jnp.float32),
        "h_err": lambda s: jax.random.normal(k_e, s, jnp.float32),
        "noise": lambda s: jax.random.normal(key, s, jnp.float32),
    }
    return lambda purpose, shape: T(table[purpose](shape))


def close(got, want, rtol=1e-6):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("snr_db", [-10.0, 0.0, 7.5, 20.0, 40.0])
def test_snr_noise_var(snr_db):
    assert tch.snr_noise_var(snr_db) == jch.snr_noise_var(snr_db)


REALIZE_CASES = [
    dict(kind="ideal"),
    dict(kind="awgn", snr_db=10.0),
    dict(kind="rayleigh", snr_db=15.0, outage_gain=0.3),
    dict(kind="mimo_mac", n_rx=8),
    dict(kind="mimo_mac", n_rx=6, csi_error=0.01, combiner="zf"),
]


@pytest.mark.parametrize("kw", REALIZE_CASES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_realization_from_injected_draws(kw):
    key = jax.random.PRNGKey(4)
    want = jch.realize_uplink(jch.ChannelConfig(**kw), key, 6, 3)
    got = tch.realize_uplink(tch.ChannelConfig(**kw), key_draw(key), 6, 3)
    for name in ("noise_var", "mask", "h", "h_hat", "sigma2"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            close(g, w)
    if kw["kind"] == "rayleigh":
        assert 0 < int(got.mask.sum()) < 6  # the draw puts some clients in outage
        assert bool((got.noise_var[got.mask == 0] == 0).all())


@pytest.mark.parametrize("kw", REALIZE_CASES[1:], ids=lambda kw: kw["kind"])
def test_transmit_with_injected_noise(kw):
    cfg_j, cfg_t = jch.ChannelConfig(**kw), tch.ChannelConfig(**kw)
    k_real, k_noise = jax.random.split(jax.random.PRNGKey(9))
    real_j = jch.realize_uplink(cfg_j, k_real, 6, 3)
    real_t = tch.realize_uplink(cfg_t, key_draw(k_real), 6, 3)
    x = np.random.default_rng(3).normal(size=(6, 3, 20)).astype(np.float32)
    fam_j, fam_t = jch.get_channel_family(kw["kind"]), tch.get_channel_family(kw["kind"])
    want = fam_j.transmit(cfg_j, real_j, jnp.asarray(x), k_noise)
    got = fam_t.transmit(cfg_t, real_t, torch.tensor(x), key_draw(k_noise))
    assert tuple(got.shape) == want.shape
    close(got, want)
    close(fam_t.effective_noise(real_t), fam_j.effective_noise(real_j))
    assert fam_t.exact_codes == fam_j.exact_codes
    assert fam_t.multiple_access == fam_j.multiple_access


def test_ideal_transmit_is_the_identity():
    fam = tch.get_channel_family("ideal")
    x = torch.randn(2, 3, 4)
    real = tch.realize_uplink(tch.ChannelConfig(), None, 2, 3)
    assert fam.transmit(tch.ChannelConfig(), real, x, None) is x
    assert fam.exact_codes and not fam.multiple_access


def _mimo_inputs(seed=5, clients=6, nb=3, m=20, silent=(4,)):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, (clients, nb)).astype(np.float32)
    active = np.ones(clients, np.float32)
    active[list(silent)] = 0.0
    w[list(silent)] = 0.0
    return w, active, rng.normal(size=(8, nb, m)).astype(np.float32)


def test_mimo_tx_gain_matches_reference():
    w, active, _ = _mimo_inputs()
    close(tch.mimo_tx_gain(T(w), T(active)), jch.mimo_tx_gain(jnp.asarray(w), jnp.asarray(active)))
    zero = np.zeros_like(active)
    got = tch.mimo_tx_gain(T(w), T(zero))
    assert float(got) == 0.0 == float(jch.mimo_tx_gain(jnp.asarray(w), jnp.asarray(zero)))


@pytest.mark.parametrize("gain", [False, True])
@pytest.mark.parametrize("csi", [0.0, 0.01])
@pytest.mark.parametrize("combiner", ["lmmse", "zf"])
def test_mimo_combine_matches_reference(combiner, csi, gain):
    kw = dict(kind="mimo_mac", n_rx=8, csi_error=csi, combiner=combiner, snr_db=10.0)
    cfg_j, cfg_t = jch.ChannelConfig(**kw), tch.ChannelConfig(**kw)
    key = jax.random.PRNGKey(11)
    real_j = jch.realize_uplink(cfg_j, key, 6, 3)
    real_t = tch.realize_uplink(cfg_t, key_draw(key), 6, 3)
    w, active, y = _mimo_inputs()
    eta_j = jch.mimo_tx_gain(jnp.asarray(w), jnp.asarray(active)) if gain else None
    eta_t = T(eta_j) if gain else None
    for aux in (False, True):
        want = jch.mimo_combine(cfg_j, real_j, jnp.asarray(y), jnp.asarray(w),
                                jnp.asarray(active), psi=0.8, tx_gain=eta_j, with_aux=aux)
        got = tch.mimo_combine(cfg_t, real_t, T(y), T(w), T(active), psi=0.8, tx_gain=eta_t,
                               with_aux=aux)
        assert len(got) == len(want) == (3 if aux else 2)
        close(got[0], want[0], rtol=1e-4)
        close(got[1], want[1], rtol=1e-4)
        if aux:
            assert set(got[2]) == set(want[2])
            for k in want[2]:
                if combiner == "zf" and k == "csi_target_mismatch":
                    # zero-forcing meets its target on h_hat exactly: both
                    # hold round-off only
                    assert float(got[2][k]) < 1e-10 and float(want[2][k]) < 1e-10
                else:
                    close(got[2][k], want[2][k], rtol=1e-4)


@pytest.mark.parametrize("method,kind,groups", [
    ("fedqcs-ea", "awgn", 1), ("qcs-dither", "awgn", 1), ("qcs-qiht", "rayleigh", 1),
    ("signsgd", "mimo_mac", 1), ("none", "awgn", 1),
    ("fedqcs-ea", "ideal", 2), ("fedqcs-ae", "awgn", 2),
])
def test_engine_gating_raises_like_the_reference(method, kind, groups):
    cohort_t = teng.CohortConfig(method=method, groups=groups)
    with pytest.raises(ValueError, match="exact codes|groups != 1"):
        teng.CohortEngine({"w": torch.zeros(3)}, None, None, cohort=cohort_t,
                          chan=tch.ChannelConfig(kind=kind), device="cpu")
    # the reference raises the same error for the same config
    with pytest.raises(ValueError, match="exact codes|groups != 1"):
        je_data = type("D", (), {"counts": np.ones(2, np.int64)})()
        from repro.fed import engine as jeng
        jeng.CohortEngine({"w": jnp.zeros(3)}, None, je_data,
                          cohort=jeng.CohortConfig(method=method, groups=groups),
                          chan=jch.ChannelConfig(kind=kind))


def test_unknown_channel_kind_and_mimo_config_raise():
    with pytest.raises(ValueError, match="unknown channel kind 'nope'"):
        tch.get_channel_family("nope")
    with pytest.raises(ValueError, match="unknown channel kind"):
        tch.realize_uplink(tch.ChannelConfig(kind="nope"), None, 4, 2)
    with pytest.raises(ValueError, match="unknown channel kind"):
        teng.CohortEngine({"w": torch.zeros(3)}, None, None,
                          chan=tch.ChannelConfig(kind="nope"), device="cpu")
    draw = key_draw(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="n_rx >= 1"):
        tch.realize_uplink(tch.ChannelConfig(kind="mimo_mac", n_rx=0), draw, 4, 2)
    with pytest.raises(ValueError, match="unknown mimo_mac combiner"):
        tch.realize_uplink(tch.ChannelConfig(kind="mimo_mac", combiner="mrc"), draw, 4, 2)
    assert sorted(tch.CHANNEL_FAMILIES) == sorted(jch.CHANNEL_FAMILIES)


# ---------------------------------------------------------------------------
# fedqcs-ae rounds over each noisy uplink, the reference's draws injected
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chan_kw", [
    dict(kind="awgn", snr_db=10.0),
    dict(kind="mimo_mac", n_rx=8, snr_db=15.0),
    dict(kind="mimo_mac", n_rx=8, combiner="zf", csi_error=0.01),
], ids=["awgn", "mimo_mac-lmmse", "mimo_mac-zf-csi"])
def test_noisy_ae_round_matches_reference(chan_kw):
    je, te = engines("fedqcs-ae", chan_kw)
    stats_t, _ = check_round(je, te, 1e-6)
    assert stats_t["nu_channel"] > 0.0 and stats_t["participating"] == stats_t["cohort"]


def test_rayleigh_round_with_an_outage_matches_reference():
    """Two rounds over rayleigh with clients in outage: rho = 0 for them,
    their scheduler stamp is taken back (they keep last_round), and their
    residual carries the full gradient."""
    chan_kw = dict(kind="rayleigh", snr_db=10.0, outage_gain=0.5)
    je, te = engines("fedqcs-ae", chan_kw)
    gain = reference_draw(0)(0, "gain", (6,))
    dead = np.flatnonzero(gain.numpy() < 0.5)
    assert 0 < len(dead) < 6
    stats_t, _ = check_round(je, te, 1e-6)
    assert stats_t["participating"] == 6 - len(dead)
    assert np.all(te.sched_state.last_round[dead] == -1)
    live = np.setdiff1d(np.arange(6), dead)
    assert np.all(te.sched_state.last_round[live] == 0)
    # round 0 starts from zero residuals: an outage client's residual is its
    # whole gradient, a live one's only what top-S left out
    density = (te.residuals != 0).float().mean(dim=(1, 2)).numpy()
    assert density[dead].min() > density[live].max()
    check_round(je, te, 1e-6)


@pytest.mark.parametrize("kind,kw", [("awgn", {}), ("rayleigh", {}),
                                     ("mimo_mac", dict(n_rx=32, csi_error=0.01))])
def test_run_federated_over_a_noisy_uplink_on_the_cpu(kind, kw):
    res = tmlp.run_federated("fedqcs-ae", steps=1, k_devices=4, eval_every=1, device="cpu",
                             channel=kind, snr_db=20.0, **kw)
    assert len(res.nmses) == 1 and np.isfinite(res.nmses[0])
    assert bool(torch.isfinite(res.last_ghat).all())


def test_default_draws_are_device_free_and_distinct():
    a = teng.seeded_draw(0, 3, "noise", (4, 5))
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(a, teng.seeded_draw(0, 3, "noise", (4, 5)))
    assert not torch.equal(a, teng.seeded_draw(0, 4, "noise", (4, 5)))
    assert not torch.equal(a, teng.seeded_draw(1, 3, "noise", (4, 5)))
    d0, d1 = (teng.seeded_draw(0, 3, "dither", (64,), client=c) for c in (0, 1))
    assert not torch.equal(d0, d1) and float(d0.abs().max()) <= 0.5
    assert float(teng.seeded_draw(0, 3, "gain", (100,)).min()) >= 0.0


# ---------------------------------------------------------------------------
# api.reconstruct with a received channel observation
# ---------------------------------------------------------------------------


def test_api_reconstruct_with_a_channel_observation():
    cfg_kw = dict(block_size=256, reduction_ratio=4, bits=3, s_ratio=0.1, gamp_iters=15)
    jcodec = japi.make_codec(jcomp.FedQCSConfig(**cfg_kw))
    tcodec = tapi.make_codec(tcomp.FedQCSConfig(**cfg_kw), device="cpu", a=T(jcodec.a))
    rng = np.random.default_rng(7)
    pays_j, pays_t = [], []
    for _ in range(3):
        g = {"b": rng.normal(0, 0.01, (24,)).astype(np.float32),
             "w": rng.standard_t(4, (20, 24)).astype(np.float32) * 0.01}
        pj, spec_j, _ = japi.compress(jcodec, {k: jnp.asarray(v) for k, v in g.items()},
                                      japi.init_state(jcodec, g))
        pays_j.append(pj)
        pays_t.append(tcomp.CompressedGradient(T(np.array(pj.codes)), T(np.array(pj.alpha)),
                                               pj.nbar, pj.m, pj.bits))
    spec_t = tcomp.GradientLayout.monolithic({k: torch.zeros(v.shape) for k, v in g.items()}, 256)
    rhos = [0.5, 0.3, 0.2]
    # one superimposed reception over a 4-antenna MAC, combined by the reference
    cfg = jch.ChannelConfig(kind="mimo_mac", n_rx=4, snr_db=15.0)
    k_real, k_noise = jax.random.split(jax.random.PRNGKey(2))
    real = jch.realize_uplink(cfg, k_real, 3, spec_j.rows)
    codes = jnp.stack([jcodec.unpack(p.codes) for p in pays_j])
    alphas = jnp.stack([p.alpha for p in pays_j])
    from repro.core import bussgang as jbg

    w = jbg.bussgang_weight(jnp.asarray(rhos)[:, None], alphas, jcodec.codebook)
    eta = jch.mimo_tx_gain(w, jnp.ones(3))
    x = (eta * w)[..., None] * jcodec.dequantize(codes)
    y_rx = jch.get_channel_family("mimo_mac").transmit(cfg, real, x, k_noise)
    y_eff, nu_eff = jch.mimo_combine(cfg, real, y_rx, w, jnp.ones(3),
                                     psi=jcodec.codebook.psi, tx_gain=eta)
    for info in (False, True):
        out_j = japi.reconstruct(jcodec, pays_j, rhos, spec_j, recon=japi.ReconSpec(
            channel=(y_eff, nu_eff), return_info=info))
        out_t = tapi.reconstruct(tcodec, pays_t, rhos, spec_t, recon=tre.ReconSpec(
            channel=(T(y_eff), T(nu_eff)), return_info=info))
        if info:
            (out_j, info_j), (out_t, info_t) = out_j, out_t
            assert set(info_t) == set(info_j)
        assert set(out_t) == set(out_j)
        num = sum(float(np.sum((out_t[k].numpy() - np.asarray(out_j[k])) ** 2)) for k in out_j)
        den = sum(float(np.sum(np.asarray(out_j[k]) ** 2)) for k in out_j)
        assert num / den <= 1e-4, num / den


def test_recon_spec_channel_keeps_the_reference_errors():
    with pytest.raises(ValueError, match="mode 'ea' cannot consume"):
        tre.ReconSpec(mode="ea", channel=(None, None))
    with pytest.raises(ValueError, match="groups != 1"):
        tre.ReconSpec(mode="ae", groups=2, channel=(None, None))
    assert tre.ReconSpec(mode="ae", channel=(None, None)).channel == (None, None)
