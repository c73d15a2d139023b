"""Shared set-up of the round-level parity tests (tests/test_torch_baselines.py,
tests/test_torch_channel.py, tests/test_torch_knobs.py): one small federation
run by the reference's
``CohortEngine`` and by the port's, from the same numpy data, parameters,
sensing matrix, dither codec and random draws.

The model is a softmax regression (``w`` (32, 8), ``b`` (8,): 264
parameters, 5 blocks of N = 64) over 6 clients, so a round costs
milliseconds in either package.  The port takes the reference's draws
through its draw seam (``CohortEngine(draw=...)``): :func:`reference_draw`
computes each one with ``jax.random`` along the reference engine's own key
path (``fold_in(PRNGKey(seed), round)``, split into the channel and noise
keys; a client's dither key is ``fold_in`` of the round key with its id; a
streamed round's per-client receive noise and a streamed multiple-access
batch's noise are ``fold_in`` of the noise key with the client's id or the
batch's admission index).  ``stream`` and ``obs`` build both engines with
streamed rounds (the StreamConfig's fields) and a recorder each.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.core.compression import FedQCSConfig as JCfg
from repro.fed import engine as jeng
from repro.fed.channel import ChannelConfig as JChan
from repro.fed.scheduler import SchedulerConfig as JSched
from repro.fed.server_opt import ServerOptConfig as JSrv
from repro.fed.stream import StreamConfig as JStream
from repro_torch.core.baselines import DitherCodec
from repro_torch.core.compression import FedQCSConfig as TCfg
from repro_torch.fed import engine as teng
from repro_torch.fed.channel import ChannelConfig as TChan
from repro_torch.fed.scheduler import SchedulerConfig as TSched
from repro_torch.fed.server_opt import ServerOptConfig as TSrv
from repro_torch.fed.stream import StreamConfig as TStream

D_IN, D_OUT, CLIENTS, LR = 32, 8, 6, 0.003
FED = dict(block_size=64, reduction_ratio=4, bits=3, s_ratio=0.2, gamp_iters=10)
DITHER_N = 64


def reference_draw(seed: int):
    """The port's draw seam, returning the reference engine's draws; a 1-D
    ``client`` of ids draws each client's on its own key, stacked (the
    reference's vmap over its client keys)."""

    def per_client(key, client, fn):
        if np.ndim(client):
            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.asarray(client))
            return jax.vmap(fn)(keys)
        return fn(jax.random.fold_in(key, client))

    def draw(t, purpose, shape, client=None):
        kr = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        k_chan, k_noise = jax.random.split(kr)
        normal = lambda k: jax.random.normal(k, shape, jnp.float32)  # noqa: E731
        if purpose == "gain":
            x = jax.random.exponential(k_chan, shape, jnp.float32)
        elif purpose in ("h", "h_err"):
            k_h, k_e = jax.random.split(k_chan)
            x = normal(k_h if purpose == "h" else k_e)
        elif purpose in ("noise", "batch_noise"):
            x = normal(k_noise) if client is None else per_client(k_noise, client, normal)
        else:  # dither
            x = per_client(kr, client,
                           lambda k: jax.random.uniform(k, shape, minval=-0.5, maxval=0.5))
        return torch.tensor(np.asarray(x, np.float32))

    return draw


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(120, D_IN)).astype(np.float32)
    y = rng.integers(0, D_OUT, 120).astype(np.int32)
    parts = [np.arange(k, 120, CLIENTS) for k in range(CLIENTS)]
    w = (rng.normal(size=(D_IN, D_OUT)) / np.sqrt(D_IN)).astype(np.float32)
    params = {"w": w, "b": np.zeros(D_OUT, np.float32)}
    return x, y, parts, params


def _j_loss(params, x, y):
    logp = jax.nn.log_softmax(x @ params["w"] + params["b"])
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _j_grad(params, batch):
    return jax.grad(_j_loss)(params, batch["x"], batch["y"])


def _t_loss(params, x, y):
    logp = torch.log_softmax(x @ params["w"] + params["b"], dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None]))


def _t_grad(params, batch):
    return torch.func.grad(_t_loss)(params, batch["x"], batch["y"])


def _configs(method, fed_kw, dropout, seed, sched_kw, cohort_kw, server_kw):
    return dict(
        fed=dict(FED, **(fed_kw or {})),
        cohort=dict(dict(method=method, dither_n=DITHER_N, seed=seed), **(cohort_kw or {})),
        sched=dict(dict(kind="full", dropout_prob=dropout, seed=seed), **(sched_kw or {})),
        server=dict(dict(kind="fedadam", lr=LR, b1=0.9, b2=0.999, eps=1e-8),
                    **(server_kw or {})),
    )


def port_engine(method, chan_kw=None, fed_kw=None, dropout=0.0, seed=0, sched_kw=None,
                cohort_kw=None, server_kw=None, a=None, draw=None, stream=None, obs=None,
                layout=None):
    """The port's engine over the federation; with no ``a`` and ``draw``, on
    its own sensing matrix and draws (no JAX work).  ``layout`` is an
    explicit ``GradientLayout``."""
    c = _configs(method, fed_kw, dropout, seed, sched_kw, cohort_kw, server_kw)
    x, y, parts, params = _data()
    return teng.CohortEngine(
        {k: torch.tensor(v) for k, v in params.items()}, _t_grad,
        teng.ArrayClientData(x, y, parts, batch_size=4, seed=seed, device="cpu"),
        fed_cfg=TCfg(**c["fed"]), cohort=teng.CohortConfig(**c["cohort"]),
        sched=TSched(**c["sched"]), chan=TChan(**(chan_kw or {})),
        server=TSrv(**c["server"]), stream=None if stream is None else TStream(**stream),
        obs=obs, layout=layout, device="cpu", a=a, draw=draw,
    )


def engines(method, chan_kw=None, fed_kw=None, dropout=0.0, seed=0, sched_kw=None,
            cohort_kw=None, server_kw=None, stream=None, obs=(None, None),
            layouts=(None, None)):
    """(reference engine, port engine) over the same federation, with the
    reference's sensing matrix, dither codec and draws in the port's.
    ``sched_kw``, ``cohort_kw`` and ``server_kw`` override the full
    scheduler, the cohort defaults and FedAdam; ``stream`` (StreamConfig
    fields) selects streamed rounds in both, ``obs`` is (reference
    recorder, port recorder), ``layouts`` (reference layout, port layout)
    explicit ``GradientLayout``s."""
    c = _configs(method, fed_kw, dropout, seed, sched_kw, cohort_kw, server_kw)
    x, y, parts, params = _data()
    je = jeng.CohortEngine(
        {k: jnp.asarray(v) for k, v in params.items()}, _j_grad,
        jeng.ArrayClientData(x, y, parts, batch_size=4, seed=seed),
        fed_cfg=JCfg(**c["fed"]), cohort=jeng.CohortConfig(**c["cohort"]),
        sched=JSched(**c["sched"]), chan=JChan(**(chan_kw or {})),
        server=JSrv(**c["server"]), stream=None if stream is None else JStream(**stream),
        obs=obs[0], layout=layouts[0],
    )
    a = None if je.codec is None else torch.tensor(np.asarray(je.codec.a))
    te = port_engine(method, chan_kw, fed_kw, dropout, seed, sched_kw, cohort_kw, server_kw,
                     a=a, draw=reference_draw(seed), stream=stream, obs=obs[1],
                     layout=layouts[1])
    if je._dither is not None:
        jd = je._dither
        te.dither = DitherCodec(jd.n, jd.m, jd.bits,
                                rademacher=torch.tensor(np.asarray(jd.rademacher)),
                                rows=torch.tensor(np.asarray(jd.rows)))
    return je, te


def reference_round(je):
    """One reference round (barrier or streamed); returns (stats, decoded
    aggregate)."""
    seen = {}
    ps, decode = je._ps_jit, jeng.stream_decode

    def capture(*args, **kwargs):
        out = (ps if je.stream is None else decode)(*args, **kwargs)
        seen["ghat"] = out[0]
        return out

    je._ps_jit = capture
    jeng.stream_decode = capture
    try:
        stats = je.run_round()
    finally:
        je._ps_jit = ps
        jeng.stream_decode = decode
    return stats, np.asarray(seen["ghat"])


def nmse(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.sum((x - ref) ** 2) / max(np.sum(ref**2), 1e-30))


def check_round(je, te, ghat_tol):
    """Runs round 0 in both and holds the port to the reference: the decoded
    aggregate to NMSE ``ghat_tol``, every stat to 1e-5 relative, the
    residuals and the scheduler state, and the parameters (atol 1e-6 where
    |ghat| > 1e-4 max|ghat|; Adam's first step is +-lr there, and within
    2 lr everywhere).  Returns (port stats, reference stats)."""
    stats_j, ghat_j = reference_round(je)
    stats_t = te.run_round()
    ghat_t = te.last_ghat.numpy()
    assert ghat_t.shape == ghat_j.shape
    assert nmse(ghat_t, ghat_j) <= ghat_tol, nmse(ghat_t, ghat_j)
    assert set(stats_t) == set(stats_j), (sorted(stats_t), sorted(stats_j))
    for k, v in stats_j.items():
        assert abs(stats_t[k] - float(v)) <= 1e-5 * abs(float(v)) + 1e-12, (k, stats_t[k], v)
    np.testing.assert_allclose(te.residuals.numpy(), np.asarray(je.residuals),
                               rtol=1e-5, atol=1e-7)
    assert np.array_equal(te.sched_state.last_round, je.sched_state.last_round)
    # the reference's aggregate per parameter, through the round's layout
    gj = {k: v.numpy() for k, v in te.layout.tree_from_blocks(torch.tensor(ghat_j)).items()}
    big = 1e-4 * np.abs(ghat_j).max()
    for k, v in je.params.items():
        v = np.asarray(v)
        got = te.params[k].numpy()
        mask = np.abs(gj[k]) > big
        np.testing.assert_allclose(got[mask], v[mask], rtol=0, atol=1e-6)
        assert np.all(np.abs(got - v) <= 2 * LR + 1e-6)
    return stats_t, stats_j
