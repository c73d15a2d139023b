"""Port parity: the SSM, hybrid and audio families (Mamba-2 SSD, Zamba2's
shared attention block, Whisper's encoder-decoder) on the train, prefill
and decode paths and the FedQCS train step, on the CPU.

Each family runs its reference smoke config (fp32): ``mamba2-1.3b`` (2
layers, d_model 64, state 16, heads of 16, chunks of 16), ``zamba2-2.7b``
(4 Mamba layers, the shared block after every 2, 4 heads of 16) and
``whisper-base`` (2 + 2 layers, 4 heads of 16).  The reference's
parameters are carried across with ``convert.from_reference``; its jitted
runs are computed once a pytest run and shared by the xdist workers
(``_shared``).

Contracts (fp32):
  * the tree: paths, shapes and dtypes (the fp32 ``a_log``, ``d_skip`` and
    ``dt_bias`` among bf16 leaves at full width), and the sharding specs;
  * ``train_loss`` within 1e-5, every gradient leaf rtol 1e-4 / atol 1e-6
    (``_assert_grads_close``: where the reference's own fp32 gradient is
    farther than that from its float64 gradient, the port's leaf is held
    to the float64 gradient instead);
  * prefill's logits and whole cache, and 4 decode steps from the
    reference's own cache (logits each step, the cache after the last):
    rtol 1e-4 / atol 1e-5;
  * ``_ssd_chunked`` at lengths that are not a multiple of the chunk,
    ``_causal_conv`` and the GELU MLP within 1e-6, cross-attention;
  * the reference's own contract that the SSD prefill state equals T
    sequential decodes (rtol 2e-3 / atol 1e-5), on the port; the hybrid's
    and Whisper's prefill against sequential decode;
  * one ``impl="auto"`` FedQCS train step (2 pods) from the reference's
    state: loss 1e-5, residual atol 1e-5 beyond the two packages' gap in
    the gradient blocks it comes from, parameters within 2 lr.

Zamba2's smoke model is the one that needs the float64 anchor: its
residual stream grows from ~0.08 to ~6 at the first shared attention
block, its gradients reach 38 (``conv_b``), and the reference's own fp32
gradient lies up to 3e-6 (``conv_w``) and 4e-6 (the embedding) from its
float64 gradient, so no other order of sums can meet atol 1e-6 there.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.launch.mesh import make_single_device_mesh as j_single_mesh  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import sharding as jshard  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import from_reference, state_from_reference  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import sharding as tshard  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from torch_shared import shared as _shared, one_torch_thread  # noqa: E402,F401

FAMILIES = ["mamba2-1.3b", "zamba2-2.7b", "whisper-base"]
FAMILY_ARCHS = sorted(a for a in jreg.ARCHS
                      if jreg.get_config(a).family in ("ssm", "hybrid", "audio"))
B, S, SF, SMAX, DECODE = 2, 20, 16, 28, 4  # S: 20 tokens (a chunk and a part)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(rtol=1e-4, atol=1e-5)
FED_KW = dict(block_size=256, reduction_ratio=2, bits=4, s_ratio=0.08, gamp_iters=15,
              gamp_variance_mode="scalar")
OPT_KW = dict(lr=3e-3, warmup_steps=2, decay_steps=100)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(getattr(k, "key", k) for k in p): v for p, v in flat}


def _ref_batch(cfg, b=B, s=S, seed=11):
    """Tokens and labels from a seed; the audio family's frames (SF of them)
    beside 12 text tokens."""
    rng = np.random.default_rng(seed)
    st = 12 if cfg.family == "audio" else s
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, st)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, st)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = (rng.normal(size=(b, SF, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _port_batch(batch):
    return {k: torch.tensor(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _prompt(batch, cfg):
    return {k: v for k, v in batch.items()
            if k == ("frames" if cfg.family == "audio" else "tokens")}


def _first_pos(cfg):
    """The first decode position after prefill: Whisper's prefill decoded a
    BOS token at 0; the others hold the S prompt tokens."""
    return 1 if cfg.family == "audio" else S


def _splice(cache, smax):
    """The reference's prefill cache with its self-attention K/V grown to
    ``smax`` slots (zeros after the prompt)."""
    def grow(path, v):
        if getattr(path[-1], "key", None) not in ("k", "v") or v.shape[2] == smax:
            return v
        pad = [(0, 0)] * v.ndim
        pad[2] = (0, smax - v.shape[2])
        return np.pad(v, pad)
    return jax.tree_util.tree_map_with_path(grow, cache)


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request, tmp_path_factory):
    """One family's reference run: params, batch, loss and gradients,
    prefill, and DECODE greedy decode steps from its own (spliced) cache."""
    arch = request.param
    out = _shared(tmp_path_factory, f"families_ref_{arch}", lambda: _ref_run(arch))
    return dict(out, cfg=jreg.smoke_config(arch))


def _grads64(cfg, params, batch):
    """The reference's gradient in float64 (the parameters cast up); None
    for the audio family, whose encoder casts its frames to the config's
    dtype."""
    if cfg.family == "audio":
        return None
    up = lambda v: v.astype(np.float64) if v.dtype == np.float32 else v
    jax.config.update("jax_enable_x64", True)
    try:
        return _np(jax.jit(jax.grad(lambda p, b: jmodel.train_loss(p, b, cfg)))(
            jax.tree_util.tree_map(up, params), {k: up(v) for k, v in batch.items()}))
    finally:
        jax.config.update("jax_enable_x64", False)


def _ref_run(arch):
    cfg = jreg.smoke_config(arch)
    params = _np(jax.jit(lambda k: jmodel.init_params(cfg, k))(jax.random.PRNGKey(0)))
    batch = _ref_batch(cfg)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jmodel.train_loss(p, b, cfg)))(
        params, batch)
    prompt = _prompt(batch, cfg)
    logits, cache = jax.jit(lambda p, b: jmodel.prefill(p, b, cfg))(params, prompt)
    dec = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, cfg))
    start = _splice(_np(cache), SMAX)
    tok = np.argmax(np.asarray(logits)[:, -1], axis=-1).astype(np.int32)[:, None]
    c, toks, steps_ = start, [], []
    for t in range(DECODE):
        lo, c = dec(params, c, tok, jnp.int32(_first_pos(cfg) + t))
        toks.append(tok)
        steps_.append(np.asarray(lo))
        tok = np.argmax(np.asarray(lo)[:, -1], axis=-1).astype(np.int32)[:, None]
    return {"arch": arch, "params": params, "batch": batch, "loss": float(loss),
            "grads": _np(grads), "logits": np.asarray(logits), "cache": _np(cache),
            "start": start, "tokens": toks, "decode_logits": steps_, "end": _np(c)}


def _assert_tree_close(got, want, msg="", **tol):
    want = _paths(want)
    items = tree_util.leaves(got)
    assert [p for p, _ in items] == list(want), msg
    for path, v in items:
        assert tuple(v.shape) == tuple(want[path].shape), (msg, path)
        np.testing.assert_allclose(v.numpy(), want[path], **tol, err_msg=f"{msg} {path}")


# ---------------------------------------------------------------------------
# per family: tree, loss and gradients, prefill, decode
# ---------------------------------------------------------------------------


def test_param_tree_matches_reference(fam):
    """Paths, shapes and dtypes of init_params at smoke size and at full
    width (meta tensors), the sharding rules' spec of every leaf, and the
    published dtypes: bf16 but for the SSM's fp32 ``a_log``, ``d_skip`` and
    ``dt_bias``."""
    arch = fam["arch"]
    for jcfg, tcfg, dev in ((fam["cfg"], registry.smoke_config(arch), "cpu"),
                            (jreg.get_config(arch), registry.get_config(arch), "meta")):
        want = _paths(jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                                     jax.random.PRNGKey(0)))
        got = tree_util.leaves(tmodel.init_params(tcfg, device=dev))
        assert [p for p, _ in got] == list(want)
        for path, leaf in got:
            assert tuple(leaf.shape) == tuple(want[path].shape), path
            assert str(leaf.dtype).replace("torch.", "") == str(want[path].dtype), path
    sizes = {"pod": 2, "data": 2, "model": 2}
    shapes = jax.eval_shape(lambda k: jmodel.init_params(fam["cfg"], k), jax.random.PRNGKey(0))
    want = _paths(jshard.param_specs(shapes, axis_sizes=sizes))
    got = tshard.param_specs(tmodel.init_params(registry.smoke_config(arch), device="meta"),
                             axis_sizes=sizes)
    for path, spec in tree_util.leaves(got):
        assert spec == tuple(want[path]), path
    dtypes = {path: leaf.dtype for path, leaf in tree_util.leaves(
        tmodel.init_params(registry.get_config(arch), device="meta"))}
    assert {path[-1] for path, dt in dtypes.items() if dt != torch.bfloat16} == (
        set() if arch == "whisper-base" else {"a_log", "d_skip", "dt_bias"})


def test_loss_and_gradients_match_reference(fam, tmp_path_factory):
    cfg = registry.smoke_config(fam["arch"])
    loss, grads = steps.value_and_grad(from_reference(fam["params"])[0],
                                       _port_batch(fam["batch"]), cfg)
    assert abs(float(loss) - fam["loss"]) <= 1e-5
    exact = lambda: _shared(tmp_path_factory, f"families_grads64_{fam['arch']}",
                            lambda: _grads64(fam["cfg"], fam["params"], fam["batch"]))
    _assert_grads_close(grads, fam["grads"], exact)


def _assert_grads_close(got, want, exact, rtol=1e-4, atol=1e-6):
    """Every leaf of ``got`` within rtol / atol of the reference's ``want``.
    A leaf that is not must be within rtol / atol' of the reference's
    float64 gradient (``exact()``, computed only then), atol' the larger
    of atol and twice the reference's own distance from it past rtol (so
    atol itself wherever the reference is within rtol / atol / 2 of it)."""
    want = _paths(want)
    items = tree_util.leaves(got)
    assert [p for p, _ in items] == list(want)
    for path, g in items:
        g, w = g.numpy(), want[path]
        assert g.shape == w.shape, path
        if np.allclose(g, w, rtol=rtol, atol=atol):
            continue
        if callable(exact):
            exact = exact()
        assert exact is not None, f"{path}: off the reference by {np.abs(g - w).max():.3g}"
        e = _paths(exact)[path]
        past = lambda x: float(np.max(np.abs(x - e) - rtol * np.abs(e)))
        assert past(g) <= max(atol, 2 * past(w)), (
            f"{path}: {past(g):.3g} past rtol from the float64 gradient, the reference "
            f"{past(w):.3g}")


def test_prefill_matches_reference(fam):
    """Last-position logits and the whole cache (SSM states and conv
    windows, the shared block's K/V per invocation, Whisper's cross K/V and
    its BOS slot) through ``make_prefill_step``."""
    cfg = registry.smoke_config(fam["arch"])
    prompt = _prompt(_port_batch(fam["batch"]), cfg)
    logits, cache = steps.make_prefill_step(cfg, None)(from_reference(fam["params"])[0], prompt)
    np.testing.assert_allclose(logits.numpy(), fam["logits"], **FWD)
    _assert_tree_close(cache, fam["cache"], "cache", **FWD)


def test_decode_matches_reference(fam):
    """DECODE steps of ``make_decode_step`` from the reference's own cache,
    each fed the reference's greedy token: logits each step, the greedy
    tokens, and the cache after the last (carried across by
    ``from_reference``)."""
    cfg = registry.smoke_config(fam["arch"])
    params = from_reference(fam["params"])[0]
    cache = from_reference(fam["start"])[0]
    fn = steps.make_decode_step(cfg, None)
    for t in range(DECODE):
        tok = torch.tensor(fam["tokens"][t].astype(np.int64))
        nxt, logits, cache = fn(params, cache, tok, _first_pos(cfg) + t)
        np.testing.assert_allclose(logits.numpy(), fam["decode_logits"][t], **FWD,
                                   err_msg=f"step {t}")
        if t + 1 < DECODE:
            assert np.array_equal(nxt.numpy(), fam["tokens"][t + 1]), t
    _assert_tree_close(cache, fam["end"], "cache", **FWD)


def test_donated_decode_matches_a_copy(fam):
    """``donate=True`` writes the caller's cache in place, bit for bit as
    ``donate=False``, which leaves its input as it was; of the attention
    caches only slot ``pos`` changes."""
    cfg = registry.smoke_config(fam["arch"])
    params = from_reference(fam["params"])[0]
    before = from_reference(fam["start"])[0]
    kept = tree_util.tree_map(torch.clone, before)
    tok = torch.tensor(fam["tokens"][0].astype(np.int64))
    pos = _first_pos(cfg)
    nxt_k, lo_k, out_k = steps.make_decode_step(cfg, None, donate=False)(params, before, tok,
                                                                         pos)
    for path, v in tree_util.leaves(before):
        assert torch.equal(v, tree_util.get(kept, path)), path
    donated = tree_util.tree_map(torch.clone, before)
    nxt_d, lo_d, out_d = steps.make_decode_step(cfg, None)(params, donated, tok, pos)
    assert torch.equal(lo_d, lo_k) and torch.equal(nxt_d, nxt_k)
    for path, v in tree_util.leaves(out_d):
        assert v is tree_util.get(donated, path), path
        assert torch.equal(v, tree_util.get(out_k, path)), path
        if path[-1] in ("k", "v"):
            changed = (v != tree_util.get(kept, path)).flatten(3).any(-1).any(0).any(0)
            assert changed.nonzero().flatten().tolist() == [pos], path


# ---------------------------------------------------------------------------
# the SSD scan, the conv, the GELU MLP, cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,chunk", [(37, 16), (5, 8), (16, 16)])
def test_ssd_chunked_matches_reference(t, chunk):
    """Lengths that pad to whole chunks (37 -> 48, 5 -> 8) and one that does
    not: the output and the final state."""
    rng = np.random.default_rng(t)
    b, h, p, n = 2, 3, 4, 5
    xh = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dta = -np.abs(rng.normal(size=(b, t, h)) * 0.5).astype(np.float32)
    bm = rng.normal(size=(b, t, n)).astype(np.float32)
    cm = rng.normal(size=(b, t, n)).astype(np.float32)
    y, final = jax.jit(lambda *a: jssm._ssd_chunked(*a, chunk))(xh, dta, bm, cm)
    ty, tfinal = tssm._ssd_chunked(*map(torch.tensor, (xh, dta, bm, cm)), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(final), rtol=1e-5, atol=1e-5)


def test_causal_conv_and_gelu_mlp_match_reference():
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    want = np.asarray(jssm._causal_conv(u, w, bias))
    got = tssm._causal_conv(torch.tensor(u), torch.tensor(w), torch.tensor(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    p = _np(jcommon.init_mlp(jax.random.PRNGKey(4), 8, 16, jnp.float32, gated=False))
    assert sorted(p) == ["wi", "wo"]
    x = (rng.normal(size=(2, 5, 8)) * 2).astype(np.float32)
    want = np.asarray(jcommon.apply_mlp(p, x))
    got = tcommon.apply_mlp(from_reference(p)[0], torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    tp = tcommon.init_mlp(prng.split(prng.PRNGKey(0), 2), 8, 16, torch.float32, gated=False)
    assert sorted(tp) == ["wi", "wo"] and tp["wi"].shape == (2, 8, 16)
    one = tcommon.init_mlp(prng.PRNGKey(4), 8, 16, torch.float32, gated=False)
    assert all(np.array_equal(one[k].numpy(), p[k]) for k in p)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_reference(qk_norm):
    """``apply_attention(cross_kv=)``: K/V from the encoder taken as they
    are (a qk-norm normalizes q only; no rotary), no mask."""
    cfg = dataclasses.replace(jreg.smoke_config("whisper-base"), qk_norm=qk_norm)
    tcfg = dataclasses.replace(registry.smoke_config("whisper-base"), qk_norm=qk_norm)
    p = _np(jcommon.init_attention(jax.random.PRNGKey(5), cfg))
    if qk_norm:
        p["q_norm"] = np.linspace(0.5, 1.5, cfg.head_dim).astype(np.float32)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    k = rng.normal(size=(2, 7, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    v = rng.normal(size=(2, 7, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, dtype=np.int32), (2, 3))
    want, _ = jcommon.apply_attention(p, x, pos, cfg, causal=False, cross_kv=(k, v))
    got, kv = tcommon.apply_attention(from_reference(p)[0], torch.tensor(x),
                                      torch.tensor(pos.astype(np.int64)), tcfg, causal=False,
                                      cross_kv=(torch.tensor(k), torch.tensor(v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert np.array_equal(kv["k"].numpy(), k)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(3, 5, 16)) * 3 + 1).astype(np.float32)
    scale, bias = rng.normal(size=(2, 16)).astype(np.float32)
    want = np.asarray(jcommon.layer_norm(x, scale, bias, 1e-6))
    got = tcommon.layer_norm(*map(torch.tensor, (x, scale, bias)), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# prefill against sequential decode (on the port)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [16, 37])
def test_ssd_prefill_state_equals_sequential_decode(t):
    """The reference's contract (``tests/test_models.py``): the chunked SSD
    scan's final state equals the state after T one-step decodes, here at
    one chunk and at a length that pads."""
    cfg = registry.smoke_config("mamba2-1.3b")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, t), generator=torch.Generator().manual_seed(1))
    _, pc = tmodel.prefill(params, {"tokens": toks}, cfg)
    cache = tmodel.init_cache(cfg, 1, t, device="cpu")
    for i in range(t):
        _, cache = tmodel.decode_step(params, cache, toks[:, i:i + 1], i, cfg)
    np.testing.assert_allclose(pc["ssm"].numpy(), cache["ssm"].numpy(), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(pc["conv"].numpy(), cache["conv"].numpy(), rtol=2e-3,
                               atol=1e-5)


def test_hybrid_prefill_equals_sequential_decode():
    """Zamba2: the last position's logits, every Mamba state and the shared
    block's K/V of a prefill against S decodes from an empty cache."""
    cfg = registry.smoke_config("zamba2-2.7b")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=torch.Generator().manual_seed(2))
    lo_p, pc = tmodel.prefill(params, {"tokens": toks}, cfg)
    cache = tmodel.init_cache(cfg, 2, S, device="cpu")
    for i in range(S):
        lo_d, cache = tmodel.decode_step(params, cache, toks[:, i:i + 1], i, cfg, inplace=True)
    tol = dict(rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(lo_p.numpy(), lo_d.numpy(), **tol)
    for path, v in tree_util.leaves(pc):
        np.testing.assert_allclose(v.numpy(), tree_util.get(cache, path).numpy(), **tol,
                                   err_msg=str(path))


def test_whisper_prefill_and_decode_equal_the_train_decoder():
    """Whisper: prefill (the encoder, the cross K/V, BOS at position 0) and
    then decodes of tokens 1..T-1 give, at each position, the logits of the
    full-sequence decoder over the same tokens (BOS first)."""
    cfg = registry.smoke_config("whisper-base")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    frames = torch.randn((2, SF, cfg.d_model), generator=gen) * 0.02
    toks = torch.randint(1, cfg.vocab_size, (2, 8), generator=gen)
    toks[:, 0] = 0
    with torch.no_grad():
        hidden = tencdec._decoder(params, toks, tencdec.encode(params, frames, cfg), cfg)
        want = tcommon.logits_from(params["tok"], hidden, cfg)
    lo, cache = tmodel.prefill(params, {"frames": frames}, cfg, smax=8)
    got = [lo]
    for i in range(1, 8):
        lo, cache = tmodel.decode_step(params, cache, toks[:, i:i + 1], i, cfg, inplace=True)
        got.append(lo)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(), rtol=2e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# specs, batches, caches across, the pod split, the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(jmodel.SHAPES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_input_specs_and_supports_cell_match_reference(arch, shape):
    """Every (arch x shape) of the three families: the same names, shapes
    and dtypes (the reference's int32 ids are int64 here), and the same
    verdict and reason."""
    assert tmodel.supports_cell(registry.get_config(arch), shape) == jmodel.supports_cell(
        jreg.get_config(arch), shape)
    want = _paths(jmodel.input_specs(jreg.get_config(arch), shape))
    got = tree_util.leaves(tmodel.input_specs(registry.get_config(arch), shape))
    assert sorted(p for p, _ in got) == sorted(want)
    for path, spec in got:
        assert spec.shape == tuple(want[path].shape), path
        jdt = str(want[path].dtype)
        assert str(spec.dtype).replace("torch.", "") == ("int64" if jdt == "int32" else jdt)


def test_make_batch_fills_the_audio_specs():
    cfg = registry.smoke_config("whisper-base")
    batch = tmodel.make_batch(cfg, "train_4k", seed=1, device="cpu")
    specs = tmodel.input_specs(cfg, "train_4k")
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: (s.shape, s.dtype) for k, s in specs.items()}
    assert batch["tokens"].shape == (256, 512) and batch["frames"].shape == (256, 4096, 64)
    assert 0.015 < float(batch["frames"].std()) < 0.025
    dec = tmodel.make_batch(registry.get_config("zamba2-2.7b"), "decode_32k", device="meta")
    assert dec["cache"]["attn"]["k"].shape == (9, 128, 32768, 32, 80)
    assert dec["cache"]["mamba"]["ssm"].shape == (54, 128, 80, 64, 64)


def test_bf16_trees_and_caches_carry_across():
    """``from_reference`` on the bf16 trees at a smoke size: every leaf's
    dtype and value (the fp32 ``a_log``, ``d_skip``, ``dt_bias`` among bf16
    leaves), and the caches (``conv``/``ssm``, ``cross_k``/``cross_v``)."""
    rng = np.random.default_rng(1)
    fill = lambda tree: jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.normal(size=v.shape), v.dtype), tree)
    for arch in FAMILIES:
        cfg = dataclasses.replace(jreg.smoke_config(arch), dtype="bfloat16")
        params = fill(jax.eval_shape(lambda k: jmodel.init_params(cfg, k),
                                     jax.random.PRNGKey(1)))
        cache = fill(jax.eval_shape(lambda: jmodel.init_cache(cfg, 2, 8)))
        for tree in (params, cache):
            got = from_reference(_np(tree))[0]
            want = _paths(tree)
            assert [p for p, _ in tree_util.leaves(got)] == list(want), arch
            for path, v in tree_util.leaves(got):
                assert str(v.dtype).replace("torch.", "") == str(want[path].dtype), path
                assert np.array_equal(v.float().numpy(),
                                      np.asarray(want[path]).astype(np.float32)), path


def test_pod_batch_splits_frames_along_the_batch():
    """``_pod_batch`` gives pod p rows p * B/pods.. of every leaf, the audio
    batch's (B, S, D) ``frames`` included."""
    batch = _port_batch(_ref_batch(registry.smoke_config("whisper-base"), b=6))
    for p in range(3):
        share = steps._pod_batch(batch, 3, p)
        for k, v in batch.items():
            assert torch.equal(share[k], v[2 * p:2 * p + 2]), k
    assert share["frames"].shape == (2, SF, 64)


def test_grow_cache_grows_only_the_slot_leaves():
    """``model.grow_cache``: the self-attention K/V get zero slots after the
    prompt (none when they have enough); SSM states and Whisper's cross K/V
    are copied as they are; the prefill's cache is never aliased."""
    cfg = registry.smoke_config("whisper-base")
    cache = tree_util.tree_map(lambda v: v + 1, tmodel.init_cache(cfg, 2, 5, device="cpu"))
    grown = tmodel.grow_cache(cache, 9)
    assert grown["k"].shape[2] == 9 and grown["cross_k"].shape == cache["cross_k"].shape
    assert bool((grown["k"][:, :, :5] == 1).all()) and bool((grown["k"][:, :, 5:] == 0).all())
    assert torch.equal(grown["cross_v"], cache["cross_v"])
    same = tmodel.grow_cache(cache, 3)
    for k, v in same.items():
        assert torch.equal(v, cache[k]) and v.data_ptr() != cache[k].data_ptr(), k
    hyb = tmodel.init_cache(registry.smoke_config("zamba2-2.7b"), 2, 5, device="cpu")
    out = tmodel.grow_cache(hyb, 9)
    assert out["attn"]["v"].shape[2] == 9 and out["mamba"]["ssm"].shape == (4, 2, 8, 16, 16)
    assert out["mamba"]["conv"].data_ptr() != hyb["mamba"]["conv"].data_ptr()


def test_serve_example_runs_the_hybrid(capsys):
    """``examples/serve_lm_torch.py`` for the hybrid: the shared block's K/V
    grown to smax, the Mamba states kept."""
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", os.path.join(ROOT, "examples", "serve_lm_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    args = ["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--tokens", "5"]
    for arch in ("zamba2-2.7b",):
        example.main(args + ["--arch", arch])
        assert f"{arch}: decoded (2, 5) tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_launcher_pod_mode_on_the_family(arch, tmp_path, capfd):
    """``python -m repro_torch.launch.train --arch ARCH --smoke --fedqcs``,
    2 pods, 2 steps, on the CPU (the reference's launcher takes these two
    archs; Whisper's batches need frames its token data lacks): the
    reference's (2, 2, 2) world, int8 moments on its shards (rank 0 prints:
    its lines reach the file descriptor)."""
    tlaunch.main(["--arch", arch, "--smoke", "--fedqcs", "--pods", "2", "--device", "cpu",
                  "--steps", "2", "--log-every", "1", "--batch", "4", "--seq", "16",
                  "--int8-opt-state", "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert "mesh={'pod': 2, 'data': 2, 'model': 2}" in out
    assert "[train] done" in out and out.count("loss") == 2
    losses = [float(line.split("loss")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step")]
    assert all(np.isfinite(losses))


def test_launcher_refuses_the_audio_family(tmp_path):
    with pytest.raises(ValueError, match="frames"):
        tlaunch.main(["--arch", "whisper-base", "--smoke", "--fedqcs", "--device", "cpu",
                      "--steps", "1", "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# one FedQCS train step a family
# ---------------------------------------------------------------------------


def _ref_step(arch):
    """The reference's initial state (two pods), one impl="auto" step on
    its single-device mesh, and its sensing matrix."""
    cfg = jreg.smoke_config(arch)
    fed, opt = jcomp.FedQCSConfig(**FED_KW), jadam.OptConfig(**OPT_KW)
    mesh = j_single_mesh()
    state = _np(jax.jit(lambda k: jsteps.init_train_state(cfg, opt, fed, k, n_pods=2,
                                                          mesh=mesh))(jax.random.PRNGKey(0)))
    batch = _ref_batch(cfg, b=8, s=12, seed=12)
    new, m = jsteps.make_train_step(cfg, opt, fed, mesh, donate=False)(state, batch)
    return {"state": state, "batch": batch, "new": _np(new), "loss": float(m["loss"]),
            "a": np.asarray(jcomp.BQCSCodec(fed).a)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch, tmp_path_factory):
    """``make_train_step(impl="auto")`` over each family's tree (the shared
    block's gradient summed over its groups; Whisper's frames split across
    the pods) from the reference's state.  The residual is each pod's
    gradient blocks less the kept top-S entries: the kept sets must agree
    (the residuals' zeros), and each unkept entry must be within atol 1e-5
    of the reference's beyond the two packages' gap in that gradient
    entry (the port's gradient blocks against the reference's residual,
    which is the reference's gradient there)."""
    ref = _shared(tmp_path_factory, f"families_step_{arch}", lambda: _ref_step(arch))
    state = state_from_reference(ref["state"])
    state["step"] = state["step"].to(torch.int32)
    fn = steps.make_train_step(registry.smoke_config(arch), tadam.OptConfig(**OPT_KW),
                               tcomp.FedQCSConfig(**FED_KW), tmesh.make_single_device_mesh(),
                               device="cpu", a=torch.tensor(ref["a"]))
    batch = _port_batch(ref["batch"])
    cfg = registry.smoke_config(arch)
    blocks = steps.pod_blocks(state["params"], batch, cfg, 2, FED_KW["block_size"], "cpu")[1]
    new, m = fn(state, batch)
    assert abs(float(m["loss"]) - ref["loss"]) <= 1e-5
    res, want = new["residual"].numpy(), ref["new"]["residual"]
    assert res.shape == want.shape == tuple(blocks.shape)
    assert np.array_equal(res == 0, want == 0)
    gap = np.abs(blocks.numpy() - want)
    assert np.all(np.abs(res - want)[want != 0] <= 1e-5 + gap[want != 0])
    want = _paths(ref["new"]["params"])
    for path, v in tree_util.leaves(new["params"]):
        assert float(np.max(np.abs(v.numpy() - want[path]))) <= 2 * OPT_KW["lr"], path


SEED_ARCHS = ("qwen3-0.6b", "qwen3-moe-235b-a22b", "deepseek-v3-671b", "qwen2-vl-7b",
              "mamba2-1.3b", "zamba2-2.7b", "whisper-base")


def _words(x) -> np.ndarray:
    """A leaf's raw bit patterns (bf16 or f32) as int64."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)
        return x.numpy().astype(np.int64)
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32).astype(np.int64)


@pytest.mark.parametrize("arch", SEED_ARCHS)
def test_init_params_from_a_seed_is_the_references(arch):
    """``init_params(cfg, 3)`` with the port's defaults alone equals the
    reference's ``init_params(cfg, PRNGKey(3))`` leaf for leaf, bit for bit,
    at the smoke config of every family (MoE, MLA with MTP, M-RoPE, SSM,
    hybrid, audio): the same key tree, each stacked leaf's layers drawn
    from their own keys.  The reference is called as it is, eagerly: under
    ``jax.jit`` XLA folds ``sqrt(2) * scale`` into one constant, which moves
    the last bit of some draws."""
    want = _paths(jmodel.init_params(jreg.smoke_config(arch), jax.random.PRNGKey(3)))
    got = {path: v for path, v in tree_util.leaves(
        tmodel.init_params(registry.smoke_config(arch), 3, device="cpu"))}
    assert list(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        bad = int(np.sum(_words(g) != _words(w)))
        assert bad == 0, f"{path}: {bad} of {w.size} differ"
    keyed = tmodel.init_params(registry.smoke_config(arch), prng.PRNGKey(3), device="cpu")
    assert all(torch.equal(keyed_v, got[p]) for p, keyed_v in tree_util.leaves(keyed))


def test_card_params_rule_matches_init_params():
    """``chip_smoke.py``'s card-side draw follows ``init_params`` leaf by leaf
    for the six archs it serves: its ``check_init_rules`` on the CPU (the
    stacked per-layer vectors of ``mamba_layers``, ``enc_layers`` and
    ``dec_layers`` as ones or zeros, the conv taps at 0.02)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(FAMILIES) <= set(smoke.SERVE_FAMILIES)
    smoke.check_init_rules(smoke.SERVE_FAMILIES)
    assert smoke.init_rule(("mamba_layers", "conv_w"), (48, 4, 4352)) == 0.02
    assert smoke.init_rule(("dec_layers", "ln_x"), (6, 512)) == "ones"
    assert smoke.init_rule(("mamba_layers", "dt_bias"), (48, 64)) == "zeros"
