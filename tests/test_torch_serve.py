"""Port parity: the transformer family's MoE, MLA (+MTP) and VLM variants and
the serve steps (KV and latent caches, prefill, decode), on the CPU.

Each family runs its reference smoke config (fp32; 2 layers, d_model 64,
vocab 256): ``qwen3-moe-235b-a22b`` (8 experts, top-2, qk-norm),
``deepseek-v3-671b`` (MLA, a dense first layer, a shared expert, MTP) and
``qwen2-vl-7b`` (M-RoPE sections (4, 2, 2), a patch prefix).  The
reference's parameters are carried across with ``convert.from_reference``;
its outputs are computed once per family, jitted, in a module-scoped
fixture.

Contracts (fp32):
  * the tree: paths, shapes and dtypes (the fp32 router among the leaves);
  * ``train_loss`` within 1e-5, every gradient leaf rtol 1e-4 / atol 1e-6
    (the dense family's contract);
  * prefill's logits and whole cache, and 4 decode steps from the
    reference's own cache (logits each step, the cache after the last):
    rtol 1e-4 / atol 1e-5 (the same products in another summation order);
  * the MoE combine adds a token's k expert outputs in the reference's
    order, so ``apply_moe`` holds rtol 1e-5 / atol 1e-6 with capacity
    drops; a router tie goes to the lower expert id, as ``lax.top_k``;
  * MLA's absorbed decode against the reference's (rtol 1e-5 / atol 1e-6)
    and against the port's decompressed train path (the reference's
    contract, rtol 2e-3 / atol 2e-4);
  * ``apply_mrope`` rtol 1e-6 / atol 1e-6; a decode write at ``pos >=
    Smax`` lands in the last slot, as ``dynamic_update_slice`` clamps it;
  * one ``impl="auto"`` FedQCS train step (2 pods) from the reference's
    state: loss 1e-5, residual atol 1e-5, parameters within 2 lr (the dense
    family's contract).
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
from repro.models import common as jcommon  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.launch.mesh import make_single_device_mesh as j_single_mesh  # noqa: E402
from repro.models import sharding as jshard  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import from_reference, state_from_reference  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import sharding as tshard  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from torch_shared import shared as _shared, one_torch_thread  # noqa: E402,F401

FAMILIES = ["qwen3-moe-235b-a22b", "deepseek-v3-671b", "qwen2-vl-7b"]
TRANSFORMER_ARCHS = sorted(a for a in jreg.ARCHS
                           if jreg.get_config(a).family in ("dense", "moe", "vlm"))
B, S, SV, SMAX, DECODE = 2, 16, 4, 24, 4  # vlm: 4 patch + 12 text positions
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


def _ref_batch(cfg):
    """Tokens and labels from a seed; the VLM's patch prefix and three
    distinct M-RoPE streams (t; h and w over a 2 x 2 patch grid, then the
    text's shared positions)."""
    rng = np.random.default_rng(11)
    st = S - SV if cfg.family == "vlm" else S
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, st)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, st)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (rng.normal(size=(B, SV, cfg.d_model)) * 0.02).astype(np.float32)
        t = np.r_[np.zeros(SV), np.arange(S - SV) + 2]
        h = np.r_[np.arange(SV) // 2, np.arange(S - SV) + 2]
        w = np.r_[np.arange(SV) % 2, np.arange(S - SV) + 2]
        batch["positions"] = np.broadcast_to(np.stack([t, h, w])[:, None], (3, B, S)).astype(
            np.int32)
    return batch


def _port_batch(batch):
    return {k: torch.tensor(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def _splice(cache, smax):
    """A prefill cache grown to ``smax`` slots (zeros after the prompt)."""
    def grow(v):
        pad = [(0, 0)] * v.ndim
        pad[2] = (0, smax - v.shape[2])
        return np.pad(v, pad)
    return {k: grow(v) for k, v in cache.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request, tmp_path_factory):
    """One family's reference run: params, batch, loss and gradients,
    prefill, and DECODE greedy decode steps from its own spliced cache."""
    arch = request.param
    out = _shared(tmp_path_factory, f"serve_ref_{arch}", lambda: _ref_run(arch))
    return dict(out, cfg=jreg.smoke_config(arch))


def _ref_run(arch):
    cfg = jreg.smoke_config(arch)
    params = _np(jax.jit(lambda k: jmodel.init_params(cfg, k))(jax.random.PRNGKey(0)))
    batch = _ref_batch(cfg)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jmodel.train_loss(p, b, cfg)))(
        params, batch)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = jax.jit(lambda p, b: jmodel.prefill(p, b, cfg))(params, prompt)
    dec = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, cfg))
    start = _splice(_np(cache), SMAX)
    tok = np.argmax(np.asarray(logits)[:, -1], axis=-1).astype(np.int32)[:, None]
    c, toks, steps_ = start, [], []
    for t in range(DECODE):
        pos = S + t
        lo, c = dec(params, c, tok, jnp.int32(pos))
        toks.append(tok)
        steps_.append(np.asarray(lo))
        tok = np.argmax(np.asarray(lo)[:, -1], axis=-1).astype(np.int32)[:, None]
    return {"arch": arch, "params": params, "batch": batch, "loss": float(loss),
            "grads": _np(grads), "logits": np.asarray(logits), "cache": _np(cache),
            "start": start, "tokens": toks, "decode_logits": steps_, "end": _np(c)}


# ---------------------------------------------------------------------------
# per family: tree, loss and gradients, prefill, decode
# ---------------------------------------------------------------------------


def test_param_tree_matches_reference(fam):
    """Paths, shapes and dtypes of init_params at smoke size and at full
    width (meta tensors), and the sharding rules' spec of every leaf."""
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
    # the published dtype: bf16 leaves, and the MoE router in fp32
    dtypes = {path: leaf.dtype for path, leaf in tree_util.leaves(
        tmodel.init_params(registry.get_config(arch), device="meta"))}
    assert {path[-1] for path, dt in dtypes.items() if dt != torch.bfloat16} == (
        set() if arch == "qwen2-vl-7b" else {"router"})


def test_loss_and_gradients_match_reference(fam):
    cfg = registry.smoke_config(fam["arch"])
    loss, grads = steps.value_and_grad(from_reference(fam["params"])[0],
                                       _port_batch(fam["batch"]), cfg)
    assert abs(float(loss) - fam["loss"]) <= 1e-5
    want = _paths(fam["grads"])
    got = tree_util.leaves(grads)
    assert [p for p, _ in got] == list(want)
    for path, g in got:
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))


def test_prefill_matches_reference(fam):
    """Last-position logits and the whole cache (every layer's K/V or MLA
    latents over the prompt) through ``make_prefill_step``."""
    cfg = registry.smoke_config(fam["arch"])
    prompt = {k: v for k, v in _port_batch(fam["batch"]).items() if k != "labels"}
    logits, cache = steps.make_prefill_step(cfg, None)(from_reference(fam["params"])[0], prompt)
    np.testing.assert_allclose(logits.numpy(), fam["logits"], **FWD)
    assert sorted(cache) == sorted(fam["cache"])
    for k, v in cache.items():
        assert v.shape == fam["cache"][k].shape, k
        np.testing.assert_allclose(v.numpy(), fam["cache"][k], **FWD, err_msg=k)


def test_decode_matches_reference(fam):
    """DECODE steps of ``make_decode_step`` from the reference's spliced
    cache, each fed the reference's greedy token: logits each step, the
    greedy tokens, and the cache after the last."""
    cfg = registry.smoke_config(fam["arch"])
    params = from_reference(fam["params"])[0]
    cache = from_reference(fam["start"])[0]  # the reference's own cache
    fn = steps.make_decode_step(cfg, None)
    for t in range(DECODE):
        tok = torch.tensor(fam["tokens"][t].astype(np.int64))
        nxt, logits, cache = fn(params, cache, tok, S + t)
        np.testing.assert_allclose(logits.numpy(), fam["decode_logits"][t], **FWD,
                                   err_msg=f"step {t}")
        if t + 1 < DECODE:
            assert np.array_equal(nxt.numpy(), fam["tokens"][t + 1]), t
    for k, v in cache.items():
        np.testing.assert_allclose(v.numpy(), fam["end"][k], **FWD, err_msg=k)


# ---------------------------------------------------------------------------
# MoE, MLA, M-RoPE, the cache write
# ---------------------------------------------------------------------------


def test_apply_moe_drops_and_ties_match_reference():
    """A capacity factor of 0.5 (cap = int(64 * 2 / 8 * 0.5 + 1) = 9 of the
    16 pairs an expert gets on average: many drops) and a router whose
    columns 2 and 5 are equal (every token ties there): the port's output
    matches the reference's, the lower expert id wins each tie, and zeroed
    experts give exactly 0."""
    cfg = dataclasses.replace(jreg.smoke_config("deepseek-v3-671b"), capacity_factor=0.5)
    p = jax.tree_util.tree_map(np.array, jax.jit(lambda k: jmoe.init_moe(k, cfg))(
        jax.random.PRNGKey(5)))
    p["router"][:, 5] = p["router"][:, 2]
    x = (np.random.default_rng(6).normal(size=(4, 16, cfg.d_model)) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(lambda p_, x_: jmoe.apply_moe(p_, x_, cfg))(p, x))
    tcfg = dataclasses.replace(registry.smoke_config("deepseek-v3-671b"), capacity_factor=0.5)
    tp = from_reference(p)[0]
    got = tmoe.apply_moe(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    cap = tmoe.capacity(64, tcfg)
    assert cap == 9
    _, topi = tmoe.route(tp, torch.tensor(x).reshape(64, -1), tcfg)
    # of a tied pair, 5 is chosen only after 2 (when both make the top k)
    has5 = (topi == 5).any(1)
    assert torch.equal(topi[has5], torch.tensor([[2, 5]]).expand(int(has5.sum()), 2))
    assert int(((topi == 2).any(1) & ~has5).sum()) > 0
    _, se, _, dest = tmoe.dispatch(topi, cap, tcfg.n_experts)
    assert int((dest == tcfg.n_experts * cap).sum()) > 0  # drops happened
    zero = dict(tp, experts={k: torch.zeros_like(v) for k, v in tp["experts"].items()})
    del zero["shared"]
    assert torch.equal(tmoe.apply_moe(zero, torch.tensor(x), tcfg), torch.zeros_like(got))


def _mla_case():
    cfg = jreg.smoke_config("deepseek-v3-671b")
    lp = _np(jax.jit(lambda k: jmla.init_mla(k, cfg))(jax.random.PRNGKey(3)))
    x = (np.random.default_rng(4).normal(size=(2, 5, cfg.d_model)) * 0.1).astype(np.float32)
    return cfg, registry.smoke_config("deepseek-v3-671b"), lp, x


def test_mla_absorbed_decode_matches_reference_and_train_path():
    """Five absorbed decode steps from an empty latent cache: each step's
    output and the cache against the reference's; the last step's output
    against the port's decompressed train path over all five positions."""
    jcfg, tcfg, lp, x = _mla_case()
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    dec = jax.jit(lambda c, xt, pt, i: jmla.apply_mla_decode(lp, xt, pt, jcfg, c, i))
    jc = {"ckv": np.zeros((2, 5, jcfg.kv_lora_rank), np.float32),
          "kr": np.zeros((2, 5, jcfg.qk_rope_head_dim), np.float32)}
    tp = from_reference(lp)[0]
    tc = {k: torch.tensor(v) for k, v in jc.items()}
    tx, tpos = torch.tensor(x), torch.tensor(pos.astype(np.int64))
    for t in range(5):
        want, jc = dec(jc, x[:, t:t + 1], pos[:, t:t + 1], jnp.int32(t))
        got, tc = tmla.apply_mla_decode(tp, tx[:, t:t + 1], tpos[:, t:t + 1], tcfg, tc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-5, atol=1e-6)
    train = tmla.apply_mla_train(tp, tx, tpos, tcfg)
    np.testing.assert_allclose(got[:, 0].numpy(), train[:, -1].numpy(), rtol=2e-3, atol=2e-4)


def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    want = np.asarray(jcommon.apply_mrope(x, pos, 1e6, (4, 2, 2)))
    got = tcommon.apply_mrope(torch.tensor(x), torch.tensor(pos.astype(np.int64)), 1e6, (4, 2, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        tcommon.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e6, (4, 2, 1))


@pytest.mark.parametrize("pos", [0, 3, 5, 9])
def test_cache_write_clamps_like_dynamic_update_slice(pos):
    """``update_slot`` at every kind of ``pos`` (inside, the last slot,
    past the end) against ``jax.lax.dynamic_update_slice``; past the end,
    a decode step writes the last slot and attends to every slot."""
    buf = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    new = -np.ones((2, 1, 3), np.float32)
    want = np.asarray(jax.lax.dynamic_update_slice(buf, new, (0, pos, 0)))
    got = tcommon.update_slot(torch.tensor(buf), torch.tensor(new), torch.tensor(pos))
    assert np.array_equal(got.numpy(), want)
    assert bool(tcommon.valid_slots(6, pos, "cpu").all()) == (pos >= 5)


@pytest.fixture(scope="module")
def clamp_case(tmp_path_factory):
    """The reference's decode step at pos 7 into a random cache of 6 slots."""
    return _shared(tmp_path_factory, "serve_ref_clamp", _ref_clamp)


def _ref_clamp():
    cfg = jreg.smoke_config("qwen2-vl-7b")
    params = _np(jax.jit(lambda k: jmodel.init_params(cfg, k))(jax.random.PRNGKey(0)))
    cache = _np(jax.jit(lambda: jmodel.init_cache(cfg, B, 6))())
    cache = jax.tree_util.tree_map(
        lambda v: np.random.default_rng(2).normal(size=v.shape).astype(np.float32), cache)
    tok = np.array([[3], [7]], np.int32)
    lo, new = jax.jit(lambda p, c, t, i: jmodel.decode_step(p, c, t, i, cfg))(
        params, cache, tok, jnp.int32(7))
    return params, cache, tok, np.asarray(lo), _np(new)


def test_decode_at_pos_past_smax_matches_reference(clamp_case):
    params, cache, tok, want_lo, want_cache = clamp_case
    cfg = registry.smoke_config("qwen2-vl-7b")
    lo, new = tmodel.decode_step(from_reference(params)[0], from_reference(cache)[0],
                                 torch.tensor(tok.astype(np.int64)), 7, cfg)
    np.testing.assert_allclose(lo.numpy(), want_lo, **FWD)
    for k in new:
        np.testing.assert_allclose(new[k].numpy(), want_cache[k], **FWD, err_msg=k)
        assert np.array_equal(new[k][:, :, :5].numpy(), cache[k][:, :, :5])


# ---------------------------------------------------------------------------
# the serve steps, the specs, the layout of a mixed-dtype tree, the entry
# points
# ---------------------------------------------------------------------------


def test_donated_decode_writes_only_slot_pos(fam):
    """``donate=True`` writes the caller's cache in place, slot ``pos`` and
    no other, bit for bit as ``donate=False``, which leaves its input as it
    was."""
    if fam["arch"] == "qwen2-vl-7b":
        return  # the GQA cache is the MoE family's; one of each kind of cache
    cfg = registry.smoke_config(fam["arch"])
    params = from_reference(fam["params"])[0]
    before = from_reference(fam["start"])[0]
    tok = torch.tensor(fam["tokens"][0].astype(np.int64))
    kept = tree_util.tree_map(torch.clone, before)
    nxt_k, lo_k, out_k = steps.make_decode_step(cfg, None, donate=False)(params, before, tok, S)
    assert all(torch.equal(before[k], kept[k]) for k in before)
    donated = tree_util.tree_map(torch.clone, before)
    nxt_d, lo_d, out_d = steps.make_decode_step(cfg, None)(params, donated, tok, S)
    assert all(out_d[k] is donated[k] for k in donated)
    assert torch.equal(lo_d, lo_k) and torch.equal(nxt_d, nxt_k)
    for k in before:
        assert torch.equal(out_d[k], out_k[k]), k
        changed = (out_d[k] != kept[k]).flatten(3).any(-1).any(0).any(0)  # per slot
        assert changed.nonzero().flatten().tolist() == [S], k


@pytest.mark.parametrize("shape", sorted(jmodel.SHAPES))
@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_input_specs_and_supports_cell_match_reference(arch, shape):
    """Every (arch x shape) of the transformer family: the same names,
    shapes and dtypes (the reference's int32 ids are int64 here), and the
    same verdict and reason."""
    assert tmodel.supports_cell(registry.get_config(arch), shape) == jmodel.supports_cell(
        jreg.get_config(arch), shape)
    want = _paths(jmodel.input_specs(jreg.get_config(arch), shape))
    got = tree_util.leaves(tmodel.input_specs(registry.get_config(arch), shape))
    assert sorted(p for p, _ in got) == sorted(want)
    for path, spec in got:
        assert spec.shape == tuple(want[path].shape), path
        jdt = str(want[path].dtype)
        assert str(spec.dtype).replace("torch.", "") == ("int64" if jdt == "int32" else jdt)


def test_make_batch_fills_the_vlm_specs():
    cfg = registry.smoke_config("qwen2-vl-7b")
    batch = tmodel.make_batch(cfg, "train_4k", seed=1, device="cpu")
    specs = tmodel.input_specs(cfg, "train_4k")
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: (s.shape, s.dtype) for k, s in specs.items()}
    assert torch.equal(batch["positions"][2, 1], torch.arange(4096))
    assert int(batch["tokens"].max()) < cfg.vocab_size
    dec = tmodel.make_batch(cfg, "decode_32k", device="meta")
    assert dec["cache"]["k"].shape == (2, 128, 32768, 2, 16)


def test_mixed_dtype_tree_blocks_match_reference():
    """A bf16 MoE tree with its fp32 router through both packages'
    monolithic layouts: the same rows bit for bit, and each leaf back in
    its own dtype."""
    cfg = dataclasses.replace(jreg.smoke_config("deepseek-v3-671b"), dtype="bfloat16")
    shapes = jax.eval_shape(lambda k: jmodel.init_params(cfg, k), jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda sd: jnp.asarray(rng.normal(size=sd.shape).astype(np.float32), sd.dtype), shapes)
    blocks_j, _, _ = jcomp.flatten_to_blocks(tree, 255, row_multiple=512)
    tt = from_reference(_np(tree))[0]
    blocks_t, layout, _ = tcomp.flatten_to_blocks(tt, 255, row_multiple=512)
    assert np.array_equal(blocks_t.numpy(), np.asarray(blocks_j))
    back = tcomp.blocks_to_tree(blocks_t, layout)
    for path, leaf in tree_util.leaves(tt):
        got = tree_util.get(back, path)
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), path


def test_serve_example_on_the_cpu(capsys):
    """``examples/serve_lm_torch.py`` for an MoE arch (prefill, splice to
    smax, greedy decode), the SSM (its O(1) state kept as it is) and the
    audio family (a prompt of frames)."""
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", os.path.join(ROOT, "examples", "serve_lm_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    args = ["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--tokens", "5"]
    example.main(args + ["--arch", "qwen3-moe-235b-a22b"])
    assert "qwen3-moe-235b-a22b: decoded (2, 5) tokens" in capsys.readouterr().out
    for arch in ("mamba2-1.3b", "whisper-base"):
        example.main(args + ["--arch", arch])
        assert f"{arch}: decoded (2, 5) tokens" in capsys.readouterr().out


def test_launcher_pod_mode_on_the_moe_family(tmp_path, capfd):
    """``python -m repro_torch.launch.train --arch qwen3-moe-235b-a22b
    --smoke --fedqcs``, 2 pods, 2 steps, on the CPU: the reference's (2, 2,
    2) world (rank 0 prints: its lines reach the file descriptor)."""
    tlaunch.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--fedqcs", "--pods", "2",
                  "--device", "cpu", "--steps", "2", "--log-every", "1", "--batch", "4",
                  "--seq", "16", "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert "mesh={'pod': 2, 'data': 2, 'model': 2}" in out
    assert "[train] done" in out and out.count("loss") == 2
    losses = [float(line.split("loss")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step")]
    assert all(np.isfinite(losses))


def _step_batch(cfg):
    """8 sequences of 12 tokens; the VLM's 4 patches and M-RoPE positions
    that differ from row to row (the pods split them along their second
    dim)."""
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 12)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (8, 12)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (rng.normal(size=(8, 4, cfg.d_model)) * 0.02).astype(np.float32)
        batch["positions"] = (np.arange(16, dtype=np.int32)[None, None]
                              + 3 * np.arange(8, dtype=np.int32)[None, :, None]
                              + np.arange(3, dtype=np.int32)[:, None, None])
    return batch


def _ref_step(arch):
    """The reference's initial state (two pods), one impl="auto" step on
    its single-device mesh, and its sensing matrix."""
    cfg = jreg.smoke_config(arch)
    fed, opt = jcomp.FedQCSConfig(**FED_KW), jadam.OptConfig(**OPT_KW)
    mesh = j_single_mesh()
    state = _np(jax.jit(lambda k: jsteps.init_train_state(cfg, opt, fed, k, n_pods=2,
                                                          mesh=mesh))(jax.random.PRNGKey(0)))
    batch = _step_batch(cfg)
    new, m = jsteps.make_train_step(cfg, opt, fed, mesh, donate=False)(state, batch)
    return {"state": state, "batch": batch, "new": _np(new), "loss": float(m["loss"]),
            "a": np.asarray(jcomp.BQCSCodec(fed).a)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch, tmp_path_factory):
    """``make_train_step(impl="auto")`` over each new family's tree (the
    fp32 router, ``layers_dense``, ``mtp``; the VLM's patches and
    positions split across the pods) from the reference's state."""
    ref = _shared(tmp_path_factory, f"serve_step_{arch}", lambda: _ref_step(arch))
    state = state_from_reference(ref["state"])
    state["step"] = state["step"].to(torch.int32)
    fn = steps.make_train_step(registry.smoke_config(arch), tadam.OptConfig(**OPT_KW),
                               tcomp.FedQCSConfig(**FED_KW), tmesh.make_single_device_mesh(),
                               device="cpu", a=torch.tensor(ref["a"]))
    new, m = fn(state, _port_batch(ref["batch"]))
    assert abs(float(m["loss"]) - ref["loss"]) <= 1e-5
    np.testing.assert_allclose(new["residual"].numpy(), ref["new"]["residual"], rtol=0,
                               atol=1e-5)
    want = _paths(ref["new"]["params"])
    worst = max(float(np.max(np.abs(p.numpy() - want[path])))
                for path, p in tree_util.leaves(new["params"]))
    assert worst <= 2 * OPT_KW["lr"], worst
