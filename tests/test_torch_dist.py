"""Port parity: the pod collective, the chunked decode over a mesh axis and
the ``impl="shard_map"`` train step, over two ``gloo`` processes on the CPU.

Inputs: two pods' gradient blocks and residuals (6 rows of N = 256, drawn
with numpy from a seed) and the reference codec's sensing matrix, at the
reference's system-test point (``tests/test_system.py``'s ``FED``: N = 256,
R = 2, Q = 4, S = 20, 15 scalar-variance GAMP iterations).  The reference
runs its collectives on a one-axis pod mesh of two host devices (what its
own passing pod-mesh tests run); its ``impl="shard_map"`` step on the
2 x 2 x 2 mesh aborts inside XLA's SPMD partitioner, so the port's 2-rank
step is held against the port's ``impl="auto"`` (the reference's own
contract between the two impls).  The two ranks run once for the module
(``tests/torch_dist_worker.py``), started with ``spawn`` and a ``file://``
rendezvous under the module's temporary directory.

Contracts:
  * wire words: a code differs only where y lies within 1e-5 of a
    threshold (the count is printed; 0 expected); alpha and residual to
    1e-6;
  * the aggregate: NMSE <= 1e-4 relative to the reference's, for
    ``fedqcs_vmapped_allreduce`` (AE, EA) and the 2-rank
    ``fedqcs_pod_allreduce`` (gather_codes AE and EA, psum_dequant AE), on
    the plain and the kernel route; every rank decodes the same aggregate;
  * dead pod: the aggregate ignores its payload bit for bit, its residual
    is blocks + residual bit for bit;
  * shard_map vs auto: loss within 1e-5, residual 1e-5, parameters within
    2 lr after each of three steps, each from the same state;
  * the chunked decode over two ranks equals the single-process decode.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dist_worker  # noqa: E402
from repro import jax_compat  # noqa: E402
from repro.core import aggregator as jagg  # noqa: E402
from repro.core.compression import BQCSCodec as JCodec  # noqa: E402
from repro.core.compression import FedQCSConfig as JFed  # noqa: E402
from repro.runtime import collectives as jcoll  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.core import recon_engine  # noqa: E402
from repro_torch.core.compression import BQCSCodec  # noqa: E402
from repro_torch.core.compression import FedQCSConfig  # noqa: E402
from repro_torch.core.reconstruction import gamp_config_from  # noqa: E402
from repro_torch.data.synthetic import TokenDataset  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_single_device_mesh  # noqa: E402
from repro_torch.optim.adam import OptConfig  # noqa: E402
from repro_torch.runtime import collectives as tcoll  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

FED_KW = dict(block_size=256, reduction_ratio=2, bits=4, s_ratio=0.08, gamp_iters=15,
              gamp_variance_mode="scalar")
N, NB, PODS = 256, 6, 2
OPT = OptConfig(lr=3e-3, warmup_steps=2, decay_steps=100)
ROUTES = [pytest.param(False, id="plain"), pytest.param(True, id="kernel")]
WIRES = [("gather_codes", "ae"), ("gather_codes", "ea"), ("psum_dequant", "ae")]


def nmse(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.sum((x - ref) ** 2) / np.sum(ref ** 2))


def _inputs():
    rng = np.random.default_rng(3)
    blocks = rng.normal(0, 1, (PODS, NB, N)).astype(np.float32)
    resid = rng.normal(0, 0.1, (PODS, NB, N)).astype(np.float32)
    garbage = rng.normal(0, 50.0, (NB, N)).astype(np.float32)
    return blocks, resid, garbage


def _port_codec(a, **kw):
    return BQCSCodec(FedQCSConfig(**{**FED_KW, **kw}), a=torch.tensor(a), device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_pods(kernels: bool):
    """The reference's fedqcs_pod_allreduce for every wire of WIRES on one
    route, on a one-axis pod mesh of two host devices, all under one jit
    (one compile a route) -> {(wire, mode): (pod 0's aggregate, (pods, nb,
    N) residuals)}."""
    blocks, resid, _ = _inputs()
    codecs = [JCodec(JFed(**FED_KW, wire_mode=w, recon_mode=m, use_kernels=kernels))
              for w, m in WIRES]
    mesh = JMesh(np.array(jax.devices()[:PODS]), ("pod",))
    smap = jax.jit(jax_compat.shard_map(
        lambda b, r: tuple(jcoll.fedqcs_pod_allreduce(b, r, c) for c in codecs),
        mesh=mesh, in_specs=(P("pod"), P("pod")),
        out_specs=tuple((P("pod"), P("pod")) for _ in codecs),
        axis_names={"pod"}, check_vma=False,
    ))
    with jax_compat.set_mesh(mesh):
        outs = smap(jnp.asarray(blocks.reshape(-1, N)), jnp.asarray(resid.reshape(-1, N)))
    got = {}
    for wire, (ghat, res) in zip(WIRES, outs):
        ghat = np.asarray(ghat)
        assert np.array_equal(ghat[:NB], ghat[NB:])  # every pod decodes the same aggregate
        got[wire] = ghat[:NB], np.asarray(res).reshape(PODS, NB, N)
    return got


@functools.lru_cache(maxsize=None)
def _ref_vmapped(kernels: bool):
    """The reference's fedqcs_vmapped_allreduce, AE and EA on one route,
    under one jit -> {mode: (aggregate, residuals)}."""
    blocks, resid, _ = _inputs()
    codecs = {m: JCodec(JFed(**FED_KW, recon_mode=m, use_kernels=kernels)) for m in ("ae", "ea")}
    part = jnp.ones(PODS, jnp.float32)
    outs = jax.jit(lambda b, r: {m: jcoll.fedqcs_vmapped_allreduce(b, r, c, part)
                                 for m, c in codecs.items()})(jnp.asarray(blocks),
                                                              jnp.asarray(resid))
    return {m: (np.asarray(g), np.asarray(r)) for m, (g, r) in outs.items()}


@pytest.fixture(scope="module")
def ref_a():
    return np.asarray(JCodec(JFed(**FED_KW)).a)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ref_a):
    """Runs the two ranks once; returns (inputs, [rank 0 out, rank 1 out])."""
    import multiprocessing

    tmp = tmp_path_factory.mktemp("gloo")
    blocks, resid, garbage = _inputs()
    cfg = smoke_config("qwen3-0.6b")
    fed = FedQCSConfig(**FED_KW)
    a = torch.tensor(ref_a)
    auto = steps.make_train_step(cfg, OPT, fed, make_single_device_mesh(), device="cpu", a=a)
    ds = TokenDataset(cfg.vocab_size, batch=16, seq=32, seed=7)
    state = steps.init_train_state(cfg, OPT, fed, 0, n_pods=PODS, device="cpu")
    auto_states, auto_out, batches = [], [], []
    for t in range(3):
        batches.append(ds.get_batch(t, device="cpu"))
        auto_states.append(state)
        state, metrics = auto(state, batches[-1])
        auto_out.append((state, metrics))
    ea = _port_codec(ref_a, recon_mode="ea")
    enc = [ea.compress_blocks_packed(torch.tensor(blocks[p]), torch.tensor(resid[p]))
           for p in range(PODS)]
    inp = {"fed": fed, "a": a, "blocks": torch.tensor(blocks), "resid": torch.tensor(resid),
           "garbage": torch.tensor(garbage), "model_cfg": cfg, "opt": OPT,
           "auto_states": auto_states, "batches": batches,
           "words": torch.stack([e[0] for e in enc]), "alpha": torch.stack([e[1] for e in enc])}
    torch.save(inp, tmp / "in.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, PODS, str(tmp / "rendezvous"), str(tmp / "in.pt"), str(tmp)))
             for r in range(PODS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(PODS)]
    return inp, outs, auto_out


@pytest.mark.parametrize("kernels", ROUTES)
def test_wire_words_meet_the_encoder_contract(kernels, ref_a):
    """The port's encoder against the reference's on each pod's blocks."""
    blocks, resid, _ = _inputs()
    tc = _port_codec(ref_a, use_kernels=kernels)
    jc = JCodec(JFed(**FED_KW, use_kernels=kernels))
    thresholds = np.asarray(tc.codebook.thresholds, np.float32)
    n_diff = 0
    for p in range(PODS):
        tw, ta, tr = tc.compress_blocks_packed(torch.tensor(blocks[p]), torch.tensor(resid[p]))
        jw, ja, jr = jax.jit(jc.compress_blocks_packed)(jnp.asarray(blocks[p]),
                                                        jnp.asarray(resid[p]))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
        codes_t, codes_j = tc.unpack(tw).numpy(), np.asarray(jc.unpack(jw))
        diff = codes_t != codes_j
        if diff.any():
            sparse = (blocks[p] + resid[p]) - tr.numpy()
            y = (ta.numpy()[:, None] * sparse) @ ref_a.T
            gap = np.min(np.abs(y[..., None] - thresholds), axis=-1)
            assert gap[diff].max() < 1e-5, gap[diff].max()
        n_diff += int(diff.sum())
    print(f"differing wire lanes: {n_diff} of {PODS * NB * codes_t.shape[1]}")


@pytest.mark.parametrize("kernels", ROUTES)
@pytest.mark.parametrize("mode", ["ae", "ea"])
def test_vmapped_allreduce_matches_reference(mode, kernels, ref_a):
    blocks, resid, _ = _inputs()
    kw = dict(recon_mode=mode, use_kernels=kernels)
    part = np.ones(PODS, np.float32)
    ghat_j, res_j = _ref_vmapped(kernels)[mode]
    ghat_t, res_t = tcoll.fedqcs_vmapped_allreduce(
        torch.tensor(blocks), torch.tensor(resid), _port_codec(ref_a, **kw), torch.tensor(part))
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=0, atol=1e-6)
    assert nmse(ghat_t.numpy(), ghat_j) <= 1e-4


@pytest.mark.parametrize("kernels", ROUTES)
@pytest.mark.parametrize("wire,mode", WIRES)
def test_pod_allreduce_matches_reference(wire, mode, kernels, ranks, ref_a):
    """Two gloo ranks against the reference's two-device pod mesh."""
    _, outs, _ = ranks
    blocks, resid, _ = _inputs()
    ghat_j, res_j = _ref_pods(kernels)[(wire, mode)]
    (g0, r0), (g1, r1) = (out["pod"][(kernels, wire, mode)] for out in outs)
    assert torch.equal(g0, g1)
    np.testing.assert_allclose(torch.stack([r0, r1]).numpy(), res_j, rtol=0, atol=1e-6)
    assert nmse(g0.numpy(), ghat_j) <= 1e-4


def test_dead_pod_contracts_hold_bit_for_bit(ranks, ref_a):
    """Pod 1 dead: the aggregate ignores its payload exactly (garbage and
    zero blocks decode alike, on both ranks), its residual is its full
    carry, and pod 0's residual does not depend on it.  The same through
    the single-process collective."""
    inp, outs, _ = ranks
    blocks, resid, garbage = (inp[k].numpy() for k in ("blocks", "resid", "garbage"))
    (g0a, r0a), (g0z, r0z) = outs[0]["dead"]["garbage"], outs[0]["dead"]["zeros"]
    (g1a, r1a), (g1z, _) = outs[1]["dead"]["garbage"], outs[1]["dead"]["zeros"]
    assert torch.equal(g0a, g0z) and torch.equal(g0a, g1a) and torch.equal(g0a, g1z)
    assert torch.equal(r0a, r0z)
    assert np.array_equal(r1a.numpy(), garbage + resid[1])
    codec = _port_codec(ref_a)
    part = torch.tensor([1.0, 0.0])
    runs = [tcoll.fedqcs_vmapped_allreduce(torch.tensor(np.stack([blocks[0], dead])),
                                           torch.tensor(resid), codec, part)
            for dead in (garbage, np.zeros_like(garbage))]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1][0], runs[1][1][0])
    assert np.array_equal(runs[0][1][1].numpy(), garbage + resid[1])


def test_ea_rejections_carry_the_reference_texts(ranks, ref_a):
    """EA with psum_dequant (the pod collective) and EA in the per-shard
    path raise ValueError with the reference's messages."""
    _, outs, _ = ranks
    with pytest.raises(ValueError) as want_psum:
        JCodec(JFed(**FED_KW, recon_mode="ea", wire_mode="psum_dequant"))
    assert outs[0]["ea_psum_error"] == outs[1]["ea_psum_error"] == str(want_psum.value)
    with pytest.raises(ValueError) as want_sharded:
        jcoll.make_sharded_allreduce(JCodec(JFed(**FED_KW, recon_mode="ea")), None, [(4,)], 4)
    with pytest.raises(ValueError) as got:
        tcoll.make_sharded_allreduce(_port_codec(ref_a, recon_mode="ea"), None, [(4,)], 4)
    assert str(got.value) == str(want_sharded.value)


def test_partial_fold_and_finalize_match_reference(ref_a):
    """Two folded payload batches and the finalize decode, both packages."""
    blocks, resid, _ = _inputs()
    tc, jc = _port_codec(ref_a), JCodec(JFed(**FED_KW))
    enc_t = [tc.compress_blocks_packed(torch.tensor(blocks[p]), torch.tensor(resid[p]))
             for p in range(PODS)]
    enc_j = [jax.jit(jc.compress_blocks_packed)(jnp.asarray(blocks[p]), jnp.asarray(resid[p]))
             for p in range(PODS)]
    st_t = st_j = None
    for p, w in enumerate((0.7, 1.3)):
        st_t = tcoll.fedqcs_partial_fold(st_t, enc_t[p][0][None], enc_t[p][1][None],
                                         torch.tensor([w]), tc)
        st_j = jcoll.fedqcs_partial_fold(st_j, enc_j[p][0][None], enc_j[p][1][None],
                                         jnp.asarray([w]), jc)
    for field in ("y", "nu", "energy", "wsum", "count"):
        np.testing.assert_allclose(getattr(st_t, field).numpy(),
                                   np.asarray(getattr(st_j, field)), rtol=1e-5, atol=1e-7)
    assert isinstance(st_j, jagg.PartialStats)
    got = tcoll.fedqcs_partial_finalize(st_t, tc)
    want = jax.jit(lambda st: jcoll.fedqcs_partial_finalize(st, jc))(st_j)
    assert nmse(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("step", [0, 1, 2])
def test_shard_map_step_matches_auto(step, ranks):
    """One 2-rank shard_map step from the auto run's state before it."""
    _, outs, auto_out = ranks
    want_state, want_metrics = auto_out[step]
    got = [out["steps"][step] for out in outs]
    assert abs(float(got[0]["loss"]) - float(want_metrics["loss"])) <= 1e-5
    assert float(got[0]["loss"]) == float(got[1]["loss"])
    res = torch.cat([g["residual"] for g in got])
    np.testing.assert_allclose(res.numpy(), want_state["residual"].numpy(), rtol=0, atol=1e-5)
    worst = max(float(torch.max(torch.abs(p.float() - tree_util.get(want_state["params"], path)
                                          .float())))
                for path, p in tree_util.leaves(got[0]["params"]))
    assert worst <= 2 * OPT.lr, worst


def test_chunked_decode_over_two_ranks_equals_one_process(ranks, ref_a):
    inp, outs, _ = ranks
    ea = _port_codec(ref_a, recon_mode="ea")
    rhos = torch.full((PODS,), 1.0 / PODS)
    want = recon_engine.ea_decode(ea, inp["words"], inp["alpha"], rhos, gamp_config_from(ea),
                                  packed=True, chunk=3)
    assert torch.equal(outs[0]["chunked"], want) and torch.equal(outs[1]["chunked"], want)


def test_a_world_size_off_the_pod_axis_raises(tmp_path):
    """The pod axis needs as many processes as pods: a one-process group
    under a 2-pod mesh raises, and so does a mesh with no group at all."""
    import torch.distributed as dist

    cfg, fed = smoke_config("qwen3-0.6b"), FedQCSConfig(**FED_KW)
    with pytest.raises(RuntimeError, match="initialize torch.distributed"):
        steps.make_train_step(cfg, OPT, fed, make_debug_mesh(2), impl="shard_map", device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="holds 1 processes"):
            steps.make_train_step(cfg, OPT, fed, make_debug_mesh(2), impl="shard_map",
                                  device="cpu")
    finally:
        dist.destroy_process_group()
