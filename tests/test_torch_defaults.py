"""Port parity with the port's defaults alone: a seed gives the reference's
random state, with no state carried across (no ``convert.from_reference``)
and no draw injected (no ``CohortEngine(draw=...)``).

Held bit for bit against the reference's own calls from the same seed:
the sensing matrix (the paper's 530 x 1591 and the model zoo's 85 x 255),
the MLP's initial parameters, QCS-Dither's signs, rows and dither, the
synthetic ``TokenDataset`` batches and ``TokenClientData``'s cohort
batches, ``make_batch`` of every family, and the engine's default draw
seam (``seeded_draw``) for every purpose against the reference engine's
key path (``tests/torch_fed_parity.py::reference_draw``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import sensing as jsensing  # noqa: E402
from repro.data.synthetic import TokenDataset as JTokenDataset  # noqa: E402
from repro.fed import engine as jeng  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.paper import mlp as jmlp  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core import baselines as tbaselines  # noqa: E402
from repro_torch.core import sensing as tsensing  # noqa: E402
from repro_torch.data.synthetic import TokenDataset as TTokenDataset  # noqa: E402
from repro_torch.fed import engine as teng  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.paper import mlp as tmlp  # noqa: E402

from torch_fed_parity import reference_draw  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("qwen3-0.6b", "qwen3-moe-235b-a22b", "deepseek-v3-671b", "qwen2-vl-7b",
         "mamba2-1.3b", "zamba2-2.7b", "whisper-base")


def _bits(x) -> np.ndarray:
    """Raw words: float patterns (f32 or bf16) as ints, ints widened."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().astype(np.int64)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "f" or x.dtype == jax.numpy.bfloat16:
        return x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize]).astype(np.int64)
    return x.astype(np.int64)


def _same(got, want):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert int(np.sum(g != w)) == 0, f"{int(np.sum(g != w))} of {w.size} differ"


@pytest.mark.parametrize("seed", [0, 1234, 7])
@pytest.mark.parametrize("m,n", [(530, 1591), (85, 255)])
def test_sensing_matrix_is_the_references(seed, m, n):
    _same(tsensing.sensing_matrix(seed, m, n, device="cpu"),
          jsensing.sensing_matrix(jax.random.PRNGKey(seed), m, n))


@pytest.mark.parametrize("seed", [0, 3])
def test_init_mlp_is_the_references(seed):
    want = jmlp.init_mlp(jax.random.PRNGKey(seed))
    got = tmlp.init_mlp(seed, device="cpu")
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])


def test_qcs_dither_state_and_draws_are_the_references():
    """The signs and rows from ``PRNGKey(seed)``, and a client's dither from
    the round key folded with its id, as the reference engine draws it."""
    for n, m, seed in ((2048, 512, 7), (64, 16, 3)):
        j = jbaselines.DitherCodec(n=n, m=m, bits=3, seed=seed)
        t = tbaselines.DitherCodec(n=n, m=m, bits=3, seed=seed)
        _same(t.rademacher, j.rademacher)
        _same(t.rows, j.rows)
    blocks = np.random.default_rng(0).normal(size=(3, 2048)).astype(np.float32)
    j = jbaselines.DitherCodec(n=2048, m=512, bits=3)
    t = tbaselines.DitherCodec(n=2048, m=512, bits=3)
    kr = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    _, delta_j, dither_j = j.compress(blocks, jax.random.fold_in(kr, 5))
    unit = teng.seeded_draw(0, 2, "dither", (3, 512), client=5)
    _, delta_t, dither_t = t.compress(torch.tensor(blocks), unit)
    np.testing.assert_allclose(delta_t.numpy(), np.asarray(delta_j), rtol=1e-6)
    np.testing.assert_allclose(dither_t.numpy(), np.asarray(dither_j), rtol=1e-6, atol=0)


@pytest.mark.parametrize("purpose,shape,client", [
    ("gain", (30,), None), ("h", (8, 30), None), ("h_err", (8, 30), None),
    ("noise", (10, 530), None), ("noise", (10, 530), 7), ("dither", (6, 16), 11),
    ("batch_noise", (8, 2, 53), 2), ("noise", (3, 53), [7, 0, 29]),
    ("dither", (2, 16), np.array([11, 4]))])
@pytest.mark.parametrize("seed,t", [(0, 0), (5, 3)])
def test_seeded_draw_is_the_reference_engines(purpose, shape, client, seed, t):
    """Every purpose, one client or a cohort's (one draw a client, stacked,
    as the reference vmaps over its client keys)."""
    got = teng.seeded_draw(seed, t, purpose, shape, client)
    _same(got, reference_draw(seed)(t, purpose, shape, client))
    if np.ndim(client):
        for row, c in zip(got, client):
            _same(row, teng.seeded_draw(seed, t, purpose, shape, int(c)))


def test_seeded_draw_rejects_an_unknown_purpose():
    with pytest.raises(ValueError, match="purpose"):
        teng.seeded_draw(0, 0, "fading", (3,))


@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (5, 1, 2), (9, 3, 4)])
def test_token_dataset_batches_are_the_references(step, shard, n_shards):
    want = JTokenDataset(151936, batch=8, seq=20, seed=1).get_batch(step, shard, n_shards)
    got = TTokenDataset(151936, batch=8, seq=20, seed=1).get_batch(step, shard, n_shards,
                                                                   device="cpu")
    for k in ("tokens", "labels"):
        _same(got[k], want[k])


@pytest.mark.parametrize("alpha", [0.0, 0.01])
def test_token_client_data_cohort_batches_are_the_references(alpha):
    kw = dict(vocab_size=97, batch=4, seq=16, clients=6, alpha=alpha, seed=1)
    jd, td = jeng.TokenClientData(**kw), teng.TokenClientData(**kw, device="cpu")
    for r, ids in ((0, np.arange(6)), (3, np.array([4, 0, 2]))):
        want, got = jd.cohort_batch(r, ids), td.cohort_batch(r, ids)
        for k in ("tokens", "labels"):
            _same(got[k], want[k])


# small shape cells registered in both packages for the test (the published
# cells' batches hold up to 10**8 draws)
SMALL_CELLS = {"train_small": ("train", 40, 3), "decode_small": ("decode", 24, 2)}


@pytest.fixture
def small_cells(monkeypatch):
    for name, (kind, seq, batch) in SMALL_CELLS.items():
        monkeypatch.setitem(jmodel.SHAPES, name, jmodel.ShapeCell(name, kind, seq, batch))
        monkeypatch.setitem(tmodel.SHAPES, name, tmodel.ShapeCell(name, kind, seq, batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_is_the_references(arch, small_cells):
    """The same key for every leaf, as the reference fills its specs: a
    train cell's tokens, labels, patches, positions or frames, and a decode
    cell's token, position and cache."""
    shapes = ["train_small"] + (["decode_small"] if arch in ("qwen3-0.6b", "mamba2-1.3b")
                                else [])
    for shape in shapes:
        want = jmodel.make_batch(jregistry.smoke_config(arch), shape, jax.random.PRNGKey(2))
        got = tmodel.make_batch(tregistry.smoke_config(arch), shape, seed=2, device="cpu")
        flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert set(flat_w) == set(flat_g)
        for path, w in flat_w.items():
            _same(flat_g[path], w)
