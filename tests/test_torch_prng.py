"""Port parity: ``repro_torch.prng`` against ``jax.random`` (threefry2x32,
``jax_threefry_partitionable``), on the CPU.

Keys, ``split``, ``fold_in``, bits, uniforms, Bernoulli draws, integers,
categorical draws, permutations and choices must be bit-identical to
JAX's, batched keys to ``jax.vmap`` over keys.  ``normal``,
``exponential`` and the Gumbel draw see only the 2**23 floats that
``uniform`` can give (23 bits of each word), so their transforms are held
against JAX's on every one of those inputs: bit-identical too.  JAX's side
of the exhaustive check is the same chain of ``lax`` operations as
``jax/_src/random.py``'s ``_uniform`` and its callers; that chain is held
to the real ``jax.random`` draws first.  ``chip_smoke.py``'s golden table
is held against JAX's output here, so the card's check of it is a check
against JAX.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro_torch import prng  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = float(np.finfo(np.float32).tiny)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _words(x) -> np.ndarray:
    """A draw's raw words: int64 for keys, bits and integers, the int32
    pattern of floats, so equality is bit equality."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.int32).astype(np.int64)
    return x.astype(np.int64)


def _same(got, want):
    got, want = _words(got), _words(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = int(np.sum(got != want))
    assert bad == 0, f"{bad} of {want.size} differ"


def _jkey(seed=42):
    return jax.random.PRNGKey(seed)


def test_threefry_partitionable_flag_is_on():
    """The port follows the partitionable layout of split and bits only: a
    JAX with the flag off draws other numbers, and must fail here."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_answers(key, count, want):
    got = prng.threefry2x32(key[0], key[1], count[0], count[1])
    assert (int(got[0]), int(got[1])) == want
    from jax._src import prng as jprng
    jout = jprng.threefry_2x32(np.array(key, np.uint32), np.array(count, np.uint32))
    assert tuple(int(v) for v in np.asarray(jout)) == want


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**31, 2**32 - 1])
def test_prng_key(seed):
    _same(prng.key_data(prng.PRNGKey(seed)), jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 4, 5, 8, 28])
def test_split(num):
    _same(prng.split(prng.PRNGKey(42), num), jax.random.key_data(jax.random.split(_jkey(), num)))


@pytest.mark.parametrize("data", [0, 1, 7, 2**31])
def test_fold_in(data):
    _same(prng.fold_in(prng.PRNGKey(42), data),
          jax.random.key_data(jax.random.fold_in(_jkey(), data)))
    with pytest.raises(ValueError, match="uint32"):
        prng.fold_in(prng.PRNGKey(42), -1)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 4), (2**20 + 3,)])
def test_random_bits(shape, monkeypatch):
    """Chunks of 2**18 elements: the last shape's draw spans five of them."""
    monkeypatch.setattr(prng, "CPU_CHUNK", 1 << 18)
    _same(prng.random_bits(prng.PRNGKey(42), shape), jax.random.bits(_jkey(), shape, jnp.uint32))


def test_random_bits_slice_recomputes_on_its_own():
    want = np.asarray(jax.random.bits(_jkey(), (3, 1000), jnp.uint32)).reshape(-1)
    _same(prng.random_bits(prng.PRNGKey(42), (3, 1000), start=999, stop=2500), want[999:2500])
    keys = prng.split(prng.PRNGKey(42), 3)
    jkeys = jax.random.split(_jkey(), 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (40,), jnp.uint32))(jkeys))
    _same(prng.random_bits(keys, (40,), start=35, stop=90), want.reshape(-1)[35:90])
    with pytest.raises(ValueError, match="outside"):
        prng.random_bits(prng.PRNGKey(0), (4,), start=2, stop=5)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 0.5), (TINY, 1.0), (NORMAL_LO, 1.0),
                                   (-3.0, 7.5)])
def test_uniform(lo, hi):
    _same(prng.uniform(prng.PRNGKey(42), (1001,), lo, hi),
          jax.random.uniform(_jkey(), (1001,), minval=lo, maxval=hi))


@pytest.mark.parametrize("name,shape", [("normal", (530, 1591)), ("normal", (7,)),
                                        ("exponential", (100003,)), ("gumbel", (100003,))])
@pytest.mark.parametrize("path", ["transform", "table"])
def test_float_draws(name, shape, path, monkeypatch):
    """Through the transform (a small CPU draw, no table built) and through
    the table of all 2**23 values (TABLE_MIN lowered: the draw builds the
    table, or reads the one this process built)."""
    if path == "table":
        monkeypatch.setattr(prng, "TABLE_MIN", 1)
    else:
        monkeypatch.setattr(prng, "_TABLES", {})
    _same(getattr(prng, name)(prng.PRNGKey(42), shape),
          getattr(jax.random, name)(_jkey(), shape))
    assert ((name, "cpu") in prng._TABLES) == (path == "table")


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_bernoulli(p):
    _same(prng.bernoulli(prng.PRNGKey(42), p, (10007,)),
          jax.random.bernoulli(_jkey(), p, (10007,)))


@pytest.mark.parametrize("lo,hi", [(0, 151936), (0, 2), (0, 1591), (-5, 7), (3, 3)])
def test_randint(lo, hi):
    _same(prng.randint(prng.PRNGKey(42), (10007,), lo, hi),
          jax.random.randint(_jkey(), (10007,), lo, hi))


def test_categorical_on_the_dialect_logits():
    """The reference's ``TokenClientData`` draw: its f32 ``log(p + 1e-9)``
    of Dir(0.01) mixtures (several near-zero weights), shape (batch, 1)."""
    p = np.random.default_rng((1, 0xD1A1)).dirichlet(np.full(10, 0.01), size=6)
    for i in range(6):
        pj = jnp.asarray(p[i], jnp.float32)
        jl = jax.jit(lambda q: jnp.log(q + 1e-9))(pj)
        tl = prng.log(torch.tensor(p[i], dtype=torch.float32) + float(np.float32(1e-9)))
        _same(tl, jl)
        key = jax.random.PRNGKey(i)
        _same(prng.categorical(prng.PRNGKey(i), tl, shape=(64, 1)),
              jax.random.categorical(key, jl, shape=(64, 1)))
    logits = np.random.default_rng(0).normal(size=(5, 9)).astype(np.float32)
    _same(prng.categorical(prng.PRNGKey(3), torch.tensor(logits)),
          jax.random.categorical(jax.random.PRNGKey(3), logits))


def test_permutation_and_choice():
    _same(prng.permutation(prng.PRNGKey(42), 1591), jax.random.permutation(_jkey(), 1591))
    _same(prng.choice(prng.PRNGKey(42), 1591, (530,), replace=False),
          jax.random.choice(_jkey(), 1591, (530,), replace=False))
    _same(prng.choice(prng.PRNGKey(42), 1591, (530,)), jax.random.choice(_jkey(), 1591, (530,)))
    with pytest.raises(ValueError):
        prng.choice(prng.PRNGKey(0), 5, (6,), replace=False)


def test_batched_keys_are_vmap_over_keys():
    """A (5, 2) batch of keys draws each key's shape on its own counters,
    as ``jax.vmap`` over the keys does (not one draw of the stacked
    shape); a batch of ids folds into one key the same way."""
    keys, jkeys = prng.split(prng.PRNGKey(42), 5), jax.random.split(_jkey(), 5)
    vm = lambda f: jax.vmap(f)(jkeys)  # noqa: E731
    _same(prng.normal(keys, (3, 7)), vm(lambda k: jax.random.normal(k, (3, 7))))
    _same(prng.uniform(keys, (11,), -0.5, 0.5),
          vm(lambda k: jax.random.uniform(k, (11,), minval=-0.5, maxval=0.5)))
    _same(prng.randint(keys, (4, 6), 0, 100), vm(lambda k: jax.random.randint(k, (4, 6), 0, 100)))
    _same(prng.split(keys, 4), vm(lambda k: jax.random.key_data(jax.random.split(k, 4))))
    _same(prng.split(prng.split(keys, 2), 3),
          vm(lambda k: jax.vmap(lambda q: jax.random.key_data(jax.random.split(q, 3)))(
              jax.random.split(k, 2))))
    ids = np.array([3, 0, 9, 2**31])
    _same(prng.fold_in(prng.PRNGKey(42), torch.tensor(ids)),
          jax.vmap(lambda i: jax.random.key_data(jax.random.fold_in(_jkey(), i)))(
              jnp.asarray(ids, jnp.uint32)))


def test_meta_keys_draw_shapes_only():
    key = prng.PRNGKey(0, device="meta")
    ks = prng.split(prng.split(key, 3), 2)
    assert ks.device.type == "meta" and tuple(ks.shape) == (3, 2, 2)
    out = prng.normal(ks[:, 0], (4, 5))
    assert out.device.type == "meta" and tuple(out.shape) == (3, 4, 5)
    assert tuple(prng.randint(key, (2, 3), 0, 9).shape) == (2, 3)
    assert tuple(prng.fold_in(key, torch.arange(4)).shape) == (4, 2)


def test_fma_rounds_once():
    """``_fma`` rounds a * b + c once, where f64 rounding then f32 rounding
    would land on the halfway point and round to even: 2**-12 (1 + 2**-23)
    times 2**-12 (1 - 2**-23) is 2**-24 - 2**-70, so (1 + 2**-23) plus it
    lies just below the halfway point (1 + 1.5 * 2**-23)."""
    a = torch.tensor([2.0**-12 * (1 + 2.0**-23)], dtype=torch.float32)
    b = torch.tensor([2.0**-12 * (1 - 2.0**-23)], dtype=torch.float32)
    c = torch.tensor([1 + 2.0**-23], dtype=torch.float32)
    assert float((a.double() * b.double() + c.double()).float()) == 1 + 2.0**-22
    assert float(prng._fma(a, b, c)) == 1 + 2.0**-23
    assert float(prng._fma(-a, b, -c)) == -(1 + 2.0**-23)


# -- the transforms on every input they can see -------------------------------


def _j_uniform(bits, lo, hi):
    """``jax/_src/random.py``'s ``_uniform`` from given 32-bit words."""
    lo, hi = jnp.float32(lo), jnp.float32(hi)
    fl = lax.bitcast_convert_type((bits >> 9) | np.uint32(0x3F800000), jnp.float32)
    return lax.max(lo, (fl - jnp.float32(1.0)) * (hi - lo) + lo)


J_TRANSFORMS = {
    "normal": jax.jit(lambda b: lax.mul(np.float32(np.sqrt(2)),
                                        lax.erf_inv(_j_uniform(b, NORMAL_LO, 1.0)))),
    "exponential": jax.jit(lambda b: lax.neg(lax.log1p(lax.neg(_j_uniform(b, 0.0, 1.0))))),
    "gumbel": jax.jit(lambda b: -jnp.log(-jnp.log(_j_uniform(b, TINY, 1.0)))),
}


@pytest.mark.parametrize("name", sorted(J_TRANSFORMS))
def test_jax_chain_is_jax_random(name):
    key = jax.random.PRNGKey(3)
    bits = jax.random.bits(key, (2**16 + 5,), jnp.uint32)
    _same(J_TRANSFORMS[name](bits), getattr(jax.random, name)(key, (2**16 + 5,)))


@pytest.mark.parametrize("part", range(4))
@pytest.mark.parametrize("name", sorted(J_TRANSFORMS))
def test_transform_on_all_2_23_inputs(name, part):
    """Every 23-bit input of the transform, bit-identical to JAX's (a
    quarter of them a case): XLA's CPU log / log1p / erf_inv forms with
    their FMA contractions, ported."""
    words = np.arange(part << 21, (part + 1) << 21, dtype=np.uint32) << 9
    want = np.asarray(J_TRANSFORMS[name](words))
    got = prng.from_bits(name)(torch.from_numpy(words.astype(np.int64)))
    differ = _words(got) != _words(want)
    assert int(differ.sum()) == 0, (name, part, int(differ.sum()))


# -- chip_smoke.py's golden table -------------------------------------------------


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_golden_table_is_jax():
    g = _smoke().PRNG_GOLDEN
    from jax._src import prng as jprng
    for (k1, k2, x1, x2), want in g["threefry2x32"]:
        out = jprng.threefry_2x32(np.array([k1, k2], np.uint32), np.array([x1, x2], np.uint32))
        assert tuple(int(v) for v in np.asarray(out)) == tuple(want)
    for seed, want in g["PRNGKey"]:
        assert tuple(np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).tolist()) == want
    for (seed, data), want in g["fold_in"]:
        k = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        assert tuple(np.asarray(jax.random.key_data(k)).tolist()) == want
    k0 = jax.random.PRNGKey(0)
    assert np.asarray(jax.random.key_data(jax.random.split(k0))).tolist() == \
        [list(w) for w in g["split"]]
    n = len(g["random_bits"])
    assert np.asarray(jax.random.bits(k0, (n,), jnp.uint32)).tolist() == g["random_bits"]
    assert np.asarray(jax.random.normal(k0, (n,))).view(np.uint32).tolist() == g["normal"]
    lo, hi = g["randint_range"]
    assert np.asarray(jax.random.randint(k0, (n,), lo, hi)).tolist() == g["randint"]
