"""Counter-based random numbers: the port's counterpart of ``jax.random``
as the reference uses it (threefry2x32, ``jax_threefry_partitionable``).

A key is a ``(..., 2)`` int64 tensor of two uint32 words (int64 because
``torch.uint32`` lacks most ops; every word is masked to 32 bits).  Leading
dimensions batch keys: a draw from a ``(*B, 2)`` key has shape ``(*B,
*shape)``, each key's ``shape`` on its own counters -- what the reference's
``jax.vmap`` over keys gives.  Every function runs where its key lives; a
key on the ``meta`` device gives unallocated results of the right shape.

Bits, uniforms, integers, permutations and keys equal ``jax.random``'s bit
for bit.  The float transforms port XLA's own CPU forms -- Eigen's
``plog`` for ``log``, XLA's Cephes ``log1p``, the Giles ``erf_inv``
polynomial, a correctly rounded ``sqrt`` -- one IEEE operation at a time,
with each product that XLA contracts into an FMA rounded once (on the CPU
and the card alike), so ``normal``, ``exponential`` and
the Gumbel draw behind ``categorical`` equal the reference's too.

Large draws run in chunks of the flat index (:data:`CHUNK` elements on a
card, :data:`CPU_CHUNK` on the CPU, where a chunk's temporaries then stay
in cache): no draw holds more than a few chunk-sized
temporaries, the chunking changes no value, and any slice of a draw can be
recomputed on its own (:func:`random_bits`'s ``start`` and ``stop``).
Since a float draw sees only 2**23 words, ``normal``, ``exponential`` and
``gumbel`` read their value from a table of all 2**23 (one gather in place
of ~450 elementwise passes), built once per device by the transform
itself: on a card at the first draw, on the CPU at the first draw of
:data:`TABLE_MIN` values or more (a smaller CPU draw runs the transform).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "PRNGKey", "key_data", "split", "fold_in", "threefry2x32", "random_bits", "uniform",
    "normal", "exponential", "bernoulli", "randint", "gumbel", "categorical",
    "permutation", "choice", "from_bits", "erf_inv", "log", "log1p", "CHUNK", "CPU_CHUNK",
    "TABLE_MIN",
]

MASK = 0xFFFFFFFF
CHUNK = 1 << 24  # elements of the flat index a chunk draws on a card
CPU_CHUNK = 1 << 20  # ... and on the CPU
TABLE_MIN = 1 << 23  # a CPU float draw this large first builds its table
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _f32(word: int) -> float:
    """The f32 whose bits are ``word``, as a Python float (exact)."""
    return float(np.array(word, np.uint32).view(np.float32))


# XLA's CPU constants, bit for bit: Eigen's plog (Cephes logf) ...
_LOG_P = tuple(_f32(w) for w in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
                                 0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
_LOG_Q1, _LOG_Q2 = _f32(0xB95E8083), _f32(0x3F318000)
_SQRTHF, _MIN_NORMAL = _f32(0x3F3504F3), _f32(0x00800000)
# ... log1p's rational form below sqrt(2) - 1 (numerator, denominator) ...
_LOG1P_NUM = tuple(_f32(w) for w in (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                                     0x4273CC76, 0x426473AD, 0x41A05101))
_LOG1P_DEN = (1.0,) + tuple(_f32(w) for w in (0x417101AD, 0x42A6185B, 0x435DC32D,
                                              0x439A8CA3, 0x43586D8A, 0x42707982))
_LOG1P_SMALL = _f32(0x3ED413CD)
# ... and erf_inv's two 9-term branches (w < 5, w >= 5)
_ERFINV_LT5 = tuple(_f32(w) for w in (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1,
                                      0x396532DB, 0xBAA45408, 0xBB88E4EF, 0x3E7C8F63,
                                      0x3FC02E2F))
_ERFINV_GE5 = tuple(_f32(w) for w in (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7,
                                      0x3BBC127B, 0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB,
                                      0x40354F7E))
_SQRT2 = float(np.float32(np.sqrt(2)))
_TINY = float(np.finfo(np.float32).tiny)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


# ---------------------------------------------------------------------------
# keys and the threefry2x32 hash
# ---------------------------------------------------------------------------


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: ``[0, seed mod
    2**32]``, a (2,) key on ``device``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The key's uint32 words, ``(..., 2)`` int64."""
    return key


def _i32(words) -> torch.Tensor:
    """uint32 words (int64 tensor or int) as int32 bit patterns."""
    if isinstance(words, torch.Tensor):
        return words.to(torch.int32)
    return torch.tensor(int(words) & MASK, dtype=torch.int64).to(torch.int32)


def _threefry(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 on int32 bit patterns (adds wrap, as uint32 adds do;
    a right shift is masked to shift logically).  Arguments broadcast."""
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = torch.add(x1, ks[0]).expand(shape).contiguous()
    b = torch.add(x2, ks[1]).expand(shape).contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a += b
            hi = b << r
            b.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1).bitwise_or_(hi)
            b ^= a
        a += ks[(i + 1) % 3]
        b += ks[(i + 2) % 3] + (i + 1)
    return a, b


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x1, x2)`` under the key words ``(k1, k2)`` (uint32 words as ints or
    int64 tensors; they broadcast): the two output words, int64."""
    dev = next((t.device for t in (x2, x1, k1, k2) if isinstance(t, torch.Tensor)), None)
    a, b = _threefry(*(_i32(t).to(dev) for t in (k1, k2, x1, x2)))
    return a.to(torch.int64) & MASK, b.to(torch.int64) & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(*B, 2)`` keys -> ``(*B, num, 2)``."""
    if key.device.type == "meta":
        return torch.empty((*key.shape[:-1], int(num), 2), dtype=torch.int64, device="meta")
    counts = torch.arange(int(num), dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., :1], key[..., 1:], 0, counts)
    return torch.stack([a, b], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``threefry2x32(key, [0, data])``.  ``data``
    is an int or an integer tensor; key and data broadcast (a batch of
    ids folds into one key as the reference's ``vmap`` does)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    if isinstance(data, (int, np.integer)) and not 0 <= int(data) <= MASK:
        raise ValueError(f"fold_in data {data} is not a uint32")
    if key.device.type == "meta":
        return torch.empty((*torch.broadcast_shapes(key.shape[:-1], d.shape), 2),
                           dtype=torch.int64, device="meta")
    a, b = threefry2x32(key[..., 0], key[..., 1], 0, d & MASK)
    return torch.stack([a, b], dim=-1)


# ---------------------------------------------------------------------------
# bits, chunk by chunk
# ---------------------------------------------------------------------------


def _bits_chunk(keys: torch.Tensor, per: int, start: int, stop: int) -> torch.Tensor:
    """Flat elements ``[start, stop)`` of the draw of ``per`` words from each
    of the flat ``(K, 2)`` int32 keys: ``bits1 ^ bits2`` of the element's
    row-major index within its key's shape, split into (hi, lo) words;
    int32 bit patterns."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=keys.device)
    if keys.shape[0] == 1:
        k1, k2, count = keys[0, 0], keys[0, 1], idx
    else:
        row = torch.div(idx, per, rounding_mode="floor")
        count = idx - row * per
        k1, k2 = keys[row, 0], keys[row, 1]
    hi = (count >> 32).to(torch.int32) if per > MASK else torch.zeros((), dtype=torch.int32,
                                                                       device=keys.device)
    a, b = _threefry(k1, k2, hi, count.to(torch.int32))
    return a.bitwise_xor_(b)


def _u32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as their uint32 values, int64."""
    return bits.to(torch.int64) & MASK


def _draw(keys: Sequence[torch.Tensor], shape: Shape, fn: Callable, dtype) -> torch.Tensor:
    """``fn(*bits)`` of each key's 32-bit draw of ``shape`` (int32 bit
    patterns), chunk by chunk into one ``(*B, *shape)`` tensor.  The keys
    share their batch shape."""
    shape = _shape(shape)
    batch = tuple(keys[0].shape[:-1])
    out = torch.empty(batch + shape, dtype=dtype, device=keys[0].device)
    if keys[0].device.type == "meta" or out.numel() == 0:
        return out
    flat = [_i32(k.reshape(-1, 2)) for k in keys]
    per = math.prod(shape)
    view = out.view(-1)
    step = _chunk(out.device)
    for s in range(0, view.numel(), step):
        e = min(view.numel(), s + step)
        view[s:e] = fn(*(_bits_chunk(k, per, s, e) for k in flat))
    return out


def _chunk(device: torch.device) -> int:
    return CPU_CHUNK if device.type == "cpu" else CHUNK


def random_bits(key: torch.Tensor, shape: Shape = (), start: int = 0, stop=None) -> torch.Tensor:
    """``jax.random.bits`` (32-bit, partitionable form): uint32 words as
    int64, ``(*B, *shape)``.  With ``start``/``stop``: only the flat
    elements ``[start, stop)`` of that draw, a 1-D tensor, recomputed on
    their own."""
    shape = _shape(shape)
    if start == 0 and stop is None:
        return _draw([key], shape, _u32, torch.int64)
    total = math.prod(key.shape[:-1]) * math.prod(shape)
    stop = total if stop is None else int(stop)
    if not 0 <= start <= stop <= total:
        raise ValueError(f"slice [{start}, {stop}) outside a draw of {total} elements")
    if key.device.type == "meta":
        return torch.empty(stop - start, dtype=torch.int64, device="meta")
    return _u32(_bits_chunk(_i32(key.reshape(-1, 2)), math.prod(shape), int(start), stop))


# ---------------------------------------------------------------------------
# XLA's f32 transcendentals, one IEEE operation at a time
# ---------------------------------------------------------------------------


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) floats from the top 23 bits of int32 bit patterns: ``(bits
    >> 9) | 0x3F800000`` (a logical shift) read as f32, minus 1."""
    return (((bits >> 9) & 0x7FFFFF) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as the FMA that XLA's CPU code
    contracts a product and its one sum into.  In f64 the product is
    exact and the sum is rounded once more; that second rounding can only
    go wrong where the f64 sum lands exactly halfway between two f32, and
    there the sum's exact error (TwoSum) says which way the true value
    lies."""
    t = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
    a, b, c = (torch.as_tensor(v, dtype=torch.float64, device=t.device) for v in (a, b, c))
    prod = a * b
    s = prod + c
    bits = s.view(torch.int64)
    halfway = (bits & 0x1FFFFFFF) == 0x10000000
    if bool(halfway.any()):
        i = halfway.nonzero(as_tuple=True)
        p_i, c_i = (v.expand(s.shape)[i] for v in (prod, c))
        s_i = s[i]
        bc = s_i - p_i
        err = (p_i - (s_i - bc)) + (c_i - bc)
        bits = bits.clone()
        bits[i] += (torch.sign(err) * torch.sign(s_i)).to(torch.int64)
    return bits.view(torch.float64).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt (through f64, exact for f32 inputs)."""
    return torch.sqrt(x.double()).float()


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``log`` (Eigen's ``plog``, its products contracted
    into FMAs): the exponent split off, the mantissa in [sqrt(1/2),
    sqrt(2)), the Cephes polynomial.  0 gives -inf, +inf gives +inf,
    negatives and NaN give NaN."""
    xc = torch.where(x > _MIN_NORMAL, x, torch.full_like(x, _MIN_NORMAL))
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = e - torch.where(small, 1.0, 0.0)
    r = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    r2 = r * r
    r3 = r2 * r
    p = _LOG_P
    y, y1, y2 = _fma(r, p[0], p[1]), _fma(r, p[3], p[4]), _fma(r, p[6], p[7])
    y, y1, y2 = _fma(y, r, p[2]), _fma(y1, r, p[5]), _fma(y2, r, p[8])
    y = _fma(_fma(y, r3, y1), r3, y2)
    y = _fma(y, r3, e * _LOG_Q1)
    out = _fma(e, _LOG_Q2, _fma(r2, -0.5, r) + y)
    out = torch.where((x < 0) | torch.isnan(x), torch.full_like(x, math.nan), out)
    out = torch.where(x == 0, torch.full_like(x, -math.inf), out)
    return torch.where(x == math.inf, x, out)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p``: a Cephes rational form for |x| < sqrt(2) - 1,
    else :func:`log` of ``x + 1``."""
    x2 = x * x
    zero = x * 0.0
    num = zero + _LOG1P_NUM[0]
    den = zero + _LOG1P_DEN[0]
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, x, c)
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, x, c)
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (Giles): ``w = -log1p(-x*x)``, a 9-term
    Horner polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times x;
    +-inf at |x| == 1."""
    lg = log1p(x * -x)
    lt = lg > -5.0
    w = torch.where(lt, -2.5 - lg, _sqrt(-lg) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, c_lt, c_ge))
    return x * torch.where(torch.abs(x) == 1.0, math.inf, p)


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------


def _uniform_of(minval: float, maxval: float) -> Callable:
    lo, hi = np.float32(minval), np.float32(maxval)
    span, lo = float(hi - lo), float(lo)
    return lambda bits: torch.clamp(_fma(_unit_floats(bits), span, lo), min=lo)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (f32): ``max(minval, u * (maxval - minval) +
    minval)`` with u the 23-bit [0, 1) float."""
    return _draw([key], shape, _uniform_of(minval, maxval), torch.float32)


def _normal_bits(bits: torch.Tensor) -> torch.Tensor:
    return _SQRT2 * erf_inv(_uniform_of(_NORMAL_LO, 1.0)(bits))


def _exponential_bits(bits: torch.Tensor) -> torch.Tensor:
    return -log1p(-_uniform_of(0.0, 1.0)(bits))


def _gumbel_bits(bits: torch.Tensor) -> torch.Tensor:
    return -log(-log(_uniform_of(_TINY, 1.0)(bits)))


_FROM_BITS = {"uniform": _uniform_of(0.0, 1.0), "normal": _normal_bits,
              "exponential": _exponential_bits, "gumbel": _gumbel_bits}


def from_bits(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The map from 32-bit words (uint32 values as int64, or int32 bit
    patterns) to ``name``'s f32 draws ("uniform" on [0, 1), "normal",
    "exponential", "gumbel"): what each of those draws applies to
    :func:`random_bits`, word by word (in chunks, as the draws run)."""
    fn = _FROM_BITS[name]

    def apply(words: torch.Tensor) -> torch.Tensor:
        flat, step = words.reshape(-1), _chunk(words.device)
        out = torch.empty(flat.shape, dtype=torch.float32, device=words.device)
        for s in range(0, flat.numel(), step):
            out[s:s + step] = fn(flat[s:s + step])
        return out.reshape(words.shape)

    return apply


# (distribution, device) -> from_bits(distribution) of all 2**23 words a
# draw can see: constant tables, filled on first need (_word_map)
_TABLES: Dict[Tuple[str, str], torch.Tensor] = {}


def _word_map(name: str, device: torch.device, numel: int) -> Callable:
    """A float draw's map from its words to its values: a gather from the
    distribution's table where it exists or is worth building (always on a
    card; on the CPU from TABLE_MIN values), else the transform itself."""
    slot = (name, str(device))
    if slot not in _TABLES:
        if device.type == "meta" or (device.type == "cpu" and numel < TABLE_MIN):
            return _FROM_BITS[name]
        words = torch.arange(1 << 23, dtype=torch.int32, device=device) << 9
        _TABLES[slot] = from_bits(name)(words)
    table = _TABLES[slot]
    return lambda bits: table.index_select(0, (bits >> 9) & 0x7FFFFF)


def _float_draw(key: torch.Tensor, shape: Shape, name: str) -> torch.Tensor:
    shape = _shape(shape)
    numel = math.prod(key.shape[:-1]) * math.prod(shape)
    return _draw([key], shape, _word_map(name, key.device, numel), torch.float32)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` (f32): ``sqrt(2) * erf_inv(uniform(key, shape,
    nextafter(-1, 0), 1))``."""
    return _float_draw(key, shape, "normal")


def exponential(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.exponential`` (f32): ``-log1p(-u)``."""
    return _float_draw(key, shape, "exponential")


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (f32, mode "low"): ``-log(-log(u))`` with u
    uniform on [tiny, 1)."""
    return _float_draw(key, shape, "gumbel")


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform(key, shape) < p``
    in f32, a bool tensor."""
    u = _uniform_of(0.0, 1.0)
    pf = float(np.float32(p))
    return _draw([key], shape, lambda b: u(b) < pf, torch.bool)


def _wrap_i32(v: int) -> int:
    return (int(v) + 2**31) % 2**32 - 2**31


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32: two 32-bit draws from
    ``split(key)``, combined modulo the span in uint32 arithmetic.  Values
    in an int64 tensor (the port's index dtype)."""
    i32max = 2**31 - 1
    out_of_range = maxval > i32max
    lo = min(max(int(minval), -(2**31)), i32max)
    hi = min(max(int(maxval), -(2**31)), i32max)
    span = _wrap_i32(hi - lo) & MASK
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    if span == 0:
        raise ValueError("randint over the whole 2**32 range is not supported")
    # 2**32 mod span, in the reference's wrapping uint32 arithmetic
    mult = ((2**16 % span) ** 2 & MASK) % span

    def combine(high, low):
        high, low = _u32(high), _u32(low)
        off = ((high % span) * mult & MASK) + (low % span)
        return (((off & MASK) % span + lo + 2**31) & MASK) - 2**31

    ks = split(key)
    return _draw([ks[..., 0, :], ks[..., 1, :]], shape, combine, torch.int64)


def categorical(key: torch.Tensor, logits: torch.Tensor, shape=None) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (with replacement):
    argmax of Gumbel draws plus the logits, the lowest index on ties.
    ``shape`` defaults to the logits' batch shape; int64 indices.  A
    ``(*K, 2)`` batch of keys takes logits ``(*K, ..., n)``, each key its
    own (the reference's vmap over keys and logits): ``(*K, *shape)``."""
    kdims = tuple(key.shape[:-1])
    batch = tuple(logits.shape[len(kdims):-1])
    shape = batch if shape is None else _shape(shape)
    prefix = shape[: len(shape) - len(batch)]
    g = gumbel(key, (*shape, logits.shape[-1]))
    lg = logits.reshape(kdims + (1,) * len(prefix) + batch + (logits.shape[-1],))
    return torch.argmax(g + lg, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``_shuffle``'s rounds, each a
    stable sort of the running order by a fresh 32-bit draw."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        ks = split(key)
        key, sub = ks[0], ks[1]
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, shape: Shape = (), replace: bool = True) -> torch.Tensor:
    """``jax.random.choice`` of ``arange(n)`` without weights: uniform
    ints with replacement, else the head of a permutation."""
    shape = _shape(shape)
    k = math.prod(shape)
    if replace:
        return randint(key, shape, 0, n)
    if k > n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    return permutation(key, n)[:k].reshape(shape)
