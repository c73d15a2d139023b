"""The staged encoder's launch shapes and its arithmetic order, on the CPU.

``csrc/bqcs_encode.cu`` cannot run here, so this tests what it rests on:

* ``kernels/bqcs_encode.py::launch_shape`` against the kernel's own
  decomposition (the block -> (tile, rank) map, each rank's 1/C share of
  its tile, each rank's K range): every output is stored by exactly one
  block, the K ranges tile [0, N) in whole K steps in rank order, and the
  grid stays within one block per SM (the launch bounds allow two).  The
  constants the wrapper mirrors, and the K split restated here, are read
  from the CUDA sources.
* a PyTorch emulation of the kernel's order of arithmetic: each rank's
  partial products over its K range, each of its thread groups summing its
  own k of every K step (sequential fmaf, emulated in float64 and rounded
  to float32 at each step) and the groups' tiles added in group order; each
  rank's sums of x^2 as its threads take them from the staged tiles; both
  added over the cluster in rank order, and alpha applied to the finished
  y.  The emulation must meet the encoder contract (alpha to 1e-6
  relative; a code may differ only on a lane within 1e-5 of a threshold)
  against ``ref.bqcs_encode_ref`` and against the reference's
  ``repro.kernels.ops.bqcs_encode`` (its Pallas kernel in interpret mode),
  on dense and on top-S blocks, and on ragged shapes where some ranks get
  no K step.
* ``tools/probe_staged_encode.py``'s instrumented sources: every PROBE:
  mark it needs is in the kernel sources once.
"""

import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import codebook as jcb  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import bqcs_encode as s_mod  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/csrc"
THREADS = 256  # csrc/common.cuh kThreads
ROWS = s_mod.TILE_ROWS


def k_ranges(n: int, cluster: int) -> list[tuple[int, int]]:
    """Each rank's K range [lo, hi) as the kernel splits N (its k_per line,
    checked below): ceil(steps / cluster) whole K steps per rank, empty for
    the last ranks when N has too few steps."""
    steps = -(-n // s_mod.K_STEP)
    per = -(-steps // cluster) * s_mod.K_STEP
    return [(min(n, q * per), min(n, q * per + per)) for q in range(cluster)]


def test_wrapper_constants_match_the_sources():
    common = (CSRC / "common.cuh").read_text()
    kernel = (CSRC / "bqcs_encode.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", common)[1]) == THREADS
    assert int(re.search(r"constexpr int kTileRows = (\d+);", common)[1]) == s_mod.TILE_ROWS
    assert int(re.search(r"constexpr int kTileCols = (\d+);", common)[1]) == s_mod.TILE_COLS
    assert int(re.search(r"constexpr int kTileK = (\d+);", common)[1]) == s_mod.K_STEP
    launcher = kernel[kernel.index('extern "C" int bqcs_encode_launch'):]
    assert tuple(int(c) for c in re.findall(r"cluster != (\d+)", launcher)) == s_mod.CLUSTERS
    # k_ranges above restates this line
    assert "const int k_per = ((n + kTileK - 1) / kTileK + C - 1) / C * kTileK;" in kernel
    assert "const int k_lo = min(n, rank * k_per), k_hi = min(n, k_lo + k_per);" in kernel


def _stores(nb: int, m: int, cluster: int) -> np.ndarray:
    """How many blocks store each output (nb, m), by the kernel's map: block
    b is rank b % C of tile b / C; tile t covers rows (t / col_tiles) * 64
    and columns (t % col_tiles) * 64; rank q stores the tile's outputs
    q * share .. (q + 1) * share - 1 in row-major order, share = 64 * 64 / C."""
    col_tiles = -(-m // s_mod.TILE_COLS)
    tiles = -(-nb // ROWS) * col_tiles
    share = ROWS * s_mod.TILE_COLS // cluster
    assert share * cluster == ROWS * s_mod.TILE_COLS
    count = np.zeros((nb, m), np.int64)
    for b in range(tiles * cluster):
        tile, rank = divmod(b, cluster)
        row0 = (tile // col_tiles) * ROWS
        col0 = (tile % col_tiles) * s_mod.TILE_COLS
        idx = np.arange(rank * share, (rank + 1) * share)
        r, c = row0 + idx // s_mod.TILE_COLS, col0 + idx % s_mod.TILE_COLS
        ok = (r < nb) & (c < m)
        np.add.at(count, (r[ok], c[ok]), 1)
    return count


SHAPES = [
    (300, 1591, 530, 132), (301, 1591, 530, 132), (30, 1591, 530, 132), (1, 7002, 2334, 132),
    (5, 33, 1, 132), (9, 40, 70, 132), (9, 288, 70, 132), (3000, 1591, 530, 132),
    (300, 1591, 530, 114), (300, 1591, 530, 8), (37, 300, 100, 132), (64, 64, 64, 132),
    (65, 1591, 65, 132), (1, 1, 1, 132), (10, 1591, 530, 132), (10, 7002, 2334, 132),
    (128, 256, 128, 16), (300, 1591, 530, 264), (2, 100000, 64, 132), (640, 512, 640, 132),
]


@pytest.mark.parametrize("nb,n,m,sms", SHAPES)
def test_launch_shape_covers_every_output_and_fits(nb, n, m, sms):
    rows, cluster = s_mod.launch_shape(nb, n, m, sms)
    assert rows == s_mod.TILE_ROWS and cluster in s_mod.CLUSTERS
    blocks = -(-nb // rows) * -(-m // s_mod.TILE_COLS) * cluster
    # one block per SM (the launch bounds allow two), unless the tiles alone
    # are more (then cluster 1)
    assert blocks <= sms or cluster == 1
    # every output stored by exactly one block, at the pick and at every
    # cluster size the kernel takes
    for c in dict.fromkeys((cluster,) + s_mod.CLUSTERS):
        assert (_stores(nb, m, c) == 1).all(), c
        # the ranks' K ranges tile [0, N) in whole K steps, in rank order; an
        # empty range (too few steps) is the last ranks', and the kernel adds
        # its zero partial tile and norm
        ranges = k_ranges(n, c)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert lo <= hi == lo2 and (lo % s_mod.K_STEP == 0 or lo == n)
    # the chooser leaves at least two K steps a block
    assert -(-n // s_mod.K_STEP) >= 2 * cluster or cluster == 1


def emulate_encode(x: torch.Tensor, a_t: torch.Tensor, taus: torch.Tensor, cluster: int):
    """The kernel's arithmetic, in its order, for ``cluster`` blocks a tile."""
    nb, n = x.shape
    m = a_t.shape[1]
    groups = THREADS * 64 // (ROWS * s_mod.TILE_COLS)  # groups of 8 x 8 threads per K step
    gk = s_mod.K_STEP // groups  # k of a stage per group
    lanes = THREADS // ROWS  # threads that sum one row's x^2
    x64, a64 = x.double(), a_t.double()
    g = torch.arange(groups)
    tot = torch.zeros((nb, m), dtype=torch.float32)
    sq = torch.zeros((nb,), dtype=torch.float32)
    for lo, hi in k_ranges(n, cluster):
        steps = -(-(hi - lo) // s_mod.K_STEP)
        # group g's chain: k = lo + 32 s + g gk + j, acc = fmaf(x_k, a_k, acc)
        acc = torch.zeros((groups, nb, m), dtype=torch.float32)
        for t in range(steps * gk):
            k = lo + s_mod.K_STEP * (t // gk) + g * gk + t % gk
            live = (k < hi).double()[:, None, None]
            kc = k.clamp(max=n - 1)
            acc = (acc.double() + x64[:, kc].T[:, :, None] * a64[kc][:, None, :] * live).float()
        part = acc[0]
        for j in range(1, groups):  # the groups' partial tiles, in group order
            part = part + acc[j]
        # x^2: thread (row, q) takes k0 + q + lanes e of each stage
        q = torch.arange(lanes)
        sq_t = torch.zeros((nb, lanes), dtype=torch.float32)
        for k0 in range(lo, hi, s_mod.K_STEP):
            st = torch.zeros((nb, lanes), dtype=torch.float32)
            for e in range(s_mod.K_STEP // lanes):
                k = k0 + q + lanes * e
                v = x64[:, k.clamp(max=n - 1)] * (k < hi)
                st = (st.double() + v * v).float()
            sq_t = sq_t + st
        sq_rank = sq_t[:, 0]
        for j in range(1, lanes):
            sq_rank = sq_rank + sq_t[:, j]
        tot = tot + part  # the cluster's sums, in rank order
        sq = sq + sq_rank
    root_m = torch.tensor(np.sqrt(np.float32(m)), dtype=torch.float32)
    alpha = torch.where(sq > 1e-30, root_m * (1.0 / torch.sqrt(sq)), torch.zeros_like(sq))
    y = alpha[:, None] * tot
    codes = torch.sum(y[..., None] > taus, dim=-1).to(torch.uint8)
    return codes, alpha


BITS, S = 3, 159


@functools.lru_cache(maxsize=None)
def _codebook():
    return jcb.make_codebook(jcomp.FedQCSConfig(block_size=1591, reduction_ratio=3, bits=BITS,
                                                s_ratio=0.1, codebook="lloyd_max"))


@functools.lru_cache(maxsize=None)
def _inputs(kind: str, nb: int, n: int, m: int):
    """x (nb, n) with a dead row 0, dense or the top-S blocks the staged
    path encodes; A (m, n) with unit-variance projections; the lloyd_max
    thresholds; and the reference's codes and alpha from its Pallas kernel
    in interpret mode."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.05, (nb, n)).astype(np.float32)
    x[0] = 0.0
    if kind == "top_s":
        x = tref.block_topk_ref(torch.as_tensor(x), min(S, n))[0].numpy()
    a = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    jc = _codebook()
    codes_j, alpha_j = jops.bqcs_encode(jnp.asarray(x), jnp.asarray(a), jc)
    taus = jc.thresholds.astype(np.float32)
    return x, a, taus, np.asarray(codes_j), np.asarray(alpha_j)


def _check_contract(codes, alpha, codes_o, alpha_o, gap):
    np.testing.assert_allclose(alpha, alpha_o, rtol=1e-6, atol=0)
    diff = codes != codes_o
    if diff.any():
        assert gap[diff].max() < 1e-5


# the paper's width at 30 rows (dense and top-S), and ragged shapes: m = 1
# and 70 leave a ragged column tile, N = 33, 40 and 288 leave the last ranks
# of a cluster of 4 or 8 without a K step
@pytest.mark.parametrize("kind,nb,n,m", [
    ("dense", 30, 1591, 530), ("top_s", 30, 1591, 530), ("dense", 5, 33, 1),
    ("dense", 9, 40, 70), ("top_s", 9, 288, 70), ("dense", 37, 300, 100),
])
@pytest.mark.parametrize("cluster", s_mod.CLUSTERS)
def test_emulated_order_meets_the_encoder_contract(cluster, kind, nb, n, m):
    x, a, taus, codes_j, alpha_j = _inputs(kind, nb, n, m)
    xt, a_t, tt = torch.as_tensor(x), torch.as_tensor(a).T.contiguous(), torch.as_tensor(taus)
    codes, alpha = emulate_encode(xt, a_t, tt, cluster)
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (nb, m)
    assert float(alpha[0]) == 0.0 and bool((alpha[1:] > 0).all())
    codes_r, alpha_r = tref.bqcs_encode_ref(xt, a_t, tt)
    # the gap of each lane's y (the plain version's) to its nearest threshold
    y = (xt * alpha_r[:, None]) @ a_t
    gap = torch.amin(torch.abs(y[..., None] - tt), dim=-1).numpy()
    _check_contract(codes.numpy(), alpha.numpy(), codes_r.numpy(), alpha_r.numpy(), gap)
    _check_contract(codes.numpy(), alpha.numpy(), codes_j, alpha_j, gap)


def _probe_module():
    spec = importlib.util.spec_from_file_location("probe_staged_encode",
                                                  ROOT / "tools/probe_staged_encode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["as built", "no product", "no staging"])
def test_probe_marks_are_in_the_sources(variant):
    probe = _probe_module()
    kernel, common = probe.instrumented(
        (CSRC / "bqcs_encode.cu").read_text(), (CSRC / "common.cuh").read_text(), variant)
    assert kernel.count("%%globaltimer") == len(probe.PHASES) + 1
    assert "probe_read" in kernel
    skipped = common.count("if (false)")
    assert skipped == (0 if variant == "as built" else 1)
