"""The pass-batched top-S bisection of ``csrc/common.cuh::topk_threshold``,
emulated in PyTorch on the CPU, against the plain sequential bisection.

The CUDA kernel cannot run here, so this tests the claim it rests on: a pass
that computes the 2^b - 1 midpoints of the next b levels (in in-order
order, each from its own node's (lo, hi)), counts |x| >= p for all of them
in one sweep (c, the number of pivots <= |x|, into a histogram), and walks
the b levels with those counts reaches the same (lo, hi) as b sequential
halvings, bit for bit; the kernel reads the walk's end from T, the number
of pivots whose count exceeds S, and the emulation checks that against the
descent itself.  The emulation follows the kernel step for step;
its kept set must equal ``repro_torch.kernels.ref.block_topk_ref``'s and the
reference's interpret-mode Pallas kernel's exactly (no tolerance: the
threshold is the same fp32 value, and the counts are integers).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shared import one_torch_thread  # noqa: E402,F401  (autouse)

import jax  # noqa: E402

from repro.kernels.block_topk import block_topk_pallas  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

COMMON_CUH = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/common.cuh"
SHIPPED_LEVELS = int(re.search(r"constexpr int kLevels = (\d+);", COMMON_CUH.read_text())[1])
N = 97
ITERS = [0, 1, 7, 26, 30]


def pass_batched_threshold(mag: torch.Tensor, s: int, iters: int, levels: int):
    """hi of each row of mag (rows, n) f32 after ``iters`` halvings taken in
    passes of ``levels`` levels, as the kernel takes them."""
    rows = mag.shape[0]
    mx = torch.amax(mag, dim=1)
    lo, hi = torch.zeros_like(mx), mx.clone()
    done = 0
    while done < iters:
        lv = min(levels, iters - done)
        npiv, root = (1 << lv) - 1, 1 << (lv - 1)
        # 1. the midpoints, depth by depth; node k of depth d sits at in-order
        #    position (2k + 1) 2^(lv - 1 - d), stored at index position - 1
        piv = torch.empty((rows, npiv), dtype=torch.float32)
        lu = [(lo, hi)]
        for d in range(lv):
            nxt = []
            for k, (l, u) in enumerate(lu):
                mid = 0.5 * (l + u)
                piv[:, (2 * k + 1) * (1 << (lv - 1 - d)) - 1] = mid
                nxt += [(l, mid), (mid, u)]
            lu = nxt
        assert bool((piv[:, 1:] >= piv[:, :-1]).all()), "in-order midpoints must be sorted"
        # 2. c = the number of pivots <= |x|; bin c gains 1; sfx[t] = #(c >= t)
        c = torch.searchsorted(piv, mag.contiguous(), right=True)
        # the kernel searches only inside [lo, hi): below lo c = 0, at or
        # above hi c = np
        assert bool((c[mag < lo[:, None]] == 0).all())
        assert bool((c[mag >= hi[:, None]] == npiv).all())
        hist = torch.zeros((rows, npiv + 1), dtype=torch.int64).scatter_add_(
            1, c, torch.ones_like(c))
        sfx = torch.flip(torch.cumsum(torch.flip(hist, [1]), 1), [1])
        # 3. walk the lv levels: the kernel takes the walk's end from T, the
        #    number of pivots whose count exceeds S; the descent itself must
        #    end at the same (lo, hi)
        t_up = torch.sum(sfx[:, 1:] > s, dim=1)
        pad = torch.cat([lo[:, None], piv, hi[:, None]], dim=1)  # pivot t at column t
        lo_k = pad.gather(1, t_up[:, None])[:, 0]
        hi_k = pad.gather(1, (t_up + 1)[:, None])[:, 0]
        node = torch.full((rows,), root, dtype=torch.int64)
        step = root >> 1
        for _ in range(lv):
            cnt = sfx.gather(1, node[:, None])[:, 0]
            p = piv.gather(1, (node - 1)[:, None])[:, 0]
            up = cnt > s
            lo = torch.where(up, p, lo)
            hi = torch.where(up, hi, p)
            node = node + torch.where(up, step, -step)
            step >>= 1
        assert torch.equal(lo_k, lo) and torch.equal(hi_k, hi), "T must end the walk"
        done += lv
    return hi, mx


def pass_batched_topk(x: torch.Tensor, s: int, iters: int, levels: int):
    mag = torch.abs(x)
    hi, mx = pass_batched_threshold(mag, s, iters, levels)
    keep = (mag >= hi[:, None]) | (mag == mx[:, None])
    sparse = torch.where(keep, x, torch.zeros_like(x))
    return sparse, x - sparse


def _rows(seed: int, subnormal: bool = True) -> np.ndarray:
    """One row of each kind the bisection must get right.  The subnormal row
    is left out against the reference's Pallas kernel: XLA on the CPU
    flushes subnormals to zero, where PyTorch and the CUDA kernel (built
    without fast math) keep them."""
    rng = np.random.default_rng(seed)
    rand = rng.normal(0, 0.1, N)
    zero = np.zeros(N)  # a dead row
    const = np.full(N, -0.3)
    ulp = np.float32(1.0) + np.arange(N, dtype=np.float32) * np.finfo(np.float32).eps
    ulp = ulp * rng.choice([-1.0, 1.0], N)  # magnitudes 1 ulp apart
    third = rng.normal(0, 0.1, N)
    third[rng.permutation(N)[: N // 3]] = 0.05  # a third tied at one value
    at_max = rng.normal(0, 0.1, N)
    at_max[:4] = np.abs(at_max).max() * np.array([1, -1, 1, -1])  # a tie at the row max
    kinds = [rand, zero, const, ulp, third, at_max]
    if subnormal:
        kinds.append(rng.normal(0, 1e-39, N))
    return np.stack(kinds).astype(np.float32)


S_CASES = {"s_typical": 10, "s_one": 1, "s_at_least_n": N + 1}


@pytest.mark.parametrize("s_name", list(S_CASES))
@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("levels", [
    pytest.param(1, id="b1"), pytest.param(3, id="b3"), pytest.param(5, id="b5"),
    pytest.param(7, id="b7"), pytest.param(SHIPPED_LEVELS, id="shipped_kLevels"),
])
def test_pass_walk_matches_plain_bisection(levels, iters, s_name):
    s = S_CASES[s_name]
    x = torch.as_tensor(_rows(levels * 100 + iters))
    sparse, resid = pass_batched_topk(x, s, iters, levels)
    sp_r, res_r = tref.block_topk_ref(x, s, iters=iters)
    assert torch.equal(sparse, sp_r) and torch.equal(resid, res_r)


@pytest.mark.parametrize("s_name", list(S_CASES))
@pytest.mark.parametrize("iters", ITERS)
def test_pass_walk_matches_reference_pallas(iters, s_name):
    s = S_CASES[s_name]
    rows = _rows(iters + 7, subnormal=False)
    sp_j, res_j = block_topk_pallas(rows, s, tb=rows.shape[0], iters=iters, interpret=True)
    sp_j, res_j = np.asarray(sp_j), np.asarray(res_j)
    for levels in sorted({1, 3, 5, 7, SHIPPED_LEVELS}):
        sparse, resid = pass_batched_topk(torch.as_tensor(rows), s, iters, levels)
        assert np.array_equal(sparse.numpy(), sp_j), f"b={levels}"
        assert np.array_equal(resid.numpy(), res_j), f"b={levels}"
