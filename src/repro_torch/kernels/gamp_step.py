"""One fused EM-GAMP iteration on the AWGN channel (AE path), on Hopper.

Replaces the Pallas kernel ``repro/kernels/gamp_step.py``
(``_gamp_step_kernel`` / ``gamp_step_pallas``).  Per block-row:

    phat  = ghat @ A^T - nu_p * shat          (product #1, contract N)
    AWGN posterior + Onsager terms            (elementwise)
    rhat  = ghat + nu_r * (shat' @ A)         (product #2, contract M)
    Bernoulli Gaussian-mixture input channel  (L components)
    EM hyperparameter refresh                 (row reductions, eq. 17)

The CUDA source is ``csrc/gamp_step.cu``: each tile of ``rows`` block-rows
is split by columns over a thread-block cluster of ``cluster`` blocks
(``launch_shape`` picks both).  The plain version is ``ref.gamp_step_ref``.
``launches`` counts kernel launches only.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.bqcs_encode_fused import _check

launches = 0

ROWS = (1, 2, 4)  # rows per tile the kernel instantiates
CLUSTERS = (1, 2, 4, 8, 16)  # cluster sizes it launches (16 is non-portable)


def launch_shape(nb: int, sms: int) -> tuple[int, int]:
    """(rows per tile, blocks per cluster) for ``nb`` block-rows on a card
    with ``sms`` SMs.  Rows in one tile share each load of A; the blocks of a
    cluster split the columns, so each block streams 1/cluster of A.  One row
    a tile while the rows alone fill fewer blocks than SMs (the 10-row AE
    decode), else four (the 300-row EA decodes: A read 75 times, not 300);
    then the largest cluster that keeps the grid within two blocks per SM
    (the kernels' launch bounds): 10 x 16 = 160 and 75 x 2 = 150 blocks.
    ``qgamp_step`` launches with the same choice.  Set from ``chip_smoke.py``'s
    [tune] sweep on an H100 (PERF.md), which times every pair for gamp_step
    at 10 and 300 rows and for qgamp_step at 300 rows and marks this choice."""
    rows = 1 if nb < sms else 4
    tiles = -(-nb // rows)
    cluster = 1
    while cluster < CLUSTERS[-1] and tiles * (2 * cluster) <= 2 * sms:  # doubled, still fits
        cluster *= 2
    return rows, cluster


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gamp_step(
    ghat: torch.Tensor,  # (nb, N)
    nu_g: torch.Tensor,  # (nb, N)
    shat: torch.Tensor,  # (nb, M)
    theta: torch.Tensor,  # (nb, 1 + 3L)
    y: torch.Tensor,  # (nb, M)
    nu_d: torch.Tensor,  # (nb, 1)
    a: torch.Tensor,  # (M, N)
    n_components: int = 3,
    em: bool = True,
    *,
    _rows: Optional[int] = None,  # rows per tile, for the [tune] sweep only
    _cluster: Optional[int] = None,  # blocks per cluster, for the [tune] sweep only
):
    """Returns (ghat, nu_g, shat, theta) after one iteration."""
    nb, n = ghat.shape
    m = shat.shape[1]
    L = n_components
    dev = ghat.device
    for name, t, shape in (
        ("ghat", ghat, (nb, n)), ("nu_g", nu_g, (nb, n)), ("shat", shat, (nb, m)),
        ("theta", theta, (nb, 1 + 3 * L)), ("y", y, (nb, m)), ("nu_d", nu_d, (nb, 1)),
        ("a", a, (m, n)),
    ):
        _check(name, t, shape, torch.float32, dev)
    if dev.type == "cpu":
        return ref.gamp_step_ref(ghat, nu_g, shat, theta, y, nu_d, a, L, em)
    if dev.type != "cuda":
        raise ValueError(f"gamp_step runs on cpu or cuda tensors, got {dev}")
    lib = build.library()
    rows, cluster = launch_shape(nb, _sm_count(dev.index))
    outs = (torch.empty_like(ghat), torch.empty_like(nu_g), torch.empty_like(shat),
            torch.empty_like(theta))
    # a cluster size that does not fit on the card makes the launch raise
    lib.call(
        "gamp_step_launch",
        ghat.data_ptr(), nu_g.data_ptr(), shat.data_ptr(), theta.data_ptr(),
        y.data_ptr(), nu_d.data_ptr(), a.data_ptr(), *(o.data_ptr() for o in outs),
        nb, n, m, L, int(em), _rows or rows, _cluster or cluster, build.stream_handle(dev),
    )
    global launches
    launches += 1
    return outs
