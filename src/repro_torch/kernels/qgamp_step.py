"""One fused Q-EM-GAMP iteration on the quantized channel (EA path), on Hopper.

Replaces the Pallas kernel ``repro/kernels/qgamp_step.py``
(``_qgamp_step_kernel`` / ``qgamp_step_pallas``).  Per block-row:

    phat  = alpha * (ghat @ A^T) - nu_p * shat     (product #1, contract N)
    truncated-Gaussian quantized posterior          (eqs. 12-16)
    rhat  = ghat + nu_r * alpha * (shat' @ A)       (product #2, contract M)
    Bernoulli Gaussian-mixture input channel        (L components)
    EM hyperparameter refresh                       (row reductions, eq. 17)

With ``bits = Q`` the observation is the (nb, W) uint32 wire words and the
kernel unpacks the Q-bit indices itself; with ``bits = 0`` it reads (nb, M)
int32 codes.  The CUDA source is ``csrc/qgamp_step.cu``: each tile of
``rows`` block-rows is split by columns over a thread-block cluster of
``cluster`` blocks, as in ``gamp_step`` (``launch_shape`` picks both).  The
plain version is ``ref.qgamp_step_ref``.  ``launches`` counts kernel launches
only.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.compression import packed_width, unpack_codes
from repro_torch.kernels import build, ref
from repro_torch.kernels.bqcs_encode_fused import _check
from repro_torch.kernels.gamp_step import _sm_count, launch_shape

launches = 0


def qgamp_step(
    ghat: torch.Tensor,  # (nb, N)
    nu_g: torch.Tensor,  # (nb, N)
    shat: torch.Tensor,  # (nb, M)
    theta: torch.Tensor,  # (nb, 1 + 3L)
    obs: torch.Tensor,  # (nb, W) uint32 words if bits else (nb, M) int32 codes
    alpha: torch.Tensor,  # (nb, 1) f32, strictly positive (dead rows fed 1.0)
    lo_tau: torch.Tensor,  # (2^Q,)
    hi_tau: torch.Tensor,  # (2^Q,)
    a: torch.Tensor,  # (M, N)
    n_components: int = 3,
    em: bool = True,
    bits: int = 0,
    *,
    _rows: Optional[int] = None,  # rows per tile, for the [tune] sweep only
    _cluster: Optional[int] = None,  # blocks per cluster, for the [tune] sweep only
):
    """Returns (ghat, nu_g, shat, theta) after one iteration."""
    nb, n = ghat.shape
    m = shat.shape[1]
    L = n_components
    n_lev = lo_tau.shape[0]
    dev = ghat.device
    f32 = torch.float32
    for name, t, shape in (
        ("ghat", ghat, (nb, n)), ("nu_g", nu_g, (nb, n)), ("shat", shat, (nb, m)),
        ("theta", theta, (nb, 1 + 3 * L)), ("alpha", alpha, (nb, 1)),
        ("lo_tau", lo_tau, (n_lev,)), ("hi_tau", hi_tau, (n_lev,)), ("a", a, (m, n)),
    ):
        _check(name, t, shape, f32, dev)
    if bits:
        _check("obs", obs, (nb, packed_width(m, bits)), torch.uint32, dev)
    else:
        _check("obs", obs, (nb, m), torch.int32, dev)
    if dev.type == "cpu":
        codes = unpack_codes(obs, bits, m) if bits else obs
        return ref.qgamp_step_ref(
            ghat, nu_g, shat, theta, codes, alpha, lo_tau, hi_tau, a, L, em
        )
    if dev.type != "cuda":
        raise ValueError(f"qgamp_step runs on cpu or cuda tensors, got {dev}")
    lib = build.library()
    rows, cluster = launch_shape(nb, _sm_count(dev.index))
    outs = (torch.empty_like(ghat), torch.empty_like(nu_g), torch.empty_like(shat),
            torch.empty_like(theta))
    # a cluster size that does not fit on the card makes the launch raise
    lib.call(
        "qgamp_step_launch",
        ghat.data_ptr(), nu_g.data_ptr(), shat.data_ptr(), theta.data_ptr(),
        obs.data_ptr(), alpha.data_ptr(), lo_tau.data_ptr(), hi_tau.data_ptr(),
        a.data_ptr(), *(o.data_ptr() for o in outs),
        nb, n, m, L, int(em), bits, obs.shape[1], n_lev, _rows or rows, _cluster or cluster,
        build.stream_handle(dev),
    )
    global launches
    launches += 1
    return outs
