"""One fused EM-GAMP iteration on the AWGN channel (AE path), on Hopper.

Replaces the Pallas kernel ``repro/kernels/gamp_step.py``
(``_gamp_step_kernel`` / ``gamp_step_pallas``).  Per block-row:

    phat  = ghat @ A^T - nu_p * shat          (product #1, contract N)
    AWGN posterior + Onsager terms            (elementwise)
    rhat  = ghat + nu_r * (shat' @ A)         (product #2, contract M)
    Bernoulli Gaussian-mixture input channel  (L components)
    EM hyperparameter refresh                 (row reductions, eq. 17)

The CUDA source is ``csrc/gamp_step.cu``; the plain version is
``ref.gamp_step_ref``.  ``launches`` counts kernel launches only.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.bqcs_encode_fused import _check
from repro_torch.kernels.qgamp_step import rows_per_cta

launches = 0


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
    _rows: Optional[int] = None,  # rows per block for the [tune] sweep only
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
    outs = (torch.empty_like(ghat), torch.empty_like(nu_g), torch.empty_like(shat),
            torch.empty_like(theta))
    lib.call(
        "gamp_step_launch",
        ghat.data_ptr(), nu_g.data_ptr(), shat.data_ptr(), theta.data_ptr(),
        y.data_ptr(), nu_d.data_ptr(), a.data_ptr(), *(o.data_ptr() for o in outs),
        nb, n, m, L, int(em), _rows or rows_per_cta(nb, dev), build.stream_handle(dev),
    )
    global launches
    launches += 1
    return outs
