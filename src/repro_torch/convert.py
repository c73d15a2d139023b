"""Carries the reference's state across to the port.

The two packages draw their random protocol state differently (the
reference with ``jax.random``, the port from seeded ``torch.Generator``s),
so to compute the same thing they must start from the same arrays.
:func:`from_reference` takes the reference's parameters and sensing matrix
as numpy arrays (``np.asarray`` of the JAX arrays) and returns the port's:
a parameter dict with the same names and layouts, and the ``a=`` tensor
that ``BQCSCodec``, ``CohortEngine`` and ``run_federated`` accept.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def from_reference(
    params_np: Dict[str, np.ndarray], a_np: Optional[np.ndarray] = None, device="cpu"
) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """(params dict, sensing matrix or None) as float32 tensors on ``device``."""
    params = {
        k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in params_np.items()
    }
    a = None if a_np is None else torch.tensor(np.asarray(a_np, np.float32), device=device)
    return params, a
