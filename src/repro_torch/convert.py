"""Carries the reference's state across to the port.

The two packages draw their random protocol state differently (the
reference with ``jax.random``, the port from seeded ``torch.Generator``s),
so to compute the same thing they must start from the same arrays.
:func:`from_reference` takes the reference's parameters and sensing matrix
as numpy arrays (``np.asarray`` of the JAX arrays) and returns the port's:
a parameter dict with the same names and layouts, and the ``a=`` tensor
that ``BQCSCodec``, ``CohortEngine`` and ``run_federated`` accept.
:func:`state_from_reference` does the same for an optimizer or server
state (``optim/adam.py``, ``fed/server_opt.py``), so both packages can go
on from the same mid-run state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adam import QLeaf


def from_reference(
    params_np: Dict[str, np.ndarray], a_np: Optional[np.ndarray] = None, device="cpu"
) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """(params dict, sensing matrix or None) as float32 tensors on ``device``."""
    params = {
        k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in params_np.items()
    }
    a = None if a_np is None else torch.tensor(np.asarray(a_np, np.float32), device=device)
    return params, a


def state_from_reference(state: Any, device="cpu") -> Any:
    """The reference's optimizer state as the port's: nested dicts kept, each
    array as a float32 tensor, each blockwise-int8 ``QLeaf`` (int8 codes,
    fp32 block scales) as the port's :class:`QLeaf`.  Leaves may be JAX or
    numpy arrays (``jax.tree_util.tree_map(np.asarray, state)`` keeps the
    QLeaf structure)."""
    if isinstance(state, dict):
        return {k: state_from_reference(v, device) for k, v in state.items()}
    if getattr(state, "_fields", None) == QLeaf._fields:
        return QLeaf(torch.tensor(np.asarray(state.q, np.int8), device=device),
                     torch.tensor(np.asarray(state.scale, np.float32), device=device))
    return torch.tensor(np.asarray(state, np.float32), device=device)
