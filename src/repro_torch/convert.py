"""Carries the reference's state across to the port.

The port draws its random state as the reference does (threefry keys,
``repro_torch.prng``), so a seed gives both packages the same parameters
and sensing matrix.  These helpers carry over state that no seed names: a
reference run's arrays at any point.  :func:`from_reference` takes the
reference's parameters and sensing matrix as numpy arrays (``np.asarray``
of the JAX arrays) and returns the port's:
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


def _param(v, device) -> torch.Tensor:
    """One parameter as a float32 tensor; a bfloat16 one (the model zoo's
    default dtype) stays bfloat16, carried through float32 exactly."""
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(np.asarray(arr, np.float32), device=device)


def from_reference(
    params_np: Dict[str, Any], a_np: Optional[np.ndarray] = None, device="cpu"
) -> Tuple[Dict[str, Any], Optional[torch.Tensor]]:
    """(params dict, sensing matrix or None) as tensors on ``device``.  The
    parameter dict may be flat or nested (the model zoo's trees, with fp32
    leaves such as the MoE router among bf16 ones); the structure, key
    order and each leaf's dtype are kept.  A serve cache (the reference's
    ``{"k", "v"}`` or MLA ``{"ckv", "kr"}`` of ``prefill``/``init_cache``)
    carries across the same way, so decode can start from the reference's
    own cache."""
    params = {
        k: from_reference(v, device=device)[0] if isinstance(v, dict) else _param(v, device)
        for k, v in params_np.items()
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
