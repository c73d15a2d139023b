"""Server-side optimizers over the reconstructed aggregate (port of
``repro.fed.server_opt``).

The PS treats the reconstructed, rho-weighted aggregate as a
pseudo-gradient and applies one server update per round:

  * ``fedavg``  -- plain SGD: ``params -= lr * ghat``.
  * ``fedavgm`` -- server momentum: ``m = momentum * m + ghat;
    params -= lr * m``, with ``m`` in fp32.
  * ``fedadam`` -- server Adam (``optim/adam.py``) with clipping, warmup and
    decay disabled: the update the paper's Sec. VI experiment ran.

Parameters, aggregate and states are trees of ``repro_torch.tree`` (flat or
nested dicts); the plain updates run in fp32 and cast back to each
parameter's dtype, as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.optim import adam

__all__ = ["ServerOptConfig", "init_server_state", "server_update"]


@dataclasses.dataclass(frozen=True)
class ServerOptConfig:
    kind: str = "fedadam"  # fedavg | fedavgm | fedadam
    lr: float = 0.003
    momentum: float = 0.9  # fedavgm
    b1: float = 0.9  # fedadam
    b2: float = 0.999
    eps: float = 1e-8

    def _adam_cfg(self) -> adam.OptConfig:
        return adam.OptConfig(
            lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps, grad_clip=0.0,
            warmup_steps=0, decay_steps=10**9, min_lr_frac=1.0,
        )


def init_server_state(cfg: ServerOptConfig, params) -> Dict[str, Any]:
    if cfg.kind == "fedadam":
        return adam.init_state(cfg._adam_cfg(), params)
    if cfg.kind == "fedavgm":
        return {"m": tree_util.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)}
    if cfg.kind == "fedavg":
        return {}
    raise ValueError(f"unknown server optimizer {cfg.kind!r}")


def server_update(cfg: ServerOptConfig, ghat, state, params, step) -> Tuple[Any, Dict[str, Any]]:
    """One server round: (params, state) <- update(params, ghat)."""
    if cfg.kind == "fedadam":
        return adam.update(cfg._adam_cfg(), ghat, state, params, step)
    if cfg.kind == "fedavgm":
        new_m = tree_util.tree_map(lambda m, g: cfg.momentum * m + g.float(), state["m"], ghat)
        new_p = tree_util.tree_map(lambda p, m: (p.float() - cfg.lr * m).to(p.dtype),
                                   params, new_m)
        return new_p, {"m": new_m}
    if cfg.kind == "fedavg":
        new_p = tree_util.tree_map(lambda p, g: (p.float() - cfg.lr * g.float()).to(p.dtype),
                                   params, ghat)
        return new_p, state
    raise ValueError(f"unknown server optimizer {cfg.kind!r}")
