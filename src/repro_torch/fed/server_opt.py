"""Server-side optimizer over the reconstructed aggregate (port of
``repro.fed.server_opt``, ``fedadam`` only).

FedAdam is server Adam with clipping, warmup and decay disabled -- the
update the paper's Sec. VI experiment ran.  ``fedavg`` and ``fedavgm`` are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch import not_in_slice
from repro_torch.optim import adam

__all__ = ["ServerOptConfig", "init_server_state", "server_update"]


@dataclasses.dataclass(frozen=True)
class ServerOptConfig:
    kind: str = "fedadam"  # fedavg | fedavgm | fedadam
    lr: float = 0.003
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def _adam_cfg(self) -> adam.OptConfig:
        return adam.OptConfig(
            lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps, grad_clip=0.0,
            warmup_steps=0, decay_steps=10**9, min_lr_frac=1.0,
        )


def _check(cfg: ServerOptConfig) -> None:
    if cfg.kind != "fedadam":
        raise not_in_slice(f"server optimizer {cfg.kind!r}", "item 6")


def init_server_state(cfg: ServerOptConfig, params) -> Dict[str, Any]:
    _check(cfg)
    return adam.init_state(cfg._adam_cfg(), params)


def server_update(cfg: ServerOptConfig, ghat, state, params, step) -> Tuple[Any, Dict[str, Any]]:
    """One server round: (params, state) <- Adam(params, ghat)."""
    _check(cfg)
    return adam.update(cfg._adam_cfg(), ghat, state, params, step)
