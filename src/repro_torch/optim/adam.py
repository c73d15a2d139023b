"""Adam over parameter dicts, fp32 states (port of ``repro.optim.adam``).

The update is written out as the reference writes it -- bias terms
``1 - b**t`` in float32, ``mhat / (sqrt(vhat) + eps)`` -- rather than
through ``torch.optim.Adam``, whose arithmetic order differs.  The
blockwise-int8 moment states and SGD are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import not_in_slice

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adam"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"
    momentum: float = 0.9


def _check_ported(cfg: OptConfig) -> None:
    if cfg.kind != "adam" or cfg.state_dtype != "float32":
        raise not_in_slice(f"optimizer kind={cfg.kind!r} state_dtype={cfg.state_dtype!r}",
                           "item 6")


def schedule(cfg: OptConfig, step) -> float:
    """Linear warmup -> cosine decay to min_lr_frac, in float32 arithmetic on
    the host (a Python float holding the f32 value, so no scalar is copied to
    the device -- which would synchronise the stream)."""
    f = np.float32
    step = f(step)
    warm = min((step + f(1.0)) / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip(
        (step - f(cfg.warmup_steps)) / f(max(cfg.decay_steps - cfg.warmup_steps, 1)),
        f(0.0), f(1.0),
    )
    cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * prog))
    frac = f(cfg.min_lr_frac) + (f(1.0) - f(cfg.min_lr_frac)) * cos
    return float(f(cfg.lr) * warm * frac)


def init_state(cfg: OptConfig, params: Params) -> Dict[str, Params]:
    _check_ported(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()}}


def update(cfg: OptConfig, grads: Params, state, params: Params, step) -> Tuple[Params, dict]:
    _check_ported(cfg)
    lr = schedule(cfg, step)
    if cfg.grad_clip > 0:
        gn = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads.values()))
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
        grads = {k: g * clip for k, g in grads.items()}
    t = np.float32(step) + np.float32(1.0)
    bias1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)  # f32, as the reference
    bias2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].float()
        mf = cfg.b1 * state["m"][k] + (1 - cfg.b1) * gf
        vf = cfg.b2 * state["v"][k] + (1 - cfg.b2) * (gf * gf)
        step_dir = (mf / bias1) / (torch.sqrt(vf / bias2) + cfg.eps)
        q = p.float() - lr * step_dir
        if cfg.weight_decay:
            q = q - lr * cfg.weight_decay * p.float()
        new_p[k], new_m[k], new_v[k] = q.to(p.dtype), mf, vf
    return new_p, {"m": new_m, "v": new_v}
