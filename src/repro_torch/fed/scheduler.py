"""Client participation schedulers (numpy copy of ``repro.fed.scheduler``).

A scheduler decides, per round, which clients compute and with what
aggregation weight: it produces the ``rho_k`` vector the reconstruction
consumes.  A scheduled-but-dropped client keeps its cohort slot with
``rho_k = 0``.

Kinds:

  * ``full``     -- every client, every round (the paper's Sec. VI setting).
  * ``uniform``  -- ``ceil(sample_frac * K)`` clients drawn uniformly without
    replacement.
  * ``async``    -- uniform sampling, each selected client's weight
    discounted by its staleness (rounds since it last participated) with
    ``(1 + staleness) ** -staleness_decay``.

After selection each cohort member fails independently with
``dropout_prob``.  Weights are data-size proportional before the staleness
discount and renormalized over the surviving cohort.  Host-side numpy,
deterministic in (seed, round), copied from the reference step for step
(the ``0x5EED`` stream, the order of the draws, the staleness clip), so
ids and weights are identical to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["SchedulerConfig", "SchedulerState", "select_cohort", "staleness_discount"]


def staleness_discount(staleness: np.ndarray, decay: float) -> np.ndarray:
    """Polynomial trust discount ``(1 + staleness) ** -decay``.

    Shared between the async scheduler (staleness = rounds since last
    participation) and the streaming PS (staleness = soft-deadline overrun of
    a late arrival, ``repro.fed.stream``): both are "older information gets
    down-weighted" with the same knee.  Monotone non-increasing in staleness,
    identity at staleness 0 or decay 0; negative staleness clips to 0.
    """
    return (1.0 + np.maximum(np.asarray(staleness, np.float64), 0.0)) ** (-decay)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    kind: str = "full"  # full | uniform | async
    sample_frac: float = 1.0  # cohort fraction for uniform/async
    dropout_prob: float = 0.0  # per-round straggler probability
    staleness_decay: float = 0.5  # async polynomial discount exponent
    seed: int = 0


@dataclasses.dataclass
class SchedulerState:
    """``last_round[k]`` = round of client k's last successful participation
    (-1 = never).  Only the async scheduler reads it; all kinds update it."""

    last_round: np.ndarray

    @classmethod
    def init(cls, clients: int) -> "SchedulerState":
        return cls(last_round=np.full(clients, -1, np.int64))


def select_cohort(
    cfg: SchedulerConfig,
    state: SchedulerState,
    round_idx: int,
    counts: np.ndarray,  # (K,) per-client sample counts (rho ∝ counts)
) -> Tuple[np.ndarray, np.ndarray, SchedulerState]:
    """Returns (cohort client ids (C,), rhos (C,) summing to 1 (or all zero if
    the whole cohort dropped), updated state)."""
    k = len(counts)
    # 0x5EED namespaces this stream away from the data-sampling rng, which
    # may share the same user-facing seed (see ArrayClientData).
    rng = np.random.default_rng((cfg.seed, 0x5EED, round_idx))
    if cfg.kind == "full":
        ids = np.arange(k)
    elif cfg.kind in ("uniform", "async"):
        c = max(1, int(np.ceil(cfg.sample_frac * k)))
        ids = np.sort(rng.choice(k, size=min(c, k), replace=False))
    else:
        raise ValueError(f"unknown scheduler kind {cfg.kind!r}")

    alive = (
        rng.random(len(ids)) >= cfg.dropout_prob
        if cfg.dropout_prob > 0
        else np.ones(len(ids), bool)
    )
    w = np.asarray(counts, np.float64)[ids] * alive
    if cfg.kind == "async" and cfg.staleness_decay > 0:
        staleness = np.where(
            state.last_round[ids] < 0, 0, round_idx - 1 - state.last_round[ids]
        ).clip(min=0)
        w = w * staleness_discount(staleness, cfg.staleness_decay)
    total = w.sum()
    rhos = (w / total if total > 0 else w).astype(np.float32)

    new_state = SchedulerState(last_round=state.last_round.copy())
    new_state.last_round[ids[alive]] = round_idx
    return ids, rhos, new_state
