"""Client participation scheduler (numpy copy of ``repro.fed.scheduler``,
the ``full`` kind).

``full``: every client, every round (the paper's Sec. VI setting), with
the reference's straggler dropout and data-size-proportional weights
``rho_k ∝ |D_k|`` renormalized over the surviving cohort.  Host-side numpy,
deterministic in (seed, round), identical to the reference.  The
``uniform`` and ``async`` kinds are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch import not_in_slice

__all__ = ["SchedulerConfig", "SchedulerState", "select_cohort"]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    kind: str = "full"  # full | uniform | async
    sample_frac: float = 1.0
    dropout_prob: float = 0.0
    staleness_decay: float = 0.5
    seed: int = 0


@dataclasses.dataclass
class SchedulerState:
    """``last_round[k]`` = round of client k's last successful participation."""

    last_round: np.ndarray

    @classmethod
    def init(cls, clients: int) -> "SchedulerState":
        return cls(last_round=np.full(clients, -1, np.int64))


def select_cohort(
    cfg: SchedulerConfig, state: SchedulerState, round_idx: int, counts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, SchedulerState]:
    """Returns (cohort client ids (C,), rhos (C,) summing to 1 (or all zero if
    the whole cohort dropped), updated state)."""
    if cfg.kind != "full":
        raise not_in_slice(f"scheduler kind {cfg.kind!r}", "item 6")
    rng = np.random.default_rng((cfg.seed, 0x5EED, round_idx))
    ids = np.arange(len(counts))
    alive = (
        rng.random(len(ids)) >= cfg.dropout_prob
        if cfg.dropout_prob > 0
        else np.ones(len(ids), bool)
    )
    w = np.asarray(counts, np.float64)[ids] * alive
    total = w.sum()
    rhos = (w / total if total > 0 else w).astype(np.float32)
    new_state = SchedulerState(last_round=state.last_round.copy())
    new_state.last_round[ids[alive]] = round_idx
    return ids, rhos, new_state
