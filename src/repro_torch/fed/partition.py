"""Client data partitioners (numpy copy of ``repro.fed.partition``, the
``paper`` scheme).

``paper`` is the source paper's Sec. VI split: client k holds
``per_client`` samples, all labeled ``floor(k * n_classes / clients)``.
The index arrays are identical to the reference's for the same seed.  The
``iid``, ``shard`` and ``dirichlet`` schemes are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch import not_in_slice

__all__ = ["PartitionConfig", "partition_indices"]


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    kind: str = "iid"  # iid | shard | dirichlet | paper
    alpha: float = 0.3
    shards_per_client: int = 2
    per_client: int = 1000  # paper scheme sample cap per client
    min_size: int = 1
    seed: int = 0


def _paper(labels: np.ndarray, clients: int, per_client: int, rng: np.random.Generator):
    n_classes = int(labels.max()) + 1
    parts = []
    for k in range(clients):
        digit = k * n_classes // clients
        idx = np.nonzero(labels == digit)[0]
        parts.append(np.sort(rng.choice(idx, size=min(per_client, idx.size), replace=False)))
    return parts


def partition_indices(labels: np.ndarray, clients: int, cfg: PartitionConfig) -> List[np.ndarray]:
    """Returns ``clients`` index arrays into the dataset ``labels`` indexes."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(cfg.seed)
    if cfg.kind == "paper":
        return _paper(labels, clients, cfg.per_client, rng)
    raise not_in_slice(f"partition kind {cfg.kind!r}", "item 6")
