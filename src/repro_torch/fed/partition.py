"""Client data partitioners (numpy copy of ``repro.fed.partition``).

All partitioners map a label vector to per-client *index* arrays into the
underlying dataset; the data itself is never copied or reordered.
Everything is host-side numpy, deterministic in ``PartitionConfig.seed``,
and copied from the reference step for step, so the index arrays are
identical to the reference's for the same seed.

Schemes:

  * ``iid``        -- a random equal split.
  * ``shard``      -- sort-by-label, cut into ``clients * shards_per_client``
    contiguous shards, deal ``shards_per_client`` to each client.
  * ``dirichlet``  -- per class c, draw p_c ~ Dir(alpha * 1_K) and deal that
    class's samples to clients by p_c; clients below ``min_size`` take
    samples from the largest client.
  * ``paper``      -- the source paper's Sec. VI split: client k holds
    ``per_client`` samples, all labeled ``floor(k * n_classes / clients)``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["PartitionConfig", "partition_indices", "partition_stats"]


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    kind: str = "iid"  # iid | shard | dirichlet | paper
    alpha: float = 0.3  # dirichlet concentration
    shards_per_client: int = 2  # label-shard scheme
    per_client: int = 1000  # paper scheme sample cap per client
    min_size: int = 1  # dirichlet floor (so every client can draw a batch)
    seed: int = 0


def _iid(n: int, clients: int, rng: np.random.Generator) -> List[np.ndarray]:
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, clients)]


def _shard(labels: np.ndarray, clients: int, per: int, rng: np.random.Generator):
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, clients * per)
    deal = rng.permutation(clients * per)
    return [
        np.sort(np.concatenate([shards[s] for s in deal[k * per : (k + 1) * per]]))
        for k in range(clients)
    ]


def _dirichlet(
    labels: np.ndarray, clients: int, alpha: float, min_size: int, rng: np.random.Generator
) -> List[np.ndarray]:
    classes = np.unique(labels)
    buckets: List[List[np.ndarray]] = [[] for _ in range(clients)]
    for c in classes:
        idx = rng.permutation(np.nonzero(labels == c)[0])
        p = rng.dirichlet(np.full(clients, alpha))
        # proportions -> contiguous cut points over this class's samples
        cuts = (np.cumsum(p) * len(idx)).astype(np.int64)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            buckets[k].append(part)
    parts = [np.sort(np.concatenate(b)) if b else np.empty(0, np.int64) for b in buckets]
    # Rebalance starved clients: move samples from the largest client until
    # every client holds >= min_size (bounded: at most clients iterations).
    for k in range(clients):
        while len(parts[k]) < min_size:
            donor = int(np.argmax([len(p) for p in parts]))
            if donor == k or len(parts[donor]) <= min_size:
                break
            take = min(min_size - len(parts[k]), len(parts[donor]) - min_size)
            moved, parts[donor] = parts[donor][:take], parts[donor][take:]
            parts[k] = np.sort(np.concatenate([parts[k], moved]))
    return parts


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
    if cfg.kind == "iid":
        return _iid(len(labels), clients, rng)
    if cfg.kind == "shard":
        return _shard(labels, clients, cfg.shards_per_client, rng)
    if cfg.kind == "dirichlet":
        return _dirichlet(labels, clients, cfg.alpha, cfg.min_size, rng)
    if cfg.kind == "paper":
        return _paper(labels, clients, cfg.per_client, rng)
    raise ValueError(f"unknown partition kind {cfg.kind!r}")


def partition_stats(parts: List[np.ndarray], labels: np.ndarray) -> np.ndarray:
    """(clients, n_classes) label-count matrix — the heterogeneity fingerprint
    (rows of a low-alpha Dirichlet split are near one-hot)."""
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    out = np.zeros((len(parts), n_classes), np.int64)
    for k, p in enumerate(parts):
        if len(p):
            out[k] = np.bincount(labels[p], minlength=n_classes)
    return out
