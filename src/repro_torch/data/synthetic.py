"""Deterministic synthetic token data (port of ``repro.data.synthetic``).

:class:`TokenDataset` is a learnable synthetic "language" (a noisy affine
next-token rule) keyed purely by ``(seed, step, shard)``: a batch is a pure
function of those three, so re-running any step reproduces its batch, which
is what exact checkpoint/resume checks rest on.  The draws come from a
seeded CPU ``torch.Generator`` (not the reference's threefry: ROADMAP.md
item 12), so the port's batches are not the reference's; the parity tests
inject the reference's batches instead.  Tokens are int64, torch's index
dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import entry_device

__all__ = ["affine_rule_batch", "batch_generator", "TokenDataset"]


def batch_generator(*key: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of ints (seed, step, shard)."""
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement, as the reference's
    int32 arithmetic wraps."""
    return (x + 2**31) % 2**32 - 2**31


def affine_rule_batch(gen: torch.Generator, batch: int, seq: int, vocab_size: int,
                      noise: float, c: int = 17):
    """The synthetic language: sequences follow ``(start * 31**(i % 8) + c*i)
    % vocab`` in int32 arithmetic, as the reference computes it; a
    ``noise`` fraction of positions is replaced by uniform random tokens.
    Returns ``{"tokens", "labels"}`` (batch, seq) int64 on the CPU."""
    start = torch.randint(0, vocab_size, (batch, 1), generator=gen, dtype=torch.int64)
    idx = torch.arange(seq + 1, dtype=torch.int64)
    power = _wrap_int32(torch.tensor([31**k for k in range(8)], dtype=torch.int64))[idx % 8]
    seqs = _wrap_int32(_wrap_int32(start * power) + _wrap_int32(c * idx)) % vocab_size
    noise_mask = torch.rand(seqs.shape, generator=gen) < noise
    random_toks = torch.randint(0, vocab_size, seqs.shape, generator=gen, dtype=torch.int64)
    seqs = torch.where(noise_mask, random_toks, seqs)
    return {"tokens": seqs[:, :-1].contiguous(), "labels": seqs[:, 1:].contiguous()}


@dataclasses.dataclass(frozen=True)
class TokenDataset:
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    noise: float = 0.2  # fraction of random next-tokens

    def get_batch(self, step: int, shard: int = 0, n_shards: int = 1, device="cuda"):
        """``{"tokens", "labels"}`` for this step and shard: a pure function
        of (seed, step, shard), moved to ``device``."""
        dev = entry_device(device)
        out = affine_rule_batch(batch_generator(self.seed, step, shard),
                                self.batch // n_shards, self.seq, self.vocab_size, self.noise)
        return {k: v.to(dev) for k, v in out.items()}
