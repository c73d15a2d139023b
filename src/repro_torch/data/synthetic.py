"""Deterministic synthetic token data (port of ``repro.data.synthetic``).

:class:`TokenDataset` is a learnable synthetic "language" (a noisy affine
next-token rule) keyed purely by ``(seed, step, shard)``: a batch is a pure
function of those three, so re-running any step reproduces its batch, which
is what exact checkpoint/resume checks rest on.  The draws are the
reference's threefry draws (``repro_torch.prng``) along its key path, so
a batch equals the reference's bit for bit.  Tokens are int64, torch's
index dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import entry_device, prng

__all__ = ["affine_rule_batch", "TokenDataset"]


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement, as the reference's
    int32 arithmetic wraps."""
    return (x + 2**31) % 2**32 - 2**31


def affine_rule_batch(k_start: torch.Tensor, k_noise: torch.Tensor, k_rand: torch.Tensor,
                      batch: int, seq: int, vocab_size: int, noise: float, c=17):
    """The synthetic language: sequences follow ``(start * 31**(i % 8) + c*i)
    % vocab`` in int32 arithmetic, as the reference computes it; a
    ``noise`` fraction of positions is replaced by uniform random tokens.
    ``start`` is ``randint(k_start)``, the noise mask ``bernoulli(k_noise)``
    and the random tokens ``randint(k_rand)``; ``c`` is an int or a
    (batch, 1) tensor of per-sequence constants.  Returns ``{"tokens",
    "labels"}`` (batch, seq) int64 on the keys' device.  ``(C, 2)`` keys
    draw C such batches at once, ``(C, batch, seq)``, ``c`` then ``(C,
    batch, 1)`` (the reference's vmap over its keys)."""
    dev = k_start.device
    start = prng.randint(k_start, (batch, 1), 0, vocab_size)
    idx = torch.arange(seq + 1, dtype=torch.int64, device=dev)
    power = _wrap_int32(torch.tensor([31**k for k in range(8)], dtype=torch.int64,
                                     device=dev))[idx % 8]
    seqs = _wrap_int32(_wrap_int32(start * power) + _wrap_int32(c * idx)) % vocab_size
    noise_mask = prng.bernoulli(k_noise, noise, (batch, seq + 1))
    random_toks = prng.randint(k_rand, (batch, seq + 1), 0, vocab_size)
    seqs = torch.where(noise_mask, random_toks, seqs)
    return {"tokens": seqs[..., :-1].contiguous(), "labels": seqs[..., 1:].contiguous()}


@dataclasses.dataclass(frozen=True)
class TokenDataset:
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    noise: float = 0.2  # fraction of random next-tokens

    def get_batch(self, step: int, shard: int = 0, n_shards: int = 1, device="cuda"):
        """``{"tokens", "labels"}`` for this step and shard, drawn on
        ``device`` from ``split(fold_in(fold_in(PRNGKey(seed), step),
        shard), 3)``: a pure function of (seed, step, shard)."""
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(self.seed, device=entry_device(device)),
                                        step), shard)
        k1, k2, k3 = prng.split(key, 3).unbind(-2)
        return affine_rule_batch(k1, k2, k3, self.batch // n_shards, self.seq,
                                 self.vocab_size, self.noise)
