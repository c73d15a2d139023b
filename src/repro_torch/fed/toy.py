"""The shared toy federation, port of ``repro.fed.toy``: a Gaussian-prototype
classification problem and a softmax linear classifier, small enough that
per-client compute is negligible.  It serves the engine smoke
(``python -m repro_torch.fed``).  The data and the initial weights are the
reference's numpy draws, so both packages start from the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["toy_classification", "toy_loss", "toy_params"]


def toy_classification(n_samples: int = 512, dim: int = 32, classes: int = 4,
                       noise: float = 0.5, seed: int = 0):
    """Returns (x, y): class-prototype Gaussians with pixel noise."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (classes, dim)).astype(np.float32)
    y = rng.integers(0, classes, n_samples).astype(np.int32)
    x = (protos[y] + rng.normal(0, noise, (n_samples, dim))).astype(np.float32)
    return x, y


def toy_loss(params, batch):
    """Softmax cross-entropy of the linear classifier on an {"x","y"} batch."""
    logp = torch.log_softmax(batch["x"] @ params["w"] + params["b"], dim=-1)
    return -torch.mean(torch.gather(logp, 1, batch["y"][:, None]))


def toy_params(dim: int = 32, classes: int = 4, seed: int = 0, device="cpu"):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.tensor(rng.normal(0, 0.1, (dim, classes)), dtype=torch.float32,
                          device=device),
        "b": torch.zeros((classes,), dtype=torch.float32, device=device),
    }
