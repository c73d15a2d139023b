"""MNIST loader with an offline surrogate (numpy copy of ``repro.data.mnist``;
its arrays are identical to the reference's for the same seed).

If real MNIST IDX files exist under $MNIST_DIR (train-images-idx3-ubyte etc.,
optionally .gz), they are used.  Otherwise a deterministic class-conditional
surrogate ("synthMNIST") is generated: per-class Gaussian prototype images +
pixel noise, same shapes/splits (60k train / 10k test, 28x28 in [0,1]).
The paper's claims validated on the surrogate are *relative* (compressed vs
uncompressed accuracy; NMSE ordering across frameworks) -- see DESIGN.md.

Federation splits live in repro_torch.fed.partition and operate on the
label vector returned here.
"""

from __future__ import annotations

import functools
import gzip
import os
import struct

import numpy as np

N_TRAIN, N_TEST, DIM, N_CLASSES = 60_000, 10_000, 784, 10


def _read_idx(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        ndim = magic[2]
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _load_real(root: str):
    def find(stem):
        for suffix in ("", ".gz"):
            p = os.path.join(root, stem + suffix)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(stem)

    xtr = _read_idx(find("train-images-idx3-ubyte")).reshape(-1, DIM) / 255.0
    ytr = _read_idx(find("train-labels-idx1-ubyte"))
    xte = _read_idx(find("t10k-images-idx3-ubyte")).reshape(-1, DIM) / 255.0
    yte = _read_idx(find("t10k-labels-idx1-ubyte"))
    return (xtr.astype(np.float32), ytr.astype(np.int32),
            xte.astype(np.float32), yte.astype(np.int32))


@functools.lru_cache(maxsize=1)
def _synth_arrays(seed: int):
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.35, 0.18, (N_CLASSES, DIM)).clip(0, 1).astype(np.float32)

    def make(n):
        y = rng.integers(0, N_CLASSES, n).astype(np.int32)
        x = protos[y] + rng.normal(0, 0.45, (n, DIM)).astype(np.float32)
        return x.clip(0, 1).astype(np.float32), y

    xtr, ytr = make(N_TRAIN)
    xte, yte = make(N_TEST)
    return xtr, ytr, xte, yte


def _synth(seed: int = 0):
    """Class-conditional surrogate, tuned so a 784-20-10 MLP needs a few
    hundred Adam steps to separate the classes (like real MNIST) rather than
    a handful -- per-class signal lives in a low-dim subspace under heavy
    pixel noise.  Drawn once a process for the last seed asked; each call
    gets its own copies."""
    return tuple(a.copy() for a in _synth_arrays(seed))


def load(seed: int = 0):
    """Returns (x_train, y_train, x_test, y_test), real data if available."""
    root = os.environ.get("MNIST_DIR", "")
    if root and os.path.isdir(root):
        try:
            return _load_real(root), True
        except FileNotFoundError:
            pass
    return _synth(seed), False
