"""What the port's parity tests share: a result computed once for a whole
pytest run and shared by its xdist workers (the reference runs), and the
one-torch-thread fixture."""

import fcntl
import os
import pickle

import pytest


def shared(tmp_path_factory, name, compute):
    """``compute()``'s result, computed once for the whole run: the first
    pytest worker to get here computes and pickles it, the others wait on
    the lock and load it (the workers of one run share the parent of their
    temporary directories)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(pickle.dumps(compute()))
            tmp.rename(path)
        return pickle.loads(path.read_bytes())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread under several pytest workers: the port's tests run
    many small ops, and a thread pool a worker oversubscribes the cores.
    A module takes it by importing it."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
