"""A result computed once for a whole pytest run and shared by its xdist
workers (the port's parity tests keep their reference runs here)."""

import fcntl
import os
import pickle


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
