"""Starts a world of processes: one per device of an in-pod mesh.

    from repro_torch.launch.spawn import run_world
    outs = run_world(fn, 8, args=(...,), device="cpu")

:func:`run_world` starts ``world`` processes with ``torch.multiprocessing``
(``spawn``); each joins a ``gloo`` process group over a ``file://``
rendezvous in a fresh temporary directory and runs ``fn(rank, world,
device, *args)``.  A rank's device is explicit: ``cuda:(rank %
device_count)``, or the CPU when the caller asks for it (each CPU rank on
one torch thread).  gloo, because NCCL refuses two ranks on one card; its
collectives on CUDA tensors run on host copies (``models/sharding.py``).
Every group waits ``timeout_s`` at most.  A rank that raises makes
:func:`run_world` raise with the first rank's traceback (the other ranks
are stopped); what each rank's ``fn`` returns comes back in rank order.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch

from repro_torch import entry_device
from repro_torch.launch.mesh import GROUP_TIMEOUT_S


def _rank_main(rank: int, fn: Callable, world: int, root: str, device: str,
               timeout_s: float, args: Sequence) -> None:
    import torch.distributed as dist

    dev = entry_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, dev, *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(root, f"error{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, args: Sequence = (), device="cuda",
              timeout_s: float = GROUP_TIMEOUT_S) -> List:
    """Runs ``fn(rank, world, device, *args)`` on ``world`` spawned ranks;
    returns their results in rank order.  ``fn`` and ``args`` must pickle
    (a module-level function)."""
    import torch.multiprocessing as mp

    entry_device(device)  # a CUDA device with no card raises here
    root = tempfile.mkdtemp(prefix="repro_torch_world_")
    try:
        try:
            mp.spawn(_rank_main, args=(fn, world, root, str(device), timeout_s, tuple(args)),
                     nprocs=world, join=True)
        except Exception as e:
            first = _first_error(root, world)
            if first is None:
                raise
            raise RuntimeError(f"rank {first[0]} of {world} raised:\n{first[1]}") from e
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _first_error(root: str, world: int):
    """(rank, traceback) of the rank that raised first, or None."""
    errors = []
    for r in range(world):
        path = os.path.join(root, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                stamp, _, tb = f.read().partition("\n")
            errors.append((float(stamp), r, tb))
    return min(errors)[1:] if errors else None
