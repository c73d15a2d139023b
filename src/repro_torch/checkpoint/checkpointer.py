"""Fault-tolerant checkpointing (port of ``repro.checkpoint.checkpointer``),
in the reference's format.

A checkpoint is one ``.npz`` of the state's leaves under their ``/``-joined
paths (an optimizer ``QLeaf`` as ``<path>.q`` and ``<path>.scale``) and a
JSON manifest (step, format, each entry's shape and dtype).  Both are
written to a temporary file and renamed into place, so a crash mid-write
never corrupts the latest checkpoint; with ``async_save`` the file write
runs on a thread (the copy to the host stays synchronous) and the next save
or :meth:`Checkpointer.wait` joins it, raising what the write raised.

bfloat16 tensors (numpy has no such dtype) are stored as their uint16 bit
patterns and restored bit for bit; a bfloat16 entry the reference wrote
restores the same way.  A checkpoint the reference wrote restores into
the port: the names are the same.

On an in-pod mesh a checkpoint is the whole state all the same: every rank
calls :meth:`Checkpointer.save` with its shard and the whole state's specs,
the shards are gathered and rank 0 writes; :meth:`Checkpointer.restore`
with specs and a mesh gives each rank its shard of each entry (an int8
moment: its shard of ``<path>.q`` and the whole ``<path>.scale``).  A state
saved on one mesh restores onto any other (restart, elastic resharding).
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.models.sharding import gather_leaf, local_shard
from repro_torch.optim.adam import QLeaf

_NP_OF = {torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64,
          torch.int8: np.int8, torch.uint8: np.uint8, torch.float64: np.float64}


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> dict:
    flat = {}
    for path, leaf in tree_util.leaves(tree):
        name = tree_util.slash(path)
        if isinstance(leaf, QLeaf):
            flat[name + ".q"] = _host(leaf.q)
            flat[name + ".scale"] = _host(leaf.scale)
        else:
            flat[name] = _host(leaf)
    return flat


def _tensor(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """A saved entry as a tensor of the template leaf's dtype and shape."""
    if like.dtype == torch.bfloat16:
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16, copy=False)
        out = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        out = torch.from_numpy(np.asarray(arr, _NP_OF[like.dtype]).copy())
    if tuple(out.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint entry has shape {tuple(out.shape)}, the template "
                         f"{tuple(like.shape)}")
    return out.to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, specs: Any = None, mesh=None):
        """Writes ``tree`` as checkpoint ``step``.  On an in-pod ``mesh``
        every rank calls it with its shard of the state and ``specs`` (the
        whole state's, ``runtime.steps.state_specs``): the shards are
        gathered, rank 0 writes and the others return."""
        if mesh is not None and mesh.inpod:
            tree = tree_util.unflatten(
                (path, gather_leaf(leaf, tree_util.get(specs, path), mesh))
                for path, leaf in tree_util.leaves_in_order(tree))
            if mesh.rank != 0:
                return
        flat = _flatten(tree)  # the copy to the host happens here, synchronously
        self.wait()  # double-buffer: the previous write finishes first
        if self.async_save:
            self._pending = threading.Thread(target=self._write_catching, args=(step, flat))
            self._pending.start()
        else:
            self._write(step, flat)

    def _write_catching(self, step: int, flat: dict):
        try:
            self._write(step, flat)
        except BaseException as e:  # re-raised by wait() on the caller's thread
            self._error = e

    def _write(self, step: int, flat: dict):
        tmp = os.path.join(self.dir, f".tmp-{step}.npz")
        final = os.path.join(self.dir, f"ckpt-{step:08d}.npz")
        np.savez(tmp, **flat)
        os.replace(tmp, final)
        manifest = {
            "step": step,
            "format": "npz-v1",
            "leaves": {k: [list(v.shape), str(v.dtype)] for k, v in flat.items()},
        }
        mtmp = os.path.join(self.dir, f".tmp-{step}.json")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(self.dir, f"ckpt-{step:08d}.json"))
        self._gc()

    def wait(self):
        """Joins the pending write; raises what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.dir, f"ckpt-{s:08d}{ext}"))
                except FileNotFoundError:
                    pass

    # -- restore --------------------------------------------------------------
    def steps(self):
        out = []
        for f in os.listdir(self.dir):
            m = re.match(r"ckpt-(\d+)\.npz$", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: Optional[int] = None, device=None,
                specs: Any = None, mesh=None):
        """Loads into the structure, dtypes and shapes of ``template`` (which
        may hold ``meta`` tensors) and places every tensor on ``device``
        (default: each template leaf's own device).  With ``specs`` and a
        ``mesh`` that has this process's rank, ``template`` is the whole
        state and each entry is cut to the rank's shard.  Returns (tree,
        step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        self.wait()
        out = []
        with np.load(os.path.join(self.dir, f"ckpt-{step:08d}.npz")) as data:
            for path, leaf in tree_util.leaves_in_order(template):
                name = tree_util.slash(path)
                if isinstance(leaf, QLeaf):
                    dev = device if device is not None else leaf.q.device
                    t = QLeaf(q=_tensor(data[name + ".q"], leaf.q, "cpu"),
                              scale=_tensor(data[name + ".scale"], leaf.scale, "cpu"))
                else:
                    dev = device if device is not None else leaf.device
                    t = _tensor(data[name], leaf, "cpu")
                if specs is not None and getattr(mesh, "rank", None) is not None:
                    t = local_shard(t, tree_util.get(specs, path), mesh.shape, mesh.coords())
                out.append((path, QLeaf(*(v.to(dev) for v in t)) if isinstance(t, QLeaf)
                            else t.to(dev)))
        return tree_util.unflatten(out), step
