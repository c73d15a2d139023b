"""The device mesh (port of ``repro.launch.mesh``).

A :class:`Mesh` names its axes and their sizes -- ``(pod, data, model)``
for the train step -- and holds the ``torch.distributed`` process groups of
the axes that span processes.  Two kinds:

  * ``data * model == 1`` (one device a pod): the pod axis is one process
    per pod (``runtime/steps.py``'s ``impl="shard_map"``) or, within one
    process, the pods the train state simulates (``impl="auto"``).  Its
    ``pod`` group defaults to the world group.
  * ``data * model > 1`` (the reference's in-pod "2D FSDP x TP" layout):
    one process per device, ``pods * data * model`` in all, rank
    ``(pod * data + d) * model + m`` at ``(pod, d, m)`` -- the reference
    mesh's device order.  Its groups: ``data`` (the ranks that share a pod
    and a model index), ``model`` (a pod and a data index), ``("data",
    "model")`` (one pod's ranks) and ``pod`` (the ranks that share an
    in-pod position across pods: where the pod exchange runs).

Making a mesh starts no process.  An in-pod mesh made while
``torch.distributed`` is initialized (a world of the mesh's size, e.g. from
``launch/spawn.py``) builds its groups at once -- every rank makes the same
call -- and one made without holds its shape alone (its specs, geometry
and placement work; its groups raise).
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional

from repro_torch import not_in_slice

AXES = ("pod", "data", "model")
GROUP_TIMEOUT_S = 600.0  # a collective that waits longer raises


class Mesh:
    """Axis sizes, this process's rank and the process groups of the axes
    that span processes.

    ``shape`` maps each axis name to its size (in order); ``groups`` maps an
    axis (or a tuple of axes) to its process group (``None``: the world
    group); ``rank`` is this process's rank on an in-pod mesh."""

    def __init__(self, shape: Dict[str, int], groups: Optional[Dict[object, object]] = None,
                 rank: Optional[int] = None):
        self.shape = dict(shape)
        self._groups = dict(groups or {})
        self.rank = rank

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self) -> int:
        out = 1
        for v in self.shape.values():
            out *= v
        return out

    @property
    def inpod(self) -> bool:
        """Whether a pod spans several devices (``data * model > 1``)."""
        return self.shape.get("data", 1) * self.shape.get("model", 1) > 1

    def group(self, axis):
        """The process group of ``axis`` or of a tuple of axes (None: the
        world group)."""
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a not in self.shape:
                raise KeyError(f"mesh has no axis {a!r}; axes: {self.axis_names}")
        if self.inpod and axis not in self._groups:
            raise RuntimeError(self._no_world("process groups"))
        return self._groups.get(axis)

    def _no_world(self, what: str) -> str:
        return (f"the in-pod mesh {self.shape} has no {what}: make it inside a world of "
                f"{self.size} processes (repro_torch.launch.spawn.run_world)")

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The mesh coordinates of ``rank`` (default: this process's)."""
        rank = self.rank if rank is None else rank
        if rank is None:
            raise RuntimeError(self._no_world("rank for this process"))
        out = {}
        for axis in reversed(self.axis_names):
            rank, out[axis] = divmod(rank, self.shape[axis])
        return {a: out[a] for a in self.axis_names}

    def check_group(self, axis: str) -> int:
        """The rank of this process on ``axis``; raises unless
        ``torch.distributed`` is initialized with a group of the axis's size."""
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                f"the mesh axis {axis!r} spans processes: initialize torch.distributed "
                f"with world size {self.shape[axis]} first")
        group = self.group(axis)
        world = dist.get_world_size(group)
        if world != self.shape[axis]:
            raise ValueError(
                f"the {axis!r} axis has size {self.shape[axis]} but its process group "
                f"holds {world} processes")
        return dist.get_rank(group)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _inpod_groups(mesh: Mesh) -> Dict[object, object]:
    """Every rank makes every group, in one order (``new_group`` is a
    collective); each keeps the groups it belongs to."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    mine = mesh.coords()
    members = {}  # axis key -> {the other axes' coordinates: [ranks]}
    for key in ("pod", "data", "model", ("data", "model")):
        free = key if isinstance(key, tuple) else (key,)
        table = members.setdefault(key, {})
        for rank in range(mesh.size):
            c = mesh.coords(rank)
            table.setdefault(tuple(c[a] for a in AXES if a not in free), []).append(rank)
    groups = {}
    for key, table in members.items():
        free = key if isinstance(key, tuple) else (key,)
        here = tuple(mine[a] for a in AXES if a not in free)
        for fixed, ranks in table.items():
            g = dist.new_group(ranks, timeout=timeout)
            if fixed == here:
                groups[key] = g
    return groups


def make_production_mesh(*, multi_pod: bool = False):
    raise not_in_slice("the production mesh ((pod=2,) data=16, model=16) and its dry-run",
                       "item 10g")


def make_debug_mesh(pods: int = 2, data: int = 1, model: int = 1, group=None) -> Mesh:
    """A (pods, data, model) mesh.  With ``data * model == 1``, ``group`` is
    the pod axis's process group (None: the world group).  Otherwise an
    in-pod mesh: inside an initialized world of ``pods * data * model``
    processes it builds its groups (each waits GROUP_TIMEOUT_S at most);
    with ``torch.distributed`` not initialized it holds its shape alone."""
    mesh = Mesh({"pod": pods, "data": data, "model": model}, {"pod": group})
    if not mesh.inpod:
        return mesh
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(mesh.shape)
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"a {mesh.shape} mesh needs a world of {mesh.size} processes, "
                         f"torch.distributed holds {world}")
    mesh = Mesh(mesh.shape, rank=dist.get_rank())
    mesh._groups = _inpod_groups(mesh)
    return mesh


def make_single_device_mesh() -> Mesh:
    """1x1x1 mesh: every code path runs on one device."""
    return make_debug_mesh(1, 1, 1)
