"""The device mesh (port of ``repro.launch.mesh``).

A :class:`Mesh` names its axes and their sizes -- ``(pod, data, model)``
for the train step -- and holds a ``torch.distributed`` process group per
axis that spans processes.  The port runs one card per pod: tensor and data
parallelism inside a pod need several cards a pod, so a mesh with
``data * model > 1`` raises.  The pod axis is one process per pod
(``runtime/steps.py``'s ``impl="shard_map"``) or, within one process, the
pods the train state simulates (``impl="auto"``).  Making a mesh starts no
process and joins no group: the caller initializes ``torch.distributed``
with its address, world size and rank, and the group of an axis defaults to
the world group.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch import not_in_slice

AXES = ("pod", "data", "model")


class Mesh:
    """Axis sizes and the process groups of the axes that span processes.

    ``shape`` maps each axis name to its size (in order); ``groups`` maps an
    axis to its process group (``None``: the world group)."""

    def __init__(self, shape: Dict[str, int], groups: Optional[Dict[str, object]] = None):
        self.shape = dict(shape)
        self._groups = dict(groups or {})

    @property
    def axis_names(self):
        return tuple(self.shape)

    def group(self, axis: str):
        """The process group of ``axis`` (None: the world group)."""
        if axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r}; axes: {self.axis_names}")
        return self._groups.get(axis)

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


def _pod_mesh(pods: int, data: int, model: int, group=None) -> Mesh:
    if data * model > 1:
        raise not_in_slice(
            f"a (pod={pods}, data={data}, model={model}) mesh: tensor and data parallelism "
            "inside a pod need several cards a pod", "item 10b")
    return Mesh({"pod": pods, "data": data, "model": model}, {"pod": group})


def make_production_mesh(*, multi_pod: bool = False):
    raise not_in_slice("the production mesh ((pod=2,) data=16, model=16)", "item 10b")


def make_debug_mesh(pods: int = 2, data: int = 1, model: int = 1, group=None) -> Mesh:
    """A (pods, data, model) mesh with one card a pod: ``data`` and ``model``
    must be 1 (the reference's default is 2 x 2 inside each pod)."""
    return _pod_mesh(pods, data, model, group)


def make_single_device_mesh() -> Mesh:
    """1x1x1 mesh: every code path runs on one device."""
    return _pod_mesh(1, 1, 1)
