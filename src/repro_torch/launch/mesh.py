"""Meshes of ranks: the production shapes, the host mesh over the ranks
of this run, and the batch-axes rule.

PyTorch counterpart of ``repro/launch/mesh.py``.  The port is explicit
SPMD: one process a device, each holding its own shard of every leaf as
a plain local tensor, with the collectives the reference's GSPMD
inserts issued by the model code (``sharding/collectives.py``) over the
per-axis process groups of a :class:`Mesh`.

A :class:`Mesh` is the axis names and sizes, and for the host mesh this
rank's coordinates and the per-axis groups of a torch ``DeviceMesh``
(``init_device_mesh``).  ``make_production_mesh`` gives a mesh of shape
only: the 256 or 512 ranks it names do not exist, and ``batch_axes``
and the partition rules read only names and sizes.

``init_distributed`` starts the default process group of a run from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) or from an explicit ``init_method``:
NCCL with one card a rank on the card (the default), gloo on the CPU
when asked.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


class Mesh:
    """Axis names and sizes; with ``device_mesh`` (a torch
    ``DeviceMesh`` over the same axes), this rank's place on it."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device_mesh = device_mesh
        self._groups, self._coords = {}, {}   # looked up once an axis

    def size(self, axis: str) -> int:
        return self.shape[axis] if axis in self.shape else 1

    def _dm(self, what: str):
        if self.device_mesh is None:
            raise ValueError(f"mesh {self.shape} has shape only: no {what}")
        return self.device_mesh

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if axis not in self._groups:
            self._groups[axis] = self._dm("process groups").get_group(axis)
        return self._groups[axis]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if axis not in self._coords:
            self._coords[axis] = self._dm("ranks").get_local_rank(axis)
        return self._coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 (512 ranks, 2 pods), of
    shape only."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh(data: int = 1, model: int = 1,
                   device="cuda", pod: int = 1) -> Mesh:
    """The (pod, data, model) mesh over the ranks of the initialized
    default process group (``init_distributed``), whose size must be
    ``pod * data * model``: the production axes in the reference's order,
    ``pod`` present only when it is above 1 (a mesh of one pod is the
    (data, model) mesh); rank r sits at (r // (data model), r // model %
    data, r % model).  ``device="cuda"`` (the default) needs a card a
    rank and NCCL; ``"cpu"`` runs on gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group; call "
                           "launch.mesh.init_distributed first")
    shape = ({"pod": pod} if pod > 1 else {})
    shape.update(data=data, model=model)
    world = dist.get_world_size()
    if world != pod * data * model:
        raise ValueError(f"make_host_mesh: {world} ranks for a "
                         f"{' x '.join(map(str, shape.values()))} mesh")
    dm = init_device_mesh(dev.type, tuple(shape.values()),
                          mesh_dim_names=tuple(shape))
    return Mesh(shape, dm)


def init_distributed(data: int = 1, model: int = 1, device="cuda", *,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     timeout: Optional[float] = None) -> torch.device:
    """Start the default process group for a ``data x model`` mesh and
    return this rank's device.  ``rank`` / ``world_size`` default to
    torchrun's ``RANK`` / ``WORLD_SIZE`` (``init_method`` then to its
    ``env://``).  On the card the rank binds ``cuda:LOCAL_RANK`` and
    uses NCCL; the CPU uses gloo.  ``timeout`` (seconds) bounds the
    group's collectives (the backend's default when None).  Raises when
    the world size is not ``data * model`` or the card count is below
    the ranks on this host."""
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    if world != data * model:
        raise ValueError(f"{world} ranks for a {data} x {model} mesh "
                         f"(data x model must be the world size)")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        n = torch.cuda.device_count()
        if n < local_world:
            raise RuntimeError(f"{local_world} ranks on this host need a "
                               f"CUDA card each; {n} found")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {} if timeout is None else dict(timeout=timedelta(
            seconds=timeout))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method or "env://",
                                rank=rank, world_size=world, **kw)
    return dev


def batch_axes(mesh, batch_size: int):
    """Largest prefix of (pod, data) axes that divides batch_size."""
    names = [n for n in ("pod", "data") if n in mesh.axis_names]
    use = []
    div = 1
    for n in names:
        size = mesh.shape[n]
        if batch_size % (div * size) == 0:
            use.append(n)
            div *= size
    if not use:
        return None
    return tuple(use) if len(use) > 1 else use[0]
