# The data mesh, the port of `lfdtpu/parallel/mesh.py`.
#
# lfdtpu's Mesh is a grid of devices that one program drives, with the
# batch split over its `data` axis by GSPMD shardings. In torch one process
# drives one device, so a mesh is this process's place in the process
# group: its rank, the world size, its device and the group. The GSPMD
# objects have no counterpart: where lfdtpu puts a global array with
# batch_sharding (dim 0 over `data`) or replicated_sharding, each rank takes
# its own rows (shard_batch, local_batch_slice) and keeps whole copies of
# the parameters (DistributedDataParallel keeps them equal).
#
# The spatial axis (lfdtpu's `make_mesh(spatial=k)` and
# `spatial_image_sharding`, the image height split over devices with conv
# halo exchanges) is ROADMAP queue 1, item 8b.

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from .distributed import local_batch_slice, rank_device
from .prefetch import prefetch_to_device

__all__ = ["Mesh", "make_mesh", "shard_batch", "prefetch_to_device"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data mesh: `world_size` processes, one
    device each, in the process group `group` (None: a mesh of one device
    without a process group)."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def size(self):
        return self.world_size

    def __deepcopy__(self, memo):
        # a handle on the process group: a copied net (an engine's) shares it
        return self


def make_mesh(devices=None, spatial=1):
    """The data mesh over the initialized process group, one device a rank,
    or a mesh of size 1 without one.

    devices: this rank's device, or a list with one device a rank (this
    rank takes its own), or None: the rank's card (cuda:LOCAL_RANK) in a
    process group, else "cuda" (raises without a card; pass "cpu")."""
    if spatial != 1:
        raise NotImplementedError("the spatial mesh axis is not ported yet "
                                  "(ROADMAP queue 1, item 8b)")
    grouped = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if grouped else (0, 1)
    if isinstance(devices, (list, tuple)):
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a process group of {world} "
                             "ranks: one process drives one device")
        devices = devices[rank]
    if devices is None and grouped:
        devices = rank_device()
    return Mesh(world, rank, resolve_device(devices, "the mesh's device"),
                dist.group.WORLD if grouped else None)


def shard_batch(mesh, *arrays):
    """This rank's rows (local_batch_slice) of each global array, as tensors
    on its device; one tensor for one array, as lfdtpu's."""
    out = []
    for a in arrays:
        lo, hi = local_batch_slice(len(a), mesh.rank, mesh.size)
        out.append(torch.as_tensor(a[lo:hi]).to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]
