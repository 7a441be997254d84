# The device mesh, the port of `lfdtpu/parallel/mesh.py`.
#
# lfdtpu's Mesh is a grid of devices that one program drives: a `data`
# axis (the batch split over it by GSPMD shardings) and, with
# make_mesh(spatial=k), a `spatial` axis of k devices over which
# spatial_image_sharding splits the image height. In torch one process
# drives one device, so a mesh is this process's place in the process
# group: its coordinates on the two axes, its device and a process group
# for each axis. The GSPMD objects have no counterpart: where lfdtpu puts a
# global array with batch_sharding (dim 0 over `data`) or
# replicated_sharding, each rank takes its own rows (shard_batch,
# local_batch_slice) and keeps whole copies of the parameters
# (DistributedDataParallel keeps them equal); where it puts images with
# spatial_image_sharding, each rank takes its rows of the batch and of the
# height (spatial_image_rows) and the swapped modules of
# parallel/spatial.py exchange the rows their windows need.

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from .distributed import local_batch_slice, rank_device
from .prefetch import prefetch_to_device

__all__ = ["Mesh", "make_mesh", "shard_batch", "spatial_image_rows", "prefetch_to_device"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a (data x spatial) mesh of processes, one device
    each.

    `size`, `rank` and `group` are the DATA axis's: the number of batch
    shards, this rank's shard, and the process group of the ranks that
    hold the other shards at this rank's spatial coordinate (None: a mesh
    of one device without a process group). Every data-parallel call site
    (the train step, sync-BN, the loss normalizers, the Executor) reads
    them, so on a mesh without a spatial axis (spatial 1) they are the
    whole process group, as before the axis existed.

    `spatial`, `spatial_rank` and `spatial_group` are the SPATIAL axis's:
    the ranks that share one batch shard and split its image height,
    this rank's place among them, and their process group (None with
    spatial 1). Global rank r sits at (r // spatial, r % spatial), lfdtpu's
    `reshape(n // spatial, spatial)`."""

    size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None
    spatial: int = 1
    spatial_rank: int = 0
    spatial_group: Optional[Any] = None

    @property
    def world_size(self):
        """Every rank of the mesh: size x spatial."""
        return self.size * self.spatial

    def __deepcopy__(self, memo):
        # a handle on the process groups: a copied net (an engine's) shares it
        return self


def make_mesh(devices=None, spatial=1):
    """The mesh over the initialized process group, one device a rank, or a
    mesh of size 1 without one.

    devices: this rank's device, or a list with one device a rank (this
    rank takes its own), or None: the rank's card (cuda:LOCAL_RANK) in a
    process group, else "cuda" (raises without a card; pass "cpu").
    spatial: the spatial axis's size k, which must divide the world size
    (ValueError otherwise, as lfdtpu's assert): world // k data shards of k
    ranks each. Every rank must call it, with the same k: each axis's
    process groups are made by every rank, in the same order, members or
    not (torch.distributed.new_group)."""
    grouped = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if grouped else (0, 1)
    if spatial < 1 or world % spatial:
        raise ValueError(f"a spatial axis of {spatial} does not divide the world of {world} "
                         "ranks")
    if isinstance(devices, (list, tuple)):
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for a process group of {world} "
                             "ranks: one process drives one device")
        devices = devices[rank]
    if devices is None and grouped:
        devices = rank_device()
    device = resolve_device(devices, "the mesh's device")
    if spatial == 1:
        return Mesh(world, rank, device, dist.group.WORLD if grouped else None)
    shards = world // spatial
    data_groups = [dist.new_group([d * spatial + s for d in range(shards)])
                   for s in range(spatial)]
    spatial_groups = [dist.new_group([d * spatial + s for s in range(spatial)])
                      for d in range(shards)]
    d, s = divmod(rank, spatial)
    return Mesh(shards, d, device, data_groups[s], spatial, s, spatial_groups[d])


def shard_batch(mesh, *arrays):
    """This rank's rows (local_batch_slice) of each global array, as tensors
    on its device; one tensor for one array, as lfdtpu's."""
    out = []
    for a in arrays:
        lo, hi = local_batch_slice(len(a), mesh.rank, mesh.size)
        out.append(torch.as_tensor(a[lo:hi]).to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def spatial_image_rows(mesh, shape):
    """lfdtpu's spatial_image_sharding (batch over `data`, height over
    `spatial`) as this rank's rows of a global (B, H, W, C) batch:
    ((b0, b1), (h0, h1)), its batch rows (local_batch_slice) and the image
    rows it owns (parallel.spatial.owned_rows). A spatial net's first
    module reads a few rows more (its halo): SpatialNet.input_rows."""
    from .spatial import owned_rows

    return (local_batch_slice(shape[0], mesh.rank, mesh.size),
            owned_rows(shape[1], mesh.spatial, mesh.spatial_rank))
