# Process-group helpers, the port of `lfdtpu/parallel/distributed.py`.
#
# lfdtpu runs one JAX program over every device of every host
# (jax.distributed.initialize once per host); the port runs one process per
# device (torchrun) in one torch.distributed process group, and a step
# makes what lfdtpu's single program makes on the global batch by summing
# across the ranks where lfdtpu's GSPMD sums across devices:
#   - global_sum: a detached all-reduce SUM, for the loss normalizers (the
#     global num_pos and its kin, and the reported loss values);
#   - all_reduce_sum: the same sum as an autograd function whose backward
#     all-reduces the incoming gradient, for the sync-BN moments;
#   - global_batch_from_local: the ranks' rows gathered along dim 0.
#
# The backend is the caller's or, by default, nccl where CUDA is available
# and gloo elsewhere; a backend that fails to initialize raises (nothing
# falls back to another). Gloo takes CUDA tensors too (all_reduce,
# broadcast and all_gather, as the port uses them); two ranks on one card
# need it, since NCCL refuses them.

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "process_info", "local_batch_slice",
           "global_batch_from_local", "global_sum", "global_sums", "all_reduce_sum",
           "rank_device"]


def _world():
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device():
    """This process's device: cuda:LOCAL_RANK (rank modulo the visible
    cards when torchrun did not set LOCAL_RANK) where CUDA is available,
    else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else _world()[0] % torch.cuda.device_count()
    return torch.device("cuda", index)


def initialize_distributed(backend=None, init_method=None, world_size=None, rank=None):
    """Join the process group (torch.distributed.init_process_group); a
    no-op at world size 1, as lfdtpu's is, and when the group exists.

    world_size / rank default to torchrun's WORLD_SIZE / RANK and
    init_method to "env://" (MASTER_ADDR / MASTER_PORT); backend to "nccl"
    where CUDA is available, else "gloo". On CUDA the rank's card
    (rank_device) becomes the current device first. A backend that fails to
    initialize raises."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if world_size <= 1 or dist.is_initialized():
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        index = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(index) if index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def process_info():
    """rank, world size, the visible cards and this rank's device."""
    rank, world = _world()
    return dict(process_index=rank, process_count=world,
                local_device_count=torch.cuda.device_count(), device=rank_device())


def local_batch_slice(global_batch_size, process_index=None, process_count=None):
    """The [start, stop) rows of the global batch this rank feeds
    (`lfdtpu/parallel/distributed.py:45-62`); the defaults come from the
    process group ((0, 1) without one). data.ShardedDatasetSampler yields
    exactly these rows of each global batch."""
    rank, world = _world()
    if process_count is None:
        process_count = world
    if process_index is None:
        process_index = rank
    assert global_batch_size % process_count == 0, (
        f"global batch {global_batch_size} not divisible by {process_count} hosts"
    )
    per = global_batch_size // process_count
    start = process_index * per
    return start, start + per


def global_batch_from_local(mesh, local_arrays):
    """The ranks' rows (arrays or tensors, equal shapes) gathered along dim
    0 in rank order, on this rank's device: the global tensors. Returns one
    tensor for one array, as lfdtpu's does."""
    out = []
    for a in local_arrays:
        t = torch.as_tensor(a).to(mesh.device).contiguous()
        if _synced(mesh):
            # a 16-bit float travels as its bytes (whatever 16-bit types
            # the backend takes)
            half = t.dtype in (torch.float16, torch.bfloat16)
            wire = t.reshape(-1).view(torch.uint8) if half else t
            parts = [torch.empty_like(wire) for _ in range(mesh.size)]
            dist.all_gather(parts, wire, group=mesh.group)
            whole = torch.cat(parts)
            t = whole.view(t.dtype).reshape((-1,) + tuple(t.shape[1:])) if half else whole
        out.append(t)
    return tuple(out) if len(out) > 1 else out[0]


def _synced(mesh):
    return mesh is not None and mesh.group is not None and mesh.size > 1


def global_sum(t, mesh):
    """t summed over the mesh's ranks, detached (t itself without a mesh of
    several ranks): the loss normalizers and reported values."""
    if not _synced(mesh):
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=mesh.group)
    return t


def global_sums(values, mesh):
    """A dict of 0-d tensors summed over the mesh's ranks, detached, in one
    all-reduce (the dict itself without a mesh of several ranks)."""
    if not _synced(mesh):
        return values
    return dict(zip(values, global_sum(torch.stack(list(values.values())), mesh)))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        # d(sum_r t_r)/d t_r is 1 for every rank: each rank's gradient is
        # the sum of every rank's incoming gradient
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t, mesh):
    """t summed over the mesh's ranks, differentiably: the backward
    all-reduces the incoming gradient (every rank's result feeds every
    rank's loss). Identity without a mesh of several ranks."""
    if not _synced(mesh):
        return t
    return _AllReduceSum.apply(t, mesh.group)
