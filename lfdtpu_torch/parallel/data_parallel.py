# The train step (`lfdtpu/parallel/data_parallel.py:25-148`):
#   forward -> on-device target assignment -> loss -> backward -> clip -> SGD
# replacing the reference's host-side OptimizerHook backward/clip/step
# (`lfd/execution/executor.py:185-214`, `hooks/optimizer_hook.py:22-37`).
#
# lfdtpu jits the whole step as a pure function of its state; here the state
# is the net and its torch optimizer, updated in place, and the step runs
# eagerly with no host sync: no .item(), no Python branch on a device value
# (num_pos, the clip gate). The metrics come back as 0-d device tensors.
#
# remat (`data_parallel.py:85-93`, jax.checkpoint of the whole forward) runs
# the net under torch.utils.checkpoint. Its recomputation in backward runs
# the net in train mode again, which would update every BatchNorm's running
# statistics a second time (lfdtpu's functional batch_stats never are): the
# recomputation restores them as it found them.
#
# Over a data mesh (parallel.mesh: one process per device) the step computes
# what lfdtpu's one program computes on the global batch, each rank on its
# rows: global-batch synchronous SGD with sync-BN (`data_parallel.py:7-10`).
#   - every port BatchNorm2d normalizes by the global batch's moments
#     (sync_batchnorm; layers.BatchNorm2d._synced_forward);
#   - get_loss(mesh=) divides by global normalizers, so the ranks' losses
#     sum to lfdtpu's loss of the global batch;
#   - the net runs under DistributedDataParallel, whose backward averages
#     the ranks' gradients: each rank scales its loss by the world size
#     first, so that the average is the gradient of the global loss.
# DDP's bucket all-reduces and sync-BN's backward all-reduces share the
# mesh's process group; under remat the recomputation all-reduces the BN
# moments again inside the backward. Every rank runs one graph and starts
# these collectives in the same order, which is all a collective needs.
# The clip then sees the global gradient, and the optimizer keeps the ranks'
# parameters equal; the BN buffers stay equal by construction
# (broadcast_buffers=False).
#
# Under a profiler session a step records the span `train.step` and, inside
# it, `train.input`, `train.forward`, `train.loss` (the detector's
# `train.assign` inside it), `train.backward` and `train.update`, each but
# the first timed on the device's stream too (tracing.py).
#
# make_eval_step is the val loop's forward (`data_parallel.py:151-172`);
# with spatial=True on a mesh with a spatial axis it runs the net with the
# image height split over that axis (parallel/spatial.py), as lfdtpu's step
# does with spatial_image_sharding.

from __future__ import annotations

import contextlib
import copy
import dataclasses

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..device import resolve_device
from ..execution.optim import clip_by_global_norm, global_norm, set_lr
from ..models.detector import eval_forward
from ..models.layers import BatchNorm2d
from .distributed import global_batch_from_local, local_batch_slice
from .spatial import spatial_parallel


@dataclasses.dataclass
class TrainState:
    """The net (float32 master weights, BN running stats) and its torch
    optimizer (momentum buffers), both updated in place by the step."""

    net: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(detector, optimizer, generator=None, device=None, mesh=None):
    """Initialize detector.net from `generator` (if given) with lfdtpu's
    initializers, put it on `device` (the card unless the caller asks for
    another, e.g. device="cpu"; without a CUDA device an omitted device
    raises), or on the rank's device of a `mesh`, in channels_last memory
    format (the NHWC input then reaches cuDNN without a copy) and in train
    mode, and build `optimizer` (an optim.SGD / GroupedSGD config) over it.
    Over a mesh of several ranks every rank starts from rank 0's parameters
    and buffers."""
    device = mesh.device if mesh is not None else resolve_device(device)
    if generator is not None:
        detector.init(generator)
    net = detector.net.to(device=device, memory_format=torch.channels_last).train()
    if _grouped(mesh):
        with torch.no_grad():
            for t in list(net.parameters()) + list(net.buffers()):
                dist.broadcast(t, 0, group=mesh.group)
    return TrainState(net, optimizer.build(net))


def _grouped(mesh):
    return mesh is not None and mesh.group is not None


def sync_batchnorm(net, mesh):
    """Attach `mesh` to every port BatchNorm2d of `net`: in training their
    moments become the global batch's (sync-BN). The state_dict and its
    names are unchanged. Returns net."""
    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = mesh
    return net


@contextlib.contextmanager
def _buffers_kept(buffers):
    """Restore `buffers` on exit to their values on entry."""
    saved = [b.clone() for b in buffers]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(buffers, saved):
                b.copy_(v)


class _Rematerialized(nn.Module):
    """net's forward under torch.utils.checkpoint (non-reentrant): its
    activations are recomputed in backward instead of kept, and the
    recomputation leaves the BatchNorm running statistics (running_mean,
    running_var, num_batches_tracked) as the first forward wrote them. A
    module, so that DistributedDataParallel can wrap it: DDP's forward then
    runs once and only the net is recomputed."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self._stats = [b for m in net.modules() if isinstance(m, nn.BatchNorm2d)
                       for b in m.buffers()]

    def _contexts(self):
        return contextlib.nullcontext(), _buffers_kept(self._stats)

    def forward(self, x):
        return checkpoint(self.net, x, use_reentrant=False, context_fn=self._contexts)


def _distributed(module, mesh):
    """module (the net, or it rematerialized) under DistributedDataParallel
    on the mesh's group. find_unused_parameters only for a backbone with
    frozen stages, whose parameters take no part in the backward."""
    device = next(module.parameters()).device
    net = getattr(module, "net", module)
    frozen = getattr(net._backbone, "frozen_stages", -1) >= 0
    return DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None,
        process_group=mesh.group, broadcast_buffers=False, find_unused_parameters=frozen)


def make_train_step(detector, optimizer, input_hw, clip_max_norm=0.0,
                    preprocess=None, mixed_precision=False, remat=False, mesh=None):
    """Build the train step of `detector.net` with `optimizer` (the torch
    optimizer of its TrainState).

    Returns step(images, gt_bboxes, gt_labels, gt_mask, lr, clip_enabled)
    -> metrics: {loss, classification_loss, regression_loss, num_pos,
    grad_norm}, 0-d tensors on the net's device (grad_norm before clipping).

    images: (B, H, W, 3) at input_hw, float, or uint8 with `preprocess`
      (e.g. deploy.make_device_preprocess: the host ships raw uint8 batches),
      or with preprocess=data.DeviceAugment the dict {buffer, scale,
      translation, flip} of a DeviceAugRegionSampler's batch (lfdtpu's
      contract, `lfdtpu/execution/executor.py:183-190`);
    gt_bboxes (B, Nmax, 4) xywh, gt_labels (B, Nmax), gt_mask (B, Nmax);
    lr: the schedule's float for this step; clip_enabled: bool (or a bool
      tensor on the device), used only when clip_max_norm > 0.
    mixed_precision: forward and backward under bf16 autocast; master
      weights, BN running stats, assignment, loss and optimizer stay fp32.
    remat: the net's whole forward as one checkpointed segment
      (torch.utils.checkpoint, as lfdtpu's jax.checkpoint): its activations
      are not kept from the forward to the backward, which recomputes them.
      The step's results equal the plain step's, BN running stats included.
    mesh: a parallel.Mesh in a process group (this rank's images and GT are
      its rows of the global batch, data.ShardedDatasetSampler's): sync-BN,
      global loss normalizers and DDP, as the header says; the metrics are
      the global batch's. The net must sit on the mesh's device
      (create_train_state(mesh=)).
    """
    input_hw = (int(input_hw[0]), int(input_hw[1]))
    net = detector.net
    device = next(net.parameters()).device
    params = list(net.parameters())  # each shared-head parameter once
    level_arrays = detector.level_arrays(input_hw, device)
    forward = _Rematerialized(net) if remat else net
    if _grouped(mesh):
        sync_batchnorm(net, mesh)
        forward = _distributed(forward, mesh)
        loss_scale = mesh.size
    else:
        mesh, loss_scale = None, 1
    if preprocess is not None:
        preprocess = copy.deepcopy(preprocess).to(device)

    def to_device(x):
        if isinstance(x, dict):  # the device-aug images {buffer, scale, ...}
            return {k: to_device(v) for k, v in x.items()}
        return torch.as_tensor(x).to(device, non_blocking=True)

    def step(images, gt_bboxes, gt_labels, gt_mask, lr, clip_enabled):
        with tracing.span("train.step"):
            with tracing.span("train.input"):
                images = to_device(images)
                if preprocess is not None:
                    images = preprocess(images)
                gt = to_device(gt_bboxes), to_device(gt_labels), to_device(gt_mask)
                net.train()
                optimizer.zero_grad(set_to_none=True)
            with tracing.span("train.forward", device):
                with torch.autocast(device.type, dtype=torch.bfloat16,
                                    enabled=mixed_precision):
                    outs = forward(images.to(params[0].dtype))
                if mixed_precision:
                    outs = tuple(o.float() for o in outs)
            with tracing.span("train.loss", device):
                ld = detector.get_loss(outs, *gt, input_hw, level_arrays=level_arrays,
                                       mesh=mesh)
            with tracing.span("train.backward", device):
                # DDP averages the ranks' gradients: the world size turns the
                # mean into the gradient of the global loss, the ranks' sum
                (ld["loss"] * loss_scale).backward()
            with tracing.span("train.update", device):
                # a frozen stage's parameters get no gradient; lfdtpu's
                # stop_gradient gives them zeros, which weight decay acts on
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                grads = [p.grad for p in params]
                if clip_max_norm > 0:
                    grad_norm = clip_by_global_norm(grads, clip_max_norm, clip_enabled)
                else:
                    grad_norm = global_norm(grads)
                set_lr(optimizer, lr)
                optimizer.step()
                metrics = {k: v.detach() for k, v in ld["loss_values"].items()}
                metrics["grad_norm"] = grad_norm.detach()
            return metrics

    return step


def make_eval_step(detector, mesh=None, spatial=False):
    """The val loop's batched forward: step(state, images) -> dense outputs
    (cls (B, P, Cc), reg (B, P, 4)) of state.net in eval mode under
    inference_mode, on the state's device; the per-image decode happens
    downstream (LFD.results_from_outputs). The BN running statistics are not
    touched and the net is left in the mode it was found in.

    images: (B, H, W, 3) array or tensor, already normalized.
    mesh: this rank's images are its rows of the global batch (shard_batch),
      and the step returns the global (B, P, C) / (B, P, 4), gathered in
      rank order on every rank: lfdtpu's data-sharded eval step.
    spatial: on a mesh with a spatial axis (make_mesh(spatial=k)), every
      rank is handed the GLOBAL batch (as lfdtpu's caller hands it to its
      sharding) and uploads only its batch rows (the data axis) and its
      rows of the height with its first conv's halo (SpatialNet.input_rows);
      the net runs on strips (parallel.spatial_parallel, a copy that shares
      the net's weights, made once per net), and the step returns the
      global (B, P, C) / (B, P, 4) on every rank. On a mesh without one it
      is the step above."""
    if spatial and mesh is not None and mesh.spatial > 1:
        return _spatial_eval_step(mesh)

    def step(state, images):
        outs = eval_forward(state.net, images)
        return global_batch_from_local(mesh, outs) if _grouped(mesh) else outs

    return step


def _spatial_eval_step(mesh):
    made = {}  # the state's net -> its spatial copy (the net kept alive: ids stay unique)

    def step(state, images):
        net = state.net
        if id(net) not in made:
            made.clear()
            made[id(net)] = (net, spatial_parallel(net, mesh))
        spatial = made[id(net)][1].eval()
        p = next(net.parameters())
        b0, b1 = local_batch_slice(len(images), mesh.rank, mesh.size)
        shape = (b1 - b0,) + tuple(images.shape[1:])
        r0, r1 = spatial.input_rows(shape, p.dtype, p.device)
        with torch.inference_mode():
            x = torch.as_tensor(images[b0:b1, r0:r1]).to(p.device, non_blocking=True)
            outs = spatial(x.to(p.dtype), shape[1])
        return global_batch_from_local(mesh, outs)

    return step
