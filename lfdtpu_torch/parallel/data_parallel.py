# The train step on one device (`lfdtpu/parallel/data_parallel.py:25-148`):
#   forward -> on-device target assignment -> loss -> backward -> clip -> SGD
# replacing the reference's host-side OptimizerHook backward/clip/step
# (`lfd/execution/executor.py:185-214`, `hooks/optimizer_hook.py:22-37`).
#
# lfdtpu jits the whole step as a pure function of its state; here the state
# is the net and its torch optimizer, updated in place, and the step runs
# eagerly with no host sync: no .item(), no Python branch on a device value
# (num_pos, the clip gate). The metrics come back as 0-d device tensors.
#
# Not ported yet: `mesh` (data parallel over several devices) and `remat`
# (under torch.utils.checkpoint the recomputed forward would update the BN
# running stats a second time).
#
# make_eval_step is the val loop's forward (`data_parallel.py:151-172`).

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from ..execution.optim import clip_by_global_norm, global_norm, set_lr
from ..models.detector import eval_forward


@dataclasses.dataclass
class TrainState:
    """The net (float32 master weights, BN running stats) and its torch
    optimizer (momentum buffers), both updated in place by the step."""

    net: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(detector, optimizer, generator=None, device=None):
    """Initialize detector.net from `generator` (if given) with lfdtpu's
    initializers, put it on `device` (the card unless the caller asks for
    another, e.g. device="cpu"; without a CUDA device an omitted device
    raises) in channels_last memory format (the NHWC input then reaches cuDNN
    without a copy) and in train mode, and build `optimizer` (an optim.SGD /
    GroupedSGD config) over it."""
    device = resolve_device(device)
    if generator is not None:
        detector.init(generator)
    net = detector.net.to(device=device, memory_format=torch.channels_last).train()
    return TrainState(net, optimizer.build(net))


def make_train_step(detector, optimizer, input_hw, clip_max_norm=0.0,
                    preprocess=None, mixed_precision=False):
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
    """
    input_hw = (int(input_hw[0]), int(input_hw[1]))
    net = detector.net
    device = next(net.parameters()).device
    params = list(net.parameters())  # each shared-head parameter once
    level_arrays = detector.level_arrays(input_hw, device)
    if preprocess is not None:
        preprocess = copy.deepcopy(preprocess).to(device)

    def to_device(x):
        if isinstance(x, dict):  # the device-aug images {buffer, scale, ...}
            return {k: to_device(v) for k, v in x.items()}
        return torch.as_tensor(x).to(device, non_blocking=True)

    def step(images, gt_bboxes, gt_labels, gt_mask, lr, clip_enabled):
        images = to_device(images)
        if preprocess is not None:
            images = preprocess(images)
        net.train()
        optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=mixed_precision):
            outs = net(images.to(params[0].dtype))
        if mixed_precision:
            outs = tuple(o.float() for o in outs)
        ld = detector.get_loss(outs, to_device(gt_bboxes),
                               to_device(gt_labels), to_device(gt_mask), input_hw,
                               level_arrays=level_arrays)
        ld["loss"].backward()
        # a frozen stage's parameters get no gradient; lfdtpu's
        # stop_gradient gives them zeros, which weight decay then acts on
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
    mesh / spatial (lfdtpu: the batch or the image height sharded over
    several devices) are not ported (ROADMAP queue 1, item 8)."""
    if mesh is not None or spatial:
        raise NotImplementedError("evaluating over several devices (mesh, spatial) is "
                                  "not ported yet (ROADMAP queue 1, item 8)")

    def step(state, images):
        return eval_forward(state.net, images)

    return step
