"""Plain reference of the LFD train step: float32, TF32 off.

forward (BatchNorm on the batch's moments) -> targets (lfd.assign, image by
image) -> lfd.loss -> autograd backward -> clip by the global norm ->
torch-semantics SGD (coupled weight decay, momentum buffer = gradient at the
first step), learning rate from the workload's warmup and multistep
schedule. It imports nothing of the program under test.
"""

from __future__ import annotations

import torch

from . import lfd


def learning_rate(opt, it, epoch=0):
    """The schedule's lr at 0-based iteration `it`: linear warmup over
    warmup_iters from base * warmup_ratio, then base * gamma ** (number of
    milestones <= epoch)."""
    base, n, ratio = opt["lr"], opt["warmup_iters"], opt["warmup_ratio"]
    if it + 1 <= n:
        return base * (1.0 - (1.0 - (it + 1) / n) * (1.0 - ratio))
    return base * opt["gamma"] ** sum(1 for m in opt["milestones"] if m <= epoch)


def trainable(specs):
    """The names of the weights SGD updates (not BatchNorm's statistics)."""
    return [n for n, _, kind in specs if kind not in ("running_mean", "running_var", "count")]


def grads_and_loss(w, cfg, batch, quant=None, bf16=False):
    """One forward and backward over `batch` (frames, gt_xywh, labels, mask)
    from weights `w` (a dict; trainable leaves require grad); bf16: the
    forward under bfloat16 autocast (the loss in float32). Returns
    (loss, {name: gradient}, the number of positive points)."""
    frames, gt, labels, mask = batch
    names = trainable(lfd.param_specs(cfg))
    leaves = {n: w[n].detach().clone().requires_grad_(True) for n in names}
    full = dict(w, **leaves)
    with torch.autocast(frames.device.type, dtype=torch.bfloat16, enabled=bf16):
        cls_o, reg_o = lfd.forward(full, cfg, frames, train=True, quant=quant)
    info = lfd.level_info(cfg, frames.shape[1:3], frames.device)
    targets = [lfd.assign(info, gt[i], labels[i], mask[i].bool(), cfg)
               for i in range(frames.shape[0])]
    cls_t = torch.stack([t[0] for t in targets])
    reg_t = torch.stack([t[1] for t in targets])
    total, _, _, num_pos = lfd.loss(cls_o, reg_o, cls_t, reg_t, info, cfg)
    grads = torch.autograd.grad(total, [leaves[n] for n in names])
    return total.detach(), dict(zip(names, grads)), float(num_pos)


def steps(w0, cfg, batches, quant=None, bf16=False):
    """SGD steps from weights `w0` over `batches`, as the program's step
    (clip, then SGD). Returns (losses, the first step's clipped gradient
    {name: tensor}, the weights after the steps {name: tensor}, each step's
    number of positive points)."""
    opt = cfg["train"]["optimizer"]
    clip = cfg["train"]["clip_max_norm"]
    w = {k: v.clone() for k, v in w0.items()}
    bufs, losses, positives, first = {}, [], [], None
    for it, batch in enumerate(batches):
        value, grads, num_pos = grads_and_loss(w, cfg, batch, quant, bf16)
        positives.append(num_pos)
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = clip / (norm + 1e-6) if clip > 0 and norm > clip else torch.ones(())
        grads = {k: g * scale for k, g in grads.items()}
        if first is None:
            first = grads
        lr = learning_rate(opt, it)
        with torch.no_grad():
            for k, g in grads.items():
                d = g + opt["weight_decay"] * w[k]
                bufs[k] = d.clone() if k not in bufs else bufs[k] * opt["momentum"] + d
                w[k] = w[k] - lr * bufs[k]
        losses.append(float(value))
    return losses, first, w, positives
