# Optimizers for the train step (`lfdtpu/execution/optim.py`).
#
# lfdtpu's SGD copies torch.optim.SGD's semantics (coupled weight decay,
# buf = momentum * buf + g, update = -lr * buf), so the port uses
# torch.optim.SGD itself. The configs here are frozen dataclasses, as in
# lfdtpu; `build(net)` makes the torch optimizer over the net's parameters
# (each shared-head parameter once: net.parameters() deduplicates). The
# learning rate comes from the schedule every step (`set_lr`); a param group
# may carry an "lr_scale" that keeps its lr proportional (the bias group).
#
# OptaxOptimizer (any optax transformation) has no port: it is optax's API.

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class SGD:
    """torch-semantics SGD with a runtime learning rate."""

    learning_rate: float = 0.1  # base lr; the step's lr is set per step
    momentum: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False

    def build(self, net):
        return torch.optim.SGD(list(net.parameters()), lr=self.learning_rate,
                               momentum=self.momentum, weight_decay=self.weight_decay,
                               nesterov=self.nesterov)


def bias_param_labels(net):
    """{state_dict name: "bias" or "other"}: the reference's param-group
    split (`lfd/model/fcos.py:53-80`, lfdtpu's `bias_param_labels`). Every
    conv bias is "bias"; norm affines, Scales, other weights and buffers are
    "other"."""
    conv_bias = {id(m.bias) for m in net.modules()
                 if isinstance(m, nn.Conv2d) and m.bias is not None}
    return {name: "bias" if id(t) in conv_bias else "other"
            for name, t in net.state_dict(keep_vars=True).items()}


def bias_parameters(net):
    """The "bias" group of bias_param_labels, each shared parameter once, in
    the net's order."""
    state = net.state_dict(keep_vars=True)
    group = {}
    for name, label in bias_param_labels(net).items():
        if label == "bias":
            group.setdefault(id(state[name]), state[name])
    return list(group.values())


@dataclasses.dataclass(frozen=True)
class GroupedSGD:
    """SGD with a separate lr / weight decay for the bias group (reference
    `param_groups_cfg` with bias_lr / bias_weight_decay). The runtime lr
    scales both groups proportionally: lr_bias = lr * bias_lr /
    learning_rate, preserving the schedule's shape."""

    learning_rate: float = 0.1
    momentum: float = 0.0
    weight_decay: float = 0.0
    bias_lr: float = None
    bias_weight_decay: float = None

    def build(self, net):
        bias = bias_parameters(net)
        bias_ids = {id(p) for p in bias}
        main = [p for p in net.parameters() if id(p) not in bias_ids]
        scale = (self.bias_lr / self.learning_rate
                 if self.bias_lr is not None and self.learning_rate else 1.0)
        bias_wd = (self.bias_weight_decay if self.bias_weight_decay is not None
                   else self.weight_decay)
        return torch.optim.SGD(
            [dict(params=main),
             dict(params=bias, lr=self.learning_rate * scale, weight_decay=bias_wd,
                  lr_scale=scale)],
            lr=self.learning_rate, momentum=self.momentum,
            weight_decay=self.weight_decay)


def set_lr(optimizer, lr):
    """The schedule's lr into every param group, times its lr_scale."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)


def global_norm(grads):
    """sqrt of the sum of squares of every gradient, as a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


def clip_by_global_norm(grads, max_norm, enabled):
    """torch clip_grad_norm_ semantics, gated by `enabled` (a bool or a bool
    tensor: the reference clips only during the first `duration` epochs,
    `optimizer_hook.py:29-37`), with lfdtpu's formula: scale by
    max_norm / (gnorm + 1e-6) when gnorm > max_norm and enabled. Scales the
    gradients in place, with no host sync; returns the unclipped norm."""
    gnorm = global_norm(grads)
    scale = torch.where((gnorm > max_norm) & enabled, max_norm / (gnorm + 1e-6),
                        torch.ones_like(gnorm))
    torch._foreach_mul_(grads, scale)
    return gnorm
