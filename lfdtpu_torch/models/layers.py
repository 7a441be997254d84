# Shared building blocks (`lfdtpu/models/layers.py`), as PyTorch modules.
#
# A "ConvNormAct" is a flat run of layers [conv, norm?, act?] rather than a
# module of its own, because the upstream reference's state_dict names the
# layers by their index in the enclosing Sequential (`_backbone._stem.{i}`,
# `_neck.neck{i}.{j}`, `_head.head{k}_merge_path.{j}`), and the weight bridge
# (`lfdtpu/execution/torch_convert.py`) reads exactly those names.

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# torch BatchNorm2d defaults, as in the reference: momentum 0.1, eps 1e-5
BN_EPS = 1e-5
GN_EPS = 1e-5


def activation_from_cfg(cfg):
    """Activation module from a reference-style cfg dict (None: identity)."""
    if cfg is None:
        return nn.Identity()
    t = cfg["type"]
    table = {
        "ReLU": lambda: nn.ReLU(),
        "ReLU6": lambda: nn.ReLU6(),
        "LeakyReLU": lambda: nn.LeakyReLU(cfg.get("negative_slope", 0.01)),
        "SiLU": lambda: nn.SiLU(),
        # jax.nn.gelu defaults to the tanh approximation
        "GELU": lambda: nn.GELU(approximate="tanh"),
        "Sigmoid": lambda: nn.Sigmoid(),
        "Tanh": lambda: nn.Tanh(),
    }
    if t not in table:
        raise ValueError(f"unsupported activation type: {t}")
    return table[t]()


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training step folds the *biased* batch variance
    into running_var, as flax's nn.BatchNorm (lfdtpu) does; torch's own
    uses the unbiased one, n/(n-1) larger (n = B*H*W per channel: 2 at a
    1x1 level with batch 2). Normalization, eps, momentum and state_dict
    names are nn.BatchNorm2d's.

    The fix is O(C) after torch's update, not a second pass over the
    activation: with torch's rv' = (1-m) rv + m u and u = v n/(n-1),
    the wanted (1-m) rv + m v equals rv' (1 - 1/n) + (1-m) rv / n. torch
    writes rv' into a copy: the op saves its running_var for backward, so
    the buffer itself must not change in place after it.

    Sync-BN: with a data mesh of several ranks attached (`mesh`, set by
    parallel.sync_batchnorm; not part of the state_dict), a training
    forward normalizes by the moments of the global batch, as lfdtpu's one
    program over the whole batch does (`lfdtpu/parallel/data_parallel.py:
    7-10`): see _synced_forward. Without one (and in eval mode, as FCOS's
    norm_eval stages run) the layer is the one-device layer above."""

    mesh = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.mesh is not None and self.mesh.size > 1:
            return self._synced_forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        updated = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, updated, self.weight, self.bias,
                           True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(updated,
                                                                   alpha=1.0 - 1.0 / n)
        return out

    def _synced_forward(self, x):
        """Each rank's per-channel sums of d = x - running_mean and of d^2
        and its element count go through one all-reduce
        (parallel.distributed.all_reduce_sum, whose backward all-reduces
        the gradient); mean = running_mean + S1/n and the biased var =
        S2/n - (S1/n)^2, clamped at 0: flax's E[x^2] - E[x]^2 (ROADMAP F8)
        about a shift that every rank holds, which keeps the two terms
        from cancelling where a channel's mean dwarfs its spread. float32
        (float64 for a float64 input). running_var takes the biased var of
        the n global elements (F5)."""
        from ..parallel.distributed import all_reduce_sum

        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
        shift = self.running_mean.detach().to(dtype).clone()
        c = x.shape[1]
        d = x.to(dtype) - shift[None, :, None, None]
        moments = all_reduce_sum(torch.cat([
            d.sum((0, 2, 3)), (d * d).sum((0, 2, 3)), d.new_full((1,), d.numel() // c)]),
            self.mesh)
        centred = moments[:c] / moments[-1]
        mean = shift + centred
        var = (moments[c:2 * c] / moments[-1] - centred * centred).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
        scale = torch.rsqrt(var + self.eps)
        if self.affine:
            scale = scale * self.weight
        y = (d - centred[None, :, None, None]) * scale[None, :, None, None]
        if self.affine:
            y = y + self.bias[None, :, None, None]
        return y.to(x.dtype)


def norm_from_cfg(cfg, channels):
    """Norm layer: {'type': 'BatchNorm2d'} or {'type': 'GroupNorm',
    'num_groups': G}."""
    t = cfg["type"]
    if t == "BatchNorm2d":
        return BatchNorm2d(channels, eps=BN_EPS, momentum=0.1)
    if t == "GroupNorm":
        return nn.GroupNorm(cfg["num_groups"], channels, eps=GN_EPS)
    raise ValueError(f"unsupported norm type: {t}")


def conv_norm_act(in_channels, features, kernel_size=3, stride=1,
                  norm_cfg=None, act_cfg=None):
    """[conv, norm?, act?] with torch padding k//2; the conv has a bias iff
    there is no norm, as every conv in the reference."""
    layers = [nn.Conv2d(in_channels, features, kernel_size, stride,
                        padding=kernel_size // 2, bias=norm_cfg is None)]
    if norm_cfg is not None:
        layers.append(norm_from_cfg(norm_cfg, features))
    if act_cfg is not None:
        layers.append(activation_from_cfg(act_cfg))
    return layers


class Scale(nn.Module):
    """Learnable scalar multiplier (`lfd/model/head/lfd_head.py:9-16`)."""

    def __init__(self, init_value=1.0):
        super().__init__()
        self._scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self._scale


def kaiming_out_(weight, generator):
    """variance_scaling(2.0, 'fan_out', 'normal'), the lfdtpu conv init."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def xavier_uniform_(weight, generator):
    """flax's xavier_uniform (variance_scaling(1.0, 'fan_avg', 'uniform')),
    the lfdtpu FPN conv init."""
    receptive = weight.shape[2] * weight.shape[3]
    fan_in, fan_out = weight.shape[1] * receptive, weight.shape[0] * receptive
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)
