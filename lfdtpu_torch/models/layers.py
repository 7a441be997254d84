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


def norm_from_cfg(cfg, channels):
    """Norm layer: {'type': 'BatchNorm2d'} or {'type': 'GroupNorm',
    'num_groups': G}."""
    t = cfg["type"]
    if t == "BatchNorm2d":
        return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.1)
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
