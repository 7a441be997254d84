# LFD-ResNet residual blocks (`lfdtpu/models/blocks.py`, reference
# `lfd/model/backbone/lfd_resnet.py:21-215`), NCHW modules with the
# reference's layer names (`_conv{k}`, `_norm{k}`, `_downsample`).
#
#   FastBlock    : 3x3 -> 1x1 -> 3x3 + residual  (norm+act between, act after add)
#   FasterBlock  : 3x3 -> 3x3 + residual
#   FastestBlock : 3x3 (C/2) -> 3x3 (C) + residual
#
# A stride-2 first block uses a 1x1/stride-2 projection shortcut.

from __future__ import annotations

import torch
from torch import nn

from .layers import activation_from_cfg, norm_from_cfg

_RELU = dict(type="ReLU")


class _Block(nn.Module):
    """Shared plumbing: convs (kernel, stride, out channels) in order, each
    followed by its norm; the activation after every conv but the last and
    after the residual add."""

    def __init__(self, in_channels, convs, features, stride, use_downsample,
                 act_cfg, norm_cfg):
        super().__init__()
        self.stride = stride
        self.features = features
        self.use_downsample = use_downsample
        self.act_cfg = act_cfg or _RELU
        self.norm_cfg = norm_cfg
        self._num_convs = len(convs)
        cin = in_channels
        for k, (ksize, s, cout) in enumerate(convs, start=1):
            setattr(self, f"_conv{k}", nn.Conv2d(cin, cout, ksize, s,
                                                 padding=ksize // 2,
                                                 bias=norm_cfg is None))
            if norm_cfg is not None:
                setattr(self, f"_norm{k}", norm_from_cfg(norm_cfg, cout))
            cin = cout
        self._act = activation_from_cfg(self.act_cfg)
        if use_downsample:
            layers = [nn.Conv2d(in_channels, features, 1, stride,
                                bias=norm_cfg is None)]
            if norm_cfg is not None:
                layers.append(norm_from_cfg(norm_cfg, features))
            self._downsample = nn.Sequential(*layers)

    def _conv_norm(self, k, x):
        x = getattr(self, f"_conv{k}")(x)
        if self.norm_cfg is not None:
            x = getattr(self, f"_norm{k}")(x)
        return x

    def forward(self, x):
        out = x
        for k in range(1, self._num_convs + 1):
            out = self._conv_norm(k, out)
            if k < self._num_convs:
                out = self._act(out)
        identity = self._downsample(x) if self.use_downsample else x
        return self._act(out + identity)


class FastBlock(_Block):
    def __init__(self, in_channels, features, stride=1, use_downsample=False,
                 act_cfg=None, norm_cfg=None):
        super().__init__(in_channels,
                         [(3, stride, features), (1, 1, features), (3, 1, features)],
                         features, stride, use_downsample, act_cfg, norm_cfg)


class FasterBlock(_Block):
    """3x3 -> 3x3 + residual. `fused` is the deploy-time dispatch to K3:
    an engine sets it to a callable (deploy/kernel_net.py) on blocks that
    the kernel can run, and forward then calls it instead of the layers, in
    eval mode on bf16 input only (`lfdtpu/deploy/pallas_net.py:152,278`: K3
    folds the running statistics and takes bf16): a block in train() or fed
    another dtype runs its layers."""

    def __init__(self, in_channels, features, stride=1, use_downsample=False,
                 act_cfg=None, norm_cfg=None):
        super().__init__(in_channels, [(3, stride, features), (3, 1, features)],
                         features, stride, use_downsample, act_cfg, norm_cfg)
        self.fused = None

    def forward(self, x):
        if self.fused is not None and not self.training and x.dtype == torch.bfloat16:
            return self.fused(x)
        return super().forward(x)


class FastestBlock(_Block):
    def __init__(self, in_channels, features, stride=1, use_downsample=False,
                 act_cfg=None, norm_cfg=None):
        super().__init__(in_channels,
                         [(3, stride, features // 2), (3, 1, features)],
                         features, stride, use_downsample, act_cfg, norm_cfg)


BLOCK_TYPES = {
    "fast": FastBlock,
    "faster": FasterBlock,
    "fastest": FastestBlock,
}
