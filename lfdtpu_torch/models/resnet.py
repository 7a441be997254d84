# mmdet-style ResNet backbone (`lfdtpu/models/resnet.py`, reference
# `lfd/model/backbone/resnet.py`): depths 18/34/50/101/152, pytorch/caffe
# stride styles, deep_stem, per-(stage, block) output taps, frozen stages
# and norm_eval, with lfdtpu's semantics:
#   - stages are numbered from 1 and blocks from 0 in out_indices, and stages
#     past the deepest tap are not built;
#   - norm_eval (the default) runs every norm of the backbone in eval mode,
#     even in train();
#   - frozen_stages >= 0 freezes the stem (LFDResNet's rule is > 0) and stage
#     s is frozen when s <= frozen_stages: their norms run in eval mode and
#     their outputs are detach()ed where lfdtpu applies stop_gradient. Frozen
#     parameters still reach the optimizer and get zero gradients
#     (parallel/data_parallel.py), so weight decay moves them, as in lfdtpu.
#
# Module names are torchvision's (`conv1`/`bn1`, or `stem.{i}` for the deep
# stem, then `layer{s}.{j}.conv{k}/bn{k}/downsample.{0,1}`), so an ImageNet
# state_dict of torchvision or mmdet loads into it
# (execution/torch_convert.py::convert_torchvision_resnet).

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import conv_norm_act, norm_from_cfg

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

_RELU = dict(type="ReLU")


def _norm_cfg_std(norm_cfg):
    """The reference's {'type': 'BN'} / {'type': 'GN'} (`resnet.py:272`) as
    the port's norm cfg."""
    t = norm_cfg.get("type", "BN")
    if t in ("BN", "BatchNorm2d"):
        return dict(type="BatchNorm2d")
    if t in ("GN", "GroupNorm"):
        return dict(type="GroupNorm", num_groups=norm_cfg["num_groups"])
    raise ValueError(t)


class _Block(nn.Module):
    """convs [(kernel, stride, out channels)], each followed by its norm
    (`conv{k}`, `bn{k}`), ReLU between them and after the residual add; a
    1x1 projection shortcut `downsample` when asked."""

    def __init__(self, in_channels, convs, stride, norm_cfg, use_downsample):
        super().__init__()
        self.num_convs = len(convs)
        cin = in_channels
        for k, (ksize, s, cout) in enumerate(convs, start=1):
            setattr(self, f"conv{k}", nn.Conv2d(cin, cout, ksize, s, padding=ksize // 2,
                                                bias=False))
            setattr(self, f"bn{k}", norm_from_cfg(norm_cfg, cout))
            cin = cout
        self.downsample = (nn.Sequential(*conv_norm_act(in_channels, cin, 1, stride, norm_cfg))
                           if use_downsample else None)

    def forward(self, x):
        out = x
        for k in range(1, self.num_convs + 1):
            out = getattr(self, f"bn{k}")(getattr(self, f"conv{k}")(out))
            if k < self.num_convs:
                out = F.relu(out)
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_channels, planes, stride=1, norm_cfg=None, use_downsample=False):
        super().__init__(in_channels, [(3, stride, planes), (3, 1, planes)], stride,
                         norm_cfg, use_downsample)


class Bottleneck(_Block):
    """pytorch style: the stride on the 3x3; caffe: on the first 1x1
    (`lfdtpu/models/resnet.py:66`)."""

    expansion = 4

    def __init__(self, in_channels, planes, stride=1, norm_cfg=None, use_downsample=False,
                 style="pytorch"):
        s1, s2 = (1, stride) if style == "pytorch" else (stride, 1)
        super().__init__(in_channels,
                         [(1, s1, planes), (3, s2, planes), (1, 1, planes * self.expansion)],
                         stride, norm_cfg, use_downsample)


def resnet_output_info(depth, base_channels=64, out_indices=((1, 1), (2, 1), (3, 1), (4, 1))):
    """(channels_list, strides_list) of the tapped outputs
    (`resnet.py:328-335`)."""
    kind, _ = ARCH_SETTINGS[depth]
    expansion = 1 if kind == "basic" else 4
    out_indices = sorted(out_indices)
    channels = [base_channels * (2 ** (st - 1)) * expansion for st, _ in out_indices]
    strides = [2 ** (st + 1) for st, _ in out_indices]
    return channels, strides


class ResNet(nn.Module):
    """forward(x NCHW) returns the tuple of feature maps at out_indices."""

    def __init__(self, depth=50, in_channels=3, base_channels=64, strides=(1, 2, 2, 2),
                 out_indices=((1, 1), (2, 1), (3, 1), (4, 1)), style="pytorch",
                 deep_stem=False, frozen_stages=-1, norm_cfg=None, norm_eval=True):
        super().__init__()
        ncfg = _norm_cfg_std(norm_cfg or dict(type="BN"))
        kind, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        block_kw = {} if kind == "basic" else dict(style=style)
        self.out_indices = tuple(sorted(tuple(o) for o in out_indices))
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.deep_stem = deep_stem
        self.num_output_channels_list, self.num_output_strides_list = resnet_output_info(
            depth, base_channels, self.out_indices)

        if deep_stem:
            c2 = base_channels // 2
            self.stem = nn.Sequential(
                *conv_norm_act(in_channels, c2, 3, 2, ncfg, _RELU),
                *conv_norm_act(c2, c2, 3, 1, ncfg, _RELU),
                *conv_norm_act(c2, base_channels, 3, 1, ncfg, _RELU))
        else:
            self.conv1 = nn.Conv2d(in_channels, base_channels, 7, 2, padding=3, bias=False)
            self.bn1 = norm_from_cfg(ncfg, base_channels)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)  # no weights (torchvision's name)
        self.num_stages = max(st for st, _ in self.out_indices)
        cin, planes = base_channels, base_channels
        for i in range(self.num_stages):
            blocks = []
            for j in range(stage_blocks[i]):
                stride = strides[i] if j == 0 else 1
                needs_ds = j == 0 and (stride != 1 or cin != planes * block_cls.expansion)
                blocks.append(block_cls(cin, planes, stride, ncfg, needs_ds, **block_kw))
                cin = planes * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            planes *= 2

    def stem_modules(self):
        return [self.stem] if self.deep_stem else [self.conv1, self.bn1]

    def stages(self):
        """[layer1, ...]: stage s is stages()[s - 1]."""
        return [getattr(self, f"layer{s}") for s in range(1, self.num_stages + 1)]

    def train(self, mode=True):
        """torch's train(), then eval mode for the norms lfdtpu runs with
        train=False: all of them under norm_eval, else the stem when
        frozen_stages >= 0 and stage s when s <= frozen_stages."""
        super().train(mode)
        if mode:
            frozen = self.stem_modules() if self.norm_eval or self.frozen_stages >= 0 else []
            frozen += [st for s, st in enumerate(self.stages(), start=1)
                       if self.norm_eval or s <= self.frozen_stages]
            for part in frozen:
                part.eval()
        return self

    def forward(self, x):
        if self.deep_stem:
            x = self.stem(x)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for s, stage in enumerate(self.stages(), start=1):
            for j, block in enumerate(stage):
                x = block(x)
                if s <= self.frozen_stages:
                    x = x.detach()
                if (s, j) in self.out_indices:
                    outs.append(x)
        return tuple(outs)
