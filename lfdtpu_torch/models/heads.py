# LFDHead (`lfdtpu/models/heads.py::LFDHead`, reference
# `lfd/model/head/lfd_head.py:30-185`), with the reference's module names:
# `head{k}_{merge,classification,regression}_path` Sequentials and
# `_scales.{i}._scale`.
#
# merge_path_flag: a shared conv trunk feeds two 1x1 final layers.
# share_head_flag: one set of modules reused on every level, registered once
# per level as the SAME object (as the reference does), so the state_dict
# carries head{k}_* duplicates of head0_*.
# IoU-family regression adds a learnable per-level Scale.
#
# LFDHeadV1 and FCOSHead (`lfdtpu/models/heads.py:119-209`) follow.

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Scale, conv_norm_act

_IOU_LOSSES = ("IoULoss", "GIoULoss", "DIoULoss", "CIoULoss")
_RELU = dict(type="ReLU")


class LFDHead(nn.Module):
    def __init__(self, num_classes, num_heads, in_channels,
                 num_head_channels=128, num_conv_layers=2, conv_kernel_size=1,
                 act_cfg=None, norm_cfg=None,
                 classification_loss_type="FocalLoss",
                 regression_loss_type="IoULoss", share_head_flag=False,
                 merge_path_flag=False):
        super().__init__()
        act_cfg = act_cfg or _RELU
        self.num_heads = num_heads
        self.share_head_flag = share_head_flag
        self.merge_path_flag = merge_path_flag
        cls_channels = (num_classes + 1
                        if classification_loss_type == "CrossEntropyLoss"
                        else num_classes)
        self.with_scale = regression_loss_type in _IOU_LOSSES

        def trunk():
            layers, cin = [], in_channels
            for _ in range(num_conv_layers):
                layers += conv_norm_act(cin, num_head_channels, conv_kernel_size,
                                        1, norm_cfg, act_cfg)
                cin = num_head_channels
            return layers

        def final(features):
            return nn.Conv2d(num_head_channels, features, 1, bias=True)

        def make_paths():
            if merge_path_flag:
                return dict(merge=nn.Sequential(*trunk()),
                            classification=nn.Sequential(final(cls_channels)),
                            regression=nn.Sequential(final(4)))
            return dict(classification=nn.Sequential(*trunk(), final(cls_channels)),
                        regression=nn.Sequential(*trunk(), final(4)))

        shared = make_paths() if share_head_flag else None
        for k in range(num_heads):
            paths = shared if share_head_flag else make_paths()
            for name, mod in paths.items():
                setattr(self, f"head{k}_{name}_path", mod)
        if self.with_scale:
            self._scales = nn.ModuleList(Scale(1.0) for _ in range(num_heads))

    def forward(self, inputs):
        assert len(inputs) == self.num_heads
        cls_outs, reg_outs = [], []
        for i, x in enumerate(inputs):
            if self.merge_path_flag:
                x = getattr(self, f"head{i}_merge_path")(x)
            cls_outs.append(getattr(self, f"head{i}_classification_path")(x))
            reg = getattr(self, f"head{i}_regression_path")(x)
            if self.with_scale:
                reg = self._scales[i](reg)
            reg_outs.append(reg)
        return cls_outs, reg_outs


def _trunk(in_channels, channels, num_layers, kernel_size, norm_cfg, act_cfg):
    """[conv, norm?, act]*num_layers, lfdtpu's `_HeadPath` without a final."""
    layers, cin = [], in_channels
    for _ in range(num_layers):
        layers += conv_norm_act(cin, channels, kernel_size, 1, norm_cfg, act_cfg)
        cin = channels
    return nn.Sequential(*layers)


class LFDHeadV1(nn.Module):
    """The older LFD head (`lfd_head.py:188-344`): `cls_trunk` / `reg_trunk`
    shared by every level, per-level 1x1 `cls_final{i}` / `reg_final{i}`,
    and with IoU-family regression a per-level Scale `_scales.{i}`."""

    def __init__(self, num_classes, num_heads, in_channels, num_head_channels=128,
                 num_conv_layers=2, conv_kernel_size=3, act_cfg=None, norm_cfg=None,
                 classification_loss_type="FocalLoss", regression_loss_type="IoULoss"):
        super().__init__()
        act_cfg = act_cfg or _RELU
        self.num_heads = num_heads
        cls_channels = (num_classes + 1 if classification_loss_type == "CrossEntropyLoss"
                        else num_classes)
        self.with_scale = regression_loss_type in _IOU_LOSSES
        trunk_out = num_head_channels if num_conv_layers > 0 else in_channels
        self.cls_trunk = _trunk(in_channels, num_head_channels, num_conv_layers,
                                conv_kernel_size, norm_cfg, act_cfg)
        self.reg_trunk = _trunk(in_channels, num_head_channels, num_conv_layers,
                                conv_kernel_size, norm_cfg, act_cfg)
        for i in range(num_heads):
            setattr(self, f"cls_final{i}", nn.Conv2d(trunk_out, cls_channels, 1))
            setattr(self, f"reg_final{i}", nn.Conv2d(trunk_out, 4, 1))
        if self.with_scale:
            self._scales = nn.ModuleList(Scale(1.0) for _ in range(num_heads))

    def forward(self, inputs):
        assert len(inputs) == self.num_heads
        cls_outs, reg_outs = [], []
        for i, x in enumerate(inputs):
            cls_outs.append(getattr(self, f"cls_final{i}")(self.cls_trunk(x)))
            reg = getattr(self, f"reg_final{i}")(self.reg_trunk(x))
            reg_outs.append(self._scales[i](reg) if self.with_scale else reg)
        return cls_outs, reg_outs


# the classification bias's prior, -log((1 - p) / p) at p = 0.01
# (`fcos_head.py:83-90,116-119`)
FCOS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class FCOSHead(nn.Module):
    """FCOS head (`fcos_head.py:21-155`) with the reference's module names:
    the 3x3 towers `_classification_path` / `_regression_path`, the 3x3
    finals `_classification`, `_centerness` (off the classification tower)
    and `_regression`, and a per-level Scale `_scales.{i}`. The regression is
    Scale then exp inside the head, in float32 whatever the net's dtype, and
    clamped at 30 so untrained rows cannot reach inf.

    forward returns (cls_outputs, reg_outputs, centerness_outputs)."""

    with_scale = True

    def __init__(self, num_classes, in_channels, num_heads=5, num_head_channels=256,
                 num_layers=4, norm_cfg=None):
        super().__init__()
        self.num_heads = num_heads
        c = num_head_channels
        self._classification_path = _trunk(in_channels, c, num_layers, 3, norm_cfg, _RELU)
        self._regression_path = _trunk(in_channels, c, num_layers, 3, norm_cfg, _RELU)
        cin = c if num_layers > 0 else in_channels
        self._classification = nn.Conv2d(cin, num_classes, 3, padding=1)
        self._centerness = nn.Conv2d(cin, 1, 3, padding=1)
        self._regression = nn.Conv2d(cin, 4, 3, padding=1)
        self._scales = nn.ModuleList(Scale(1.0) for _ in range(num_heads))

    def forward(self, inputs):
        assert len(inputs) == self.num_heads
        cls_outs, reg_outs, ctr_outs = [], [], []
        for i, x in enumerate(inputs):
            c = self._classification_path(x)
            cls_outs.append(self._classification(c))
            ctr_outs.append(self._centerness(c))
            reg = self._scales[i](self._regression(self._regression_path(x)))
            reg_outs.append(torch.exp(reg.float().clamp(max=30.0)))
        return cls_outs, reg_outs, ctr_outs
