# SimpleNeck (`lfdtpu/models/necks.py::SimpleNeck`, reference
# `simple_neck.py:18-74`): per-level independent 1x1 conv + norm + ReLU.

from __future__ import annotations

from torch import nn

from .layers import conv_norm_act

_RELU = dict(type="ReLU")


class SimpleNeck(nn.Module):
    def __init__(self, num_input_channels_list, num_neck_channels,
                 num_input_strides_list=(), norm_cfg=None, act_cfg=None):
        super().__init__()
        norm_cfg = norm_cfg if norm_cfg is not None else dict(type="BatchNorm2d")
        act_cfg = act_cfg or _RELU
        self.num_levels = len(num_input_channels_list)
        self.num_output_strides_list = list(num_input_strides_list)
        for i, cin in enumerate(num_input_channels_list):
            setattr(self, f"neck{i}", nn.Sequential(
                *conv_norm_act(cin, num_neck_channels, 1, 1, norm_cfg, act_cfg)))

    def forward(self, inputs):
        return tuple(getattr(self, f"neck{i}")(x) for i, x in enumerate(inputs))
