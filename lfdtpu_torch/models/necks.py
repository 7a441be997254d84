# Necks (`lfdtpu/models/necks.py`, reference
# `lfd/model/neck/{simple_neck,fpn,simple_fpn}.py`):
#   SimpleNeck  per-level independent 1x1 conv + norm + ReLU;
#   FPN         1x1 laterals, top-down nearest-upsample adds, 3x3 outputs and
#               extra stride-2 levels (a 3x3/s2 conv or a 3x3/s2 max pool);
#   SimpleFPN   FPN without the 3x3 outputs on the lateral levels, with an
#               optional bottom-up neighbouring_mode merge;
#   ChannelMapper  mmdetection's (v2.28.2 `mmdet/models/necks/channel_mapper.py`,
#               Deformable DETR's neck): per level a 1x1 conv + norm, extra
#               levels a 3x3/s2 conv + norm, the first on the last input; no
#               activation and no merge between levels.
# Module names are lfdtpu's: `lateral{i}` (a Sequential [conv, norm?, relu?])
# and `fpn_out{i}`.
#
# The upsample (F3) must pick lfdtpu's pixels: jax.image.resize(method=
# "nearest") samples floor((i + 0.5) * in / out), which torch calls
# "nearest-exact"; torch's "nearest" samples floor(i * in / out) and differs
# whenever the ratio is not an integer (13 -> 25 after ResNet's halvings of
# an odd size).

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import conv_norm_act, norm_from_cfg

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


def nearest_upsample_to(x, target_hw):
    """Nearest-neighbour upsample of NCHW `x` to an exact (h, w), sampling
    floor((i + 0.5) * in / out) as lfdtpu's jax.image.resize does."""
    return F.interpolate(x, size=tuple(int(v) for v in target_hw), mode="nearest-exact")


class NearestUpsample(nn.Module):
    """nearest_upsample_to as a module (no weights): the FPNs call it
    through one, which parallel.spatial swaps for its row-split form."""

    def forward(self, x, target_hw):
        return nearest_upsample_to(x, target_hw)


def fpn_output_strides(num_input_strides_list, num_outputs):
    """`fpn.py:104-109` / `simple_fpn.py:120-126`."""
    s = list(num_input_strides_list)
    if num_outputs <= len(s):
        return s[:num_outputs]
    for i in range(num_outputs - len(num_input_strides_list)):
        s.append(num_input_strides_list[-1] * 2 ** (i + 1))
    return s


class FPN(nn.Module):
    """Classic top-down FPN (`fpn.py:17-152`). Its convs start from
    xavier-uniform weights (`fpn.py:117-121`): `xavier_init` tells the
    detectors' init."""

    xavier_init = True
    lateral_outputs = False  # FPN puts a 3x3 conv on every lateral level

    def __init__(self, num_input_channels_list, num_input_strides_list, num_output_channels,
                 num_outputs, extra_on_input=False, extra_type="conv", norm_on_lateral=False,
                 relu_on_lateral=False, relu_before_extra=False, norm_cfg=None):
        super().__init__()
        self.num_inputs = len(num_input_channels_list)
        self.num_outputs = num_outputs
        self.extra_on_input = extra_on_input
        self.extra_type = extra_type
        self.relu_before_extra = relu_before_extra
        self.num_output_strides_list = fpn_output_strides(num_input_strides_list, num_outputs)
        self.upsample = NearestUpsample()
        if extra_type != "conv":
            self.extra_pool = nn.MaxPool2d(3, 2, padding=1)
        c = num_output_channels
        for i, cin in enumerate(num_input_channels_list):
            layers = [nn.Conv2d(cin, c, 1, bias=not norm_on_lateral)]
            if norm_on_lateral:
                layers.append(norm_from_cfg(norm_cfg, c))
            if relu_on_lateral:
                layers.append(nn.ReLU())
            setattr(self, f"lateral{i}", nn.Sequential(*layers))
        for i in range(num_outputs):
            if i < self.num_inputs and not self.lateral_outputs:
                setattr(self, f"fpn_out{i}", nn.Conv2d(c, c, 3, padding=1))
            elif i >= self.num_inputs and extra_type == "conv":
                cin = (num_input_channels_list[-1] if i == self.num_inputs and extra_on_input
                       else c)
                setattr(self, f"fpn_out{i}", nn.Conv2d(cin, c, 3, 2, padding=1))

    def _merge(self, laterals):
        """Top-down: each level adds the upsampled (already merged) level
        above it."""
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + self.upsample(
                laterals[i], laterals[i - 1].shape[-2:])

    def _extra_level(self, x, i):
        if self.relu_before_extra:
            x = F.relu(x)
        if self.extra_type == "conv":
            return getattr(self, f"fpn_out{i}")(x)
        return self.extra_pool(x)

    def forward(self, inputs):
        n_in = len(inputs)
        laterals = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(inputs)]
        self._merge(laterals)
        outs = []
        for i in range(self.num_outputs):
            if i < n_in:
                outs.append(laterals[i] if self.lateral_outputs
                            else getattr(self, f"fpn_out{i}")(laterals[i]))
            elif i == n_in:
                outs.append(self._extra_level(inputs[-1] if self.extra_on_input
                                              else outs[-1], i))
            else:
                outs.append(self._extra_level(outs[-1], i))
        return tuple(outs)


class SimpleFPN(FPN):
    """FPN without the 3x3 output convs on the lateral levels
    (`simple_fpn.py:110-111`), kaiming init (`simple_fpn.py:131-135`); with
    neighbouring_mode each level adds only its next neighbour, bottom-up
    (`simple_fpn.py:148-152`)."""

    xavier_init = False
    lateral_outputs = True

    def __init__(self, *args, neighbouring_mode=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.neighbouring_mode = neighbouring_mode

    def _merge(self, laterals):
        if not self.neighbouring_mode:
            return super()._merge(laterals)
        for i in range(len(laterals) - 1):
            laterals[i] = laterals[i] + self.upsample(laterals[i + 1],
                                                      laterals[i].shape[-2:])


class ChannelMapper(nn.Module):
    """mmdetection's ChannelMapper: `lateral{i}` = [1x1 conv (no bias), norm]
    on input i; `extra{j}` = [3x3/s2 conv (no bias), norm], extra 0 on the
    last input and each later one on the output before it. No activation
    (so K5, a GroupNorm + ReLU, takes none of its norms)."""

    def __init__(self, num_input_channels_list, num_input_strides_list, num_output_channels,
                 num_outputs, norm_cfg):
        super().__init__()
        self.num_inputs = len(num_input_channels_list)
        self.num_outputs = num_outputs
        self.num_output_strides_list = fpn_output_strides(num_input_strides_list, num_outputs)
        c = num_output_channels
        for i, cin in enumerate(num_input_channels_list):
            setattr(self, f"lateral{i}", nn.Sequential(*conv_norm_act(cin, c, 1, 1, norm_cfg)))
        for j in range(num_outputs - self.num_inputs):
            cin = num_input_channels_list[-1] if j == 0 else c
            setattr(self, f"extra{j}", nn.Sequential(*conv_norm_act(cin, c, 3, 2, norm_cfg)))

    def forward(self, inputs):
        outs = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(inputs)]
        for j in range(self.num_outputs - self.num_inputs):
            outs.append(getattr(self, f"extra{j}")(inputs[-1] if j == 0 else outs[-1]))
        return tuple(outs)
