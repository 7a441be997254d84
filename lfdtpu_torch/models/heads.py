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

from __future__ import annotations

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
