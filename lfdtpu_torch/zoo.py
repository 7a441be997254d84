# Model zoo: the same eight reference workload configs as `lfdtpu/zoo.py`,
# built as PyTorch modules with the same configured loss objects.
#   - WIDERFACE_LFD_{XS,S,M,L}  (`WIDERFACE_train/WIDERFACE_LFD_*.py`)
#   - TT100K_LFD_{S,L}          (`TT100K_train/TT100K_LFD_*.py`)
#   - TL_LFD_{S,L}              (`TrafficLight_train/TL_LFD_*.py`)

from __future__ import annotations

from .models import LFD, LFDHead, LFDResNet, SimpleNeck
from .ops.loss_wrappers import CrossEntropyLoss, FocalLoss, IoULoss, QualityFocalLoss

_GN16 = dict(type="GroupNorm", num_groups=16)
_BN = dict(type="BatchNorm2d")

# backbone plans: (block, stem, stem_channels, arch, channels, out_indices)
_WIDERFACE_BACKBONES = {
    "XS": ("faster", "faster", 32, (4, 2, 2, 3), (64, 64, 64, 64),
           ((0, 3), (1, 1), (2, 1), (3, 0), (3, 2))),
    "S": ("faster", "faster", 64, (4, 2, 2, 3), (64, 64, 64, 128),
          ((0, 3), (1, 1), (2, 1), (3, 0), (3, 2))),
    "M": ("faster", "fast", 64, (3, 2, 1, 1, 1), (64, 64, 64, 128, 128),
          ((0, 2), (1, 1), (2, 0), (3, 0), (4, 0))),
    "L": ("faster", "fast", 64, (4, 2, 2, 1, 1), (64, 64, 64, 128, 128),
          ((0, 3), (1, 1), (2, 1), (3, 0), (4, 0))),
}

_TT100K_BACKBONES = {
    "S": ("faster", "faster", 64, (4, 2, 1, 1), (64, 64, 64, 128),
          ((0, 3), (1, 1), (2, 0), (3, 0))),
    "L": ("faster", "fast", 64, (5, 3, 2, 2), (64, 64, 128, 128),
          ((0, 4), (1, 2), (2, 1), (3, 1))),
}

_TL_BACKBONES = {
    "S": ("faster", "fast", 48, (4, 2, 1, 1, 1), (48, 64, 64, 128, 128),
          ((0, 3), (1, 1), (2, 0), (3, 0), (4, 0))),
    "L": ("faster", "fast", 64, (5, 3, 2, 2, 2), (64, 64, 128, 128, 128),
          ((0, 4), (1, 2), (2, 1), (3, 1), (4, 1))),
}


def _build(plan, num_classes, cls_loss, reg_loss, ranges, range_mode,
           merge_path, head_norm, **lfd_kwargs):
    block, stem, stem_ch, arch, chans, out_idx = plan
    backbone = LFDResNet(
        block_mode=block, stem_mode=stem, body_mode=None,
        stem_channels=stem_ch, body_architecture=tuple(arch),
        body_channels=tuple(chans), out_indices=tuple(out_idx),
        norm_cfg=_BN,
    )
    strides = tuple(backbone.num_output_strides_list)
    neck = SimpleNeck(
        backbone.num_output_channels_list, num_neck_channels=128,
        num_input_strides_list=strides, norm_cfg=_BN,
    )
    head = LFDHead(
        num_classes=num_classes, num_heads=len(strides), in_channels=128,
        num_head_channels=128, num_conv_layers=2, norm_cfg=head_norm,
        share_head_flag=True, merge_path_flag=merge_path,
        classification_loss_type=type(cls_loss).__name__,
        regression_loss_type=type(reg_loss).__name__,
    )
    return LFD(
        backbone=backbone, neck=neck, head=head, num_classes=num_classes,
        regression_ranges=ranges, gray_range_factors=(0.9, 1.1),
        range_assign_mode=range_mode, point_strides=strides,
        classification_loss_func=cls_loss, regression_loss_func=reg_loss,
        distance_to_bbox_mode="sigmoid", **lfd_kwargs,
    )


WIDERFACE_SCALES = ((4, 20), (20, 40), (40, 80), (80, 160), (160, 320))
TT100K_RANGES = ((4, 32), (32, 64), (64, 128), (128, 256))
TL_SCALES = ((0, 16), (16, 32), (32, 64), (64, 128), (128, 256))


def widerface_lfd(size="L", **kw):
    """WIDERFACE face detector: FocalLoss + IoULoss, sigmoid decode, 'dist'
    range assignment, 5 scales (4,20)..(160,320)
    (`WIDERFACE_LFD_S.py:80-158`)."""
    assert size in _WIDERFACE_BACKBONES
    return _build(_WIDERFACE_BACKBONES[size], 1,
                  FocalLoss(gamma=2.0, alpha=0.25), IoULoss(eps=1e-6),
                  WIDERFACE_SCALES, "dist", True, _GN16, **kw)


def tt100k_lfd(size="L", **kw):
    """TT100K 45-class: CrossEntropyLoss(+bg) + IoULoss, 'longer' mode,
    4 ranges, no merge path (`TT100K_LFD_L.py:80-141`)."""
    assert size in _TT100K_BACKBONES
    return _build(_TT100K_BACKBONES[size], 45, CrossEntropyLoss(), IoULoss(eps=1e-6),
                  TT100K_RANGES, "longer", False, _GN16, **kw)


def trafficlight_lfd(size="L", **kw):
    """TrafficLight 1-class: QualityFocalLoss(w=2) + IoULoss, 'dist' mode,
    5 scales (0,16)..(128,256), head without norm (`TL_LFD_L.py:84-146`)."""
    assert size in _TL_BACKBONES
    return _build(_TL_BACKBONES[size], 1,
                  QualityFocalLoss(beta=2.0, loss_weight=2.0), IoULoss(eps=1e-6),
                  TL_SCALES, "dist", True, None, **kw)


ZOO = {
    "WIDERFACE-XS": lambda **kw: widerface_lfd("XS", **kw),
    "WIDERFACE-S": lambda **kw: widerface_lfd("S", **kw),
    "WIDERFACE-M": lambda **kw: widerface_lfd("M", **kw),
    "WIDERFACE-L": lambda **kw: widerface_lfd("L", **kw),
    "TT100K-S": lambda **kw: tt100k_lfd("S", **kw),
    "TT100K-L": lambda **kw: tt100k_lfd("L", **kw),
    "TL-S": lambda **kw: trafficlight_lfd("S", **kw),
    "TL-L": lambda **kw: trafficlight_lfd("L", **kw),
}
