# Model zoo: the same eight reference workload configs as `lfdtpu/zoo.py`,
# built as PyTorch modules with the same configured loss objects.
#   - WIDERFACE_LFD_{XS,S,M,L}  (`WIDERFACE_train/WIDERFACE_LFD_*.py`)
#   - TT100K_LFD_{S,L}          (`TT100K_train/TT100K_LFD_*.py`)
#   - TL_LFD_{S,L}              (`TrafficLight_train/TL_LFD_*.py`)
# FCOS-R50-FPN (Tian et al., ICCV 2019), as mmdetection's
# `configs/fcos/fcos_r50_caffe_fpn_gn-head_1x_coco.py` sets it out, and
# Deformable DETR-R50, two-stage with box refinement (Zhu et al., ICLR 2021),
# as mmdetection v2.28.2's
# `configs/deformable_detr/deformable_detr_twostage_refine_r50_16x2_50e_coco.py`.

from __future__ import annotations

from .models import FCOS, FPN, LFD, FCOSHead, LFDHead, LFDResNet, ResNet, SimpleNeck
from .models.deformable_detr import DeformableDETR, DeformableDETRNet
from .models.necks import ChannelMapper
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


def fcos_r50_fpn(**kw):
    """FCOS-R50-FPN at full width: a caffe ResNet-50 (stride on the first
    1x1 of a bottleneck) with stage 1 frozen and every BatchNorm in eval mode,
    tapped at the last block of stages 2-4 (512 / 1024 / 2048 channels,
    strides 8 / 16 / 32); an FPN of 256 channels and 5 levels, its two extra
    stride-2 convs on its own output with a ReLU before each; the FCOSHead
    (80 classes, two towers of 4 3x3 convs of 256 with GroupNorm(32), the
    centerness off the classification tower, per-level Scale then exp);
    FocalLoss(2, 0.25) + IoULoss and FCOS's defaults (ranges to 1e5, strides
    8-128, threshold 0.05, NMS 0.5, 1000 pre-NMS points a level, 100
    detections). `kw` goes to FCOS (thresholds, limits)."""
    backbone = ResNet(depth=50, style="caffe", frozen_stages=1, norm_eval=True,
                      out_indices=((2, 3), (3, 5), (4, 2)))
    neck = FPN(backbone.num_output_channels_list, backbone.num_output_strides_list, 256, 5,
               extra_on_input=False, relu_before_extra=True)
    head = FCOSHead(80, 256, num_heads=5, num_head_channels=256, num_layers=4,
                    norm_cfg=dict(type="GroupNorm", num_groups=32))
    return FCOS(backbone, neck, head, classification_loss_func=FocalLoss(gamma=2.0, alpha=0.25),
                regression_loss_func=IoULoss(eps=1e-6), **kw)


def deformable_detr_r50(**kw):
    """Deformable DETR-R50, two-stage, with iterative box refinement, at
    full width: a pytorch-style ResNet-50 (stride on the 3x3) with stage 1
    frozen and every BatchNorm in eval mode, tapped at C3-C5 (512 / 1024 /
    2048 channels); mmdetection's ChannelMapper to 256 on 4 levels
    (GroupNorm(32), the 4th a 3x3/s2 conv on C5); 6 encoder and 6 decoder
    layers of 256 with 8 heads, 4 levels and 4 points a head, FFN 1024; 300
    queries selected from the encoder's proposals; 80 classes; the top 100
    (query, class) pairs a frame. `kw` goes to DeformableDETR (max_per_img).
    Modules and decode: models/deformable_detr.py."""
    backbone = ResNet(depth=50, style="pytorch", frozen_stages=1, norm_eval=True,
                      out_indices=((2, 3), (3, 5), (4, 2)))
    neck = ChannelMapper(backbone.num_output_channels_list, backbone.num_output_strides_list,
                         256, 4, dict(type="GroupNorm", num_groups=32))
    return DeformableDETR(DeformableDETRNet(backbone, neck, num_classes=80), num_classes=80,
                          **kw)


ZOO = {
    "WIDERFACE-XS": lambda **kw: widerface_lfd("XS", **kw),
    "WIDERFACE-S": lambda **kw: widerface_lfd("S", **kw),
    "WIDERFACE-M": lambda **kw: widerface_lfd("M", **kw),
    "WIDERFACE-L": lambda **kw: widerface_lfd("L", **kw),
    "TT100K-S": lambda **kw: tt100k_lfd("S", **kw),
    "TT100K-L": lambda **kw: tt100k_lfd("L", **kw),
    "TL-S": lambda **kw: trafficlight_lfd("S", **kw),
    "TL-L": lambda **kw: trafficlight_lfd("L", **kw),
    "FCOS-R50-FPN": fcos_r50_fpn,
    "Deformable-DETR-R50": deformable_detr_r50,
}
