from .layers import BatchNorm2d, Scale, activation_from_cfg, conv_norm_act, norm_from_cfg
from .blocks import FastBlock, FasterBlock, FastestBlock
from .lfd_resnet import LFDResNet, lfd_resnet_output_info
from .resnet import ARCH_SETTINGS, BasicBlock, Bottleneck, ResNet, resnet_output_info
from .necks import FPN, SimpleFPN, SimpleNeck, fpn_output_strides, nearest_upsample_to
from .heads import FCOSHead, LFDHead, LFDHeadV1
from .detector import LFD, DenseDetector, DetectionNet, pad_to_multiple
from .lfdv2 import LFDv2, LFDv2Q
from .fcos import FCOS, FCOSv1

__all__ = [
    "BatchNorm2d", "Scale", "activation_from_cfg", "conv_norm_act", "norm_from_cfg",
    "FastBlock", "FasterBlock", "FastestBlock",
    "LFDResNet", "lfd_resnet_output_info",
    "ARCH_SETTINGS", "BasicBlock", "Bottleneck", "ResNet", "resnet_output_info",
    "SimpleNeck", "FPN", "SimpleFPN", "fpn_output_strides", "nearest_upsample_to",
    "LFDHead", "LFDHeadV1", "FCOSHead",
    "LFD", "DenseDetector", "LFDv2", "LFDv2Q", "FCOS", "FCOSv1", "DetectionNet",
    "pad_to_multiple",
]
