from .layers import BatchNorm2d, Scale, activation_from_cfg, conv_norm_act, norm_from_cfg
from .blocks import FastBlock, FasterBlock, FastestBlock
from .lfd_resnet import LFDResNet
from .necks import SimpleNeck
from .heads import LFDHead
from .detector import LFD, DetectionNet, pad_to_multiple

__all__ = [
    "BatchNorm2d", "Scale", "activation_from_cfg", "conv_norm_act", "norm_from_cfg",
    "FastBlock", "FasterBlock", "FastestBlock",
    "LFDResNet", "SimpleNeck", "LFDHead",
    "LFD", "DetectionNet", "pad_to_multiple",
]
