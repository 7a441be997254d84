# Kernel inference path (`lfdtpu/deploy/pallas_net.py`): route the stem's
# first conv and the eligible FasterBlocks through the hand-written kernels
# K2 and K3 (`ops/conv_kernels.py`).
#
# The dispatch is explicit: `attach_kernels` sets `LFDResNet.fused_stem` and
# `FasterBlock.fused` on an engine's own copy of the net, and those modules'
# forward calls the callable instead of their layers. Weights are packed and
# BatchNorm folded ONCE, at engine build, from the engine's (cast) weights in
# fp32, as the JAX engine folds from its bf16-cast variables.

from __future__ import annotations

import torch
from torch import nn

from ..models.blocks import FasterBlock
from ..models.layers import BN_EPS
from ..ops.conv_kernels import pair_conv3x3, stem_conv


def prepack_pair_weights(net):
    """Every (64, 64, 3, 3) conv weight as a contiguous (3, 3, 64, 64) HWIO
    tensor in its own dtype, keyed by the module's state_dict name."""
    return {
        name: m.weight.detach().permute(2, 3, 1, 0).contiguous()
        for name, m in net.named_modules()
        if isinstance(m, nn.Conv2d) and tuple(m.weight.shape) == (64, 64, 3, 3)
    }


def _folded_bn_sb(norm):
    """Inference-mode BatchNorm as fp32 per-channel (scale, bias)."""
    scale = norm.weight.detach().float() * torch.rsqrt(
        norm.running_var.float() + BN_EPS)
    bias = norm.bias.detach().float() - norm.running_mean.float() * scale
    return scale.contiguous(), bias.contiguous()


def eligible_faster_block(block):
    """A stride-1 64-channel FasterBlock with BatchNorm + ReLU (what K3's
    epilogue computes); `pallas_net.py:141-160` without the TPU's H % 8,
    even-W and minimum-size limits."""
    return (
        isinstance(block, FasterBlock)
        and block.stride == 1
        and not block.use_downsample
        and block.features == 64
        and block._conv1.in_channels == 64
        and block.act_cfg.get("type") == "ReLU"
        and block.norm_cfg is not None
        and block.norm_cfg.get("type") == "BatchNorm2d"
    )


class FusedFasterBlock:
    """relu(bn(conv3x3(relu(bn(conv3x3(x)))) + x) as two K3 launches.
    Called with the block's NCHW (channels_last) bf16 input."""

    def __init__(self, w1, w2, sb1, sb2):
        self.w1, self.w2 = w1, w2
        self.sb1, self.sb2 = sb1, sb2

    def __call__(self, x):
        xh = x.permute(0, 2, 3, 1)  # NHWC view of a channels_last tensor
        if not xh.is_contiguous():
            xh = xh.contiguous()
        y = pair_conv3x3(xh, self.w1, *self.sb1, relu=True)
        out = pair_conv3x3(y, self.w2, *self.sb2, residual=xh, relu=True)
        return out.permute(0, 3, 1, 2)


def eligible_stem(net):
    """The backbone's first stem unit is conv 3x3/s2 3 -> 64 + BatchNorm +
    ReLU ('fast'/'faster' stems at 64 channels): what K2 computes."""
    stem = net._backbone._stem
    conv, norm = stem[0], stem[1] if len(stem) > 1 else None
    return (isinstance(conv, nn.Conv2d) and tuple(conv.weight.shape) == (64, 3, 3, 3)
            and conv.stride == (2, 2) and isinstance(norm, nn.BatchNorm2d)
            and len(stem) >= 3 and isinstance(stem[2], nn.ReLU))


def prepack_stem(net, mean, std, bgr2rgb=False):
    """Fold normalize + stem0 conv + BN into K2's constants.

    net: the engine's DetectionNet; its stem must pass eligible_stem.
    mean/std: the device-preprocess constants in pixel units (0..255).
    Returns (weight HWIO f32, mean, std, scale, bias) on the net's device,
    or None when the stem is not this shape."""
    if not eligible_stem(net):
        return None
    conv, norm = net._backbone._stem[0], net._backbone._stem[1]
    dev = conv.weight.device
    w = conv.weight.detach().float().permute(2, 3, 1, 0)  # (3, 3, cin, 64)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    std = torch.as_tensor(std, dtype=torch.float32, device=dev)
    if bgr2rgb:
        # conv(x[..., ::-1], k) == conv(x, k[:, :, ::-1, :]): fold the channel
        # flip into the weights and the normalize constants
        w, mean, std = w.flip(2), mean.flip(0), std.flip(0)
    scale, bias = _folded_bn_sb(norm)
    return (w.contiguous(), mean.contiguous(), std.contiguous(), scale, bias)


class FusedStem:
    """The stem's first ConvNormAct as one K2 launch on the raw uint8 frame
    (NCHW channels_last view in, NCHW channels_last bf16 view out)."""

    def __init__(self, pack):
        self.pack = pack

    def __call__(self, x):
        xh = x.permute(0, 2, 3, 1)
        if not xh.is_contiguous():
            xh = xh.contiguous()
        return stem_conv(xh, *self.pack, relu=True).permute(0, 3, 1, 2)


def attach_kernels(net, block_kernels=False, stem_pack=None):
    """Set the explicit kernel dispatch on `net` (an engine's own bf16 copy):
    K3 on every eligible FasterBlock when block_kernels, K2 on the stem when
    a stem_pack (from prepack_stem) is given. Returns the number of blocks
    routed to K3."""
    n_blocks = 0
    if block_kernels:
        packs = prepack_pair_weights(net)
        for name, m in net.named_modules():
            if eligible_faster_block(m):
                m.fused = FusedFasterBlock(
                    packs[f"{name}._conv1"], packs[f"{name}._conv2"],
                    _folded_bn_sb(m._norm1), _folded_bn_sb(m._norm2))
                n_blocks += 1
    if stem_pack is not None:
        net._backbone.fused_stem = FusedStem(stem_pack)
    return n_blocks
