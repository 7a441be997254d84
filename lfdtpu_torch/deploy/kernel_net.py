# Kernel inference path (`lfdtpu/deploy/pallas_net.py`): route the stem's
# first conv and the eligible FasterBlocks through the hand-written kernels
# K2 and K3 (`ops/conv_kernels.py`), and the head's GroupNorm -> ReLU pairs
# through K5 (`ops/group_norm.py`; lfdtpu leaves GroupNorm to XLA).
#
# The dispatch is explicit: `attach_kernels` sets `LFDResNet.fused_stem` and
# `FasterBlock.fused` on an engine's own copy of the net, and those modules'
# forward calls the callable instead of their layers; it puts a
# FusedGroupNormReLU in place of each eligible GroupNorm of a Sequential and
# an Identity in place of the ReLU after it (the indices, and so the module
# names, stay). Weights are packed and BatchNorm folded ONCE, at engine
# build, from the engine's (cast) weights in fp32, as the JAX engine folds
# from its bf16-cast variables.

from __future__ import annotations

import torch
from torch import nn

from ..models.blocks import FasterBlock
from ..models.layers import BN_EPS
from ..ops import group_norm
from ..ops.conv_kernels import pair_conv3x3, stem_conv
from ..ops.group_norm import group_norm_relu


def _nhwc(x):
    """The NHWC tensor of an NCHW one: a view of a channels_last tensor, a
    copy of any other."""
    xh = x.permute(0, 2, 3, 1)
    return xh if xh.is_contiguous() else xh.contiguous()


def prepack_pair_weights(net):
    """Every (64, 64, 3, 3) conv weight as a contiguous (3, 3, 64, 64) HWIO
    tensor in its own dtype, keyed by the module's state_dict name."""
    return {
        name: m.weight.detach().permute(2, 3, 1, 0).contiguous()
        for name, m in net.named_modules()
        if isinstance(m, nn.Conv2d) and tuple(m.weight.shape) == (64, 64, 3, 3)
    }


def folded_norm(conv, norm, device=None):
    """`conv` then an inference-mode BatchNorm `norm` (None: no norm) as
    float32 per-channel (scale, bias), the conv's bias folded in
    (`lfdtpu/deploy/int8_net.py:287-306`): bn(conv + b) == scale * conv +
    (scale * b + bn_bias). Folded on `device` (default: where the conv
    lives): K2 and K3 fold on the engine's device, K4 on the CPU, and rsqrt
    may round differently on the two."""
    def f32(t):
        return t.detach().float().to(device)

    bias = f32(conv.bias) if conv.bias is not None else None
    if norm is None:
        ones = torch.ones(conv.out_channels, device=device or conv.weight.device)
        return ones, bias if bias is not None else torch.zeros_like(ones)
    scale = f32(norm.weight) * torch.rsqrt(f32(norm.running_var) + BN_EPS)
    b = f32(norm.bias) - f32(norm.running_mean) * scale
    return scale, b if bias is None else b + bias * scale


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


class FusedFasterBlock(nn.Module):
    """relu(bn(conv3x3(relu(bn(conv3x3(x)))) + x) as two K3 launches.
    Called with the block's NCHW (channels_last) bf16 input. Its packed
    weights and folded BN are buffers, so an exported engine holds them."""

    def __init__(self, w1, w2, sb1, sb2):
        super().__init__()
        for name, t in (("w1", w1), ("w2", w2), ("scale1", sb1[0]), ("bias1", sb1[1]),
                        ("scale2", sb2[0]), ("bias2", sb2[1])):
            self.register_buffer(name, t)

    def forward(self, x):
        xh = _nhwc(x)
        y = pair_conv3x3(xh, self.w1, self.scale1, self.bias1, relu=True)
        out = pair_conv3x3(y, self.w2, self.scale2, self.bias2, residual=xh, relu=True)
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
    scale, bias = folded_norm(conv, norm)
    return (w.contiguous(), mean.contiguous(), std.contiguous(), scale, bias)


_STEM_PACK = ("weight", "mean", "std", "scale", "bias")  # prepack_stem's tuple


class FusedStem(nn.Module):
    """The stem's first ConvNormAct as one K2 launch on the raw uint8 frame
    (NCHW channels_last view in, NCHW channels_last bf16 view out). Its
    constants (prepack_stem's) are buffers."""

    def __init__(self, pack):
        super().__init__()
        for name, t in zip(_STEM_PACK, pack):
            self.register_buffer(name, t)

    @property
    def pack(self):
        return tuple(getattr(self, name) for name in _STEM_PACK)

    def forward(self, x):
        return stem_conv(_nhwc(x), *self.pack, relu=True).permute(0, 3, 1, 2)


def eligible_group_norm(norm, act):
    """A GroupNorm with its affine parameters followed by a ReLU, in bf16 or
    float32, whose groups K5 takes (ops/group_norm.py::eligible)."""
    return (isinstance(norm, nn.GroupNorm) and norm.affine and isinstance(act, nn.ReLU)
            and group_norm.eligible(norm.num_channels, norm.num_groups, norm.weight.dtype))


class FusedGroupNormReLU(nn.Module):
    """relu(group_norm(x)) as one K5 launch. Called with the GroupNorm's NCHW
    (channels_last) input; returns the same view of its NHWC output. The
    affine parameters are float32 buffers, so an exported engine holds
    them."""

    def __init__(self, norm):
        super().__init__()
        self.num_groups, self.eps = norm.num_groups, norm.eps
        self.register_buffer("weight", norm.weight.detach().float().contiguous())
        self.register_buffer("bias", norm.bias.detach().float().contiguous())

    def forward(self, x):
        return group_norm_relu(_nhwc(x), self.weight, self.bias, self.num_groups,
                               self.eps).permute(0, 3, 1, 2)


def _eligible_pairs(net):
    """(Sequential, index) of every eligible GroupNorm -> ReLU pair, each
    module once (a shared head is one object under every level's name)."""
    return [(m, i) for m in net.modules() if isinstance(m, nn.Sequential)
            for i in range(len(m) - 1) if eligible_group_norm(m[i], m[i + 1])]


def group_norm_calls(net):
    """K5 launches in one forward of `net` at batch 1 once attach_kernels
    routes its GroupNorms: the eligible pairs' calls, counted by forward
    hooks on a zero 64x64 frame in eval mode (a shared head counts at every
    level it runs at)."""
    calls = []
    hooks = [seq[i].register_forward_hook(lambda *_: calls.append(1))
             for seq, i in _eligible_pairs(net)]
    p = next(net.parameters())
    was_training = net.training
    try:
        net.eval()
        with torch.inference_mode():
            net(torch.zeros((1, 64, 64, 3), dtype=p.dtype, device=p.device))
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()
    return len(calls)


def attach_kernels(net, block_kernels=False, stem_pack=None, group_norms=True):
    """Set the explicit kernel dispatch on `net` (an engine's own copy): K3
    on every eligible FasterBlock when block_kernels, K2 on the stem when a
    stem_pack (from prepack_stem) is given, and K5 on every eligible
    GroupNorm -> ReLU pair of a Sequential when group_norms (not on a net
    that parallel/spatial.py splits over rows: its GroupNorm takes moments
    across ranks). Returns the number of blocks routed to K3."""
    if group_norms:
        for seq, i in _eligible_pairs(net):
            seq[i], seq[i + 1] = FusedGroupNormReLU(seq[i]), nn.Identity()
    n_blocks = 0
    if block_kernels:
        packs = prepack_pair_weights(net)
        for name, m in net.named_modules():
            if eligible_faster_block(m):
                m.fused = FusedFasterBlock(
                    packs[f"{name}._conv1"], packs[f"{name}._conv2"],
                    folded_norm(m._conv1, m._norm1), folded_norm(m._conv2, m._norm2))
                n_blocks += 1
    if stem_pack is not None:
        net._backbone.fused_stem = FusedStem(stem_pack)
    return n_blocks
