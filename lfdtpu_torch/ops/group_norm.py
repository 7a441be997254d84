# K5: GroupNorm then ReLU on a channels-last activation, hand-written CUDA
# (`lfdtpu_torch/csrc/group_norm.cu`).
#
# Replaces no TPU kernel (lfdtpu leaves GroupNorm to XLA): it replaces
# ATen's CUDA group_norm and the ReLU after it in an engine's head, where
# ATen copied each channels-last map to NCHW and back and took its moments
# with one block per (sample, group), 16 blocks at batch 1. K5 reads the NHWC
# map twice (statistics on every SM, then normalize) and writes it once;
# what bounds it and how is in the head of the .cu file.
#
# The kernel is the custom op `lfd::group_norm_relu` (torch.library): its
# CUDA kernel is the two launches, its CPU kernel the plain version, so an
# exported engine program calls it. The wrapper calls the op: the plain
# version for CPU tensors only; for CUDA tensors the launches, or an error.

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import kernel_lib

MIN_SLAB_PIXELS = 512  # fewest pixels of a 128-channel map a block of a sample takes
BLOCKS_PER_SM = 4      # blocks a large map spreads over, per SM
MAX_CHANNELS = 8192    # csrc/group_norm.cu: C / 8 threads or fewer a pixel row


def eligible(channels, groups, dtype):
    """Whether K5 takes a GroupNorm of `groups` groups over `channels`
    channels in `dtype`: 8-channel octets that never straddle a group."""
    return (dtype in (torch.bfloat16, torch.float32) and 0 < channels <= MAX_CHANNELS
            and channels % 8 == 0 and groups > 0 and channels % groups == 0
            and (channels // groups) % 8 == 0)


def slabs(n, hw, sms, channels=128):
    """S, the blocks over each sample's hw pixels: MIN_SLAB_PIXELS or more a
    block, and BLOCKS_PER_SM x sms blocks over the batch at most (one block
    a sample at the least). Past 128 channels a pixel holds more bytes and a
    block fewer pixel rows (2048 / C), so the floor shrinks by 128 / C: each
    thread still makes its 32 loads a pass, as at 128 channels (FCOS's
    256-wide 112x176 map: 77 slabs, not 39; 21 us a launch against 27 on an
    H100 80GB HBM3 at 700 W)."""
    floor = max(1, MIN_SLAB_PIXELS * 128 // max(channels, 128))
    return max(1, min(-(-hw // floor), BLOCKS_PER_SM * sms // n))


@functools.cache
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def group_norm_relu_plain(x, weight, bias, num_groups, eps):
    """Plain version of K5: nn.GroupNorm then nn.ReLU as they compute it.
    x (N, H, W, C) NHWC, bf16 or float32; weight / bias (C,) float32 (used in
    x's dtype, as the module's parameters are). Returns (N, H, W, C) in x's
    dtype."""
    y = F.group_norm(x.permute(0, 3, 1, 2), num_groups, weight.to(x.dtype), bias.to(x.dtype),
                     eps)
    return torch.relu(y).permute(0, 2, 3, 1).contiguous()


@torch.library.custom_op("lfd::group_norm_relu", mutates_args=(), device_types="cpu")
def _gn_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
           eps: float) -> torch.Tensor:
    """K5's CPU kernel: the plain version."""
    return group_norm_relu_plain(x, weight, bias, num_groups, eps)


@_gn_op.register_kernel("cuda")
def _gn_cuda(x, weight, bias, num_groups, eps):
    """K5's CUDA kernel: the statistics then the normalize launch on the
    current stream, counted as one."""
    N, H, W, C = x.shape
    dev = x.device
    if not eligible(C, num_groups, x.dtype):
        raise ValueError(f"group_norm_relu: {C} channels in {num_groups} groups of "
                         f"{x.dtype} is not a shape K5 takes")
    kernel_lib.check_cuda("group_norm x", x, x.dtype, (N, H, W, C), dev)
    kernel_lib.check_cuda("group_norm weight", weight, torch.float32, (C,), dev)
    kernel_lib.check_cuda("group_norm bias", bias, torch.float32, (C,), dev)
    out = torch.empty_like(x)
    if x.numel():
        S = slabs(N, H * W, _sms(dev.index if dev.index is not None
                                 else torch.cuda.current_device()), C)
        part = torch.empty(2 * N * S * num_groups, dtype=torch.float32, device=dev)
        fp32 = int(x.dtype == torch.float32)
        with torch.cuda.device(dev):
            stream = kernel_lib.stream_of(x)
            kernel_lib.launch("lfd_group_norm_stats", x.data_ptr(), part.data_ptr(), N, H * W,
                              C, num_groups, S, fp32, stream)
            kernel_lib.launch("lfd_group_norm_relu", x.data_ptr(), part.data_ptr(),
                              weight.data_ptr(), bias.data_ptr(), out.data_ptr(), N, H * W, C,
                              num_groups, S, float(eps), fp32, stream)
    group_norm_relu.launches += 1
    return out


@_gn_op.register_fake
def _gn_fake(x, weight, bias, num_groups, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def group_norm_relu(x, weight, bias, num_groups, eps):
    """GroupNorm then ReLU (K5), the op lfd::group_norm_relu; see
    group_norm_relu_plain for the contract."""
    return torch.ops.lfd.group_norm_relu(x, weight, bias, int(num_groups), float(eps))


group_norm_relu.launches = 0
