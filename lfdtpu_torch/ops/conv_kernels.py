# K2 (fused uint8 stem) and K3 (3x3 64->64 conv with fused epilogue),
# hand-written CUDA (`lfdtpu_torch/csrc/stem_conv.cu`, `csrc/pair_conv.cu`).
#
# They replace `lfdtpu/ops/conv_pallas.py::stem_conv` and `::pair_conv3x3`.
# The TPU versions packed their weights into 128-lane matmul layouts for the
# TPU's matrix unit; these keep the contract (shapes, padding, epilogue,
# bf16 in/out with fp32 accumulation) and take a batch N. What bounds each on
# the H100 and what the design does about it is in the head of its .cu file.
#
# Layout: NHWC tensors. The port runs its net in torch.channels_last, whose
# NCHW tensors ARE NHWC in memory, so `x.permute(0, 2, 3, 1)` hands a
# channels_last activation to these wrappers without a copy.
#
# Each wrapper runs its plain PyTorch version for CPU tensors only; for CUDA
# tensors it launches the kernel or raises.

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel_lib


# --------------------------------------------------------------------------
# K2: uint8 frame -> normalize -> 3x3/s2 conv 3->64 -> scale/bias -> ReLU
# --------------------------------------------------------------------------

def stem_conv_plain(frame, weight, mean, std, scale, bias, relu=True):
    """Plain version of K2. frame (N, H, W, 3) uint8; weight (3, 3, 3, 64)
    HWIO f32; mean/std (3,) in pixel units; scale/bias (64,) f32.
    Returns (N, ceil(H/2), ceil(W/2), 64) bf16."""
    x = (frame.float() - mean) / std
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.float().permute(3, 2, 0, 1),
                 stride=2, padding=1)
    y = y.permute(0, 2, 3, 1) * scale + bias
    if relu:
        y = torch.relu(y)
    return y.to(torch.bfloat16).contiguous()


def stem_conv(frame, weight, mean, std, scale, bias, relu=True):
    """Fused stem (K2); see stem_conv_plain for the contract."""
    if not frame.is_cuda:
        return stem_conv_plain(frame, weight, mean, std, scale, bias, relu)
    N, H, W, _ = frame.shape
    dev = frame.device
    kernel_lib.check_cuda("stem frame", frame, torch.uint8, (N, H, W, 3), dev)
    kernel_lib.check_cuda("stem weight", weight, torch.float32, (3, 3, 3, 64), dev)
    for name, t, n in (("mean", mean, 3), ("std", std, 3),
                       ("scale", scale, 64), ("bias", bias, 64)):
        kernel_lib.check_cuda(f"stem {name}", t, torch.float32, (n,), dev)
    out = torch.empty((N, (H + 1) // 2, (W + 1) // 2, 64), dtype=torch.bfloat16,
                      device=frame.device)
    with torch.cuda.device(frame.device):
        kernel_lib.launch(
            "lfd_stem_conv", frame.data_ptr(), weight.data_ptr(), mean.data_ptr(),
            std.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            N, H, W, int(relu), kernel_lib.stream_of(frame),
        )
    stem_conv.launches += 1
    return out


stem_conv.launches = 0


# --------------------------------------------------------------------------
# K3: 3x3/s1 conv 64->64 -> scale/bias (+ residual) (-> ReLU), bf16 NHWC
# --------------------------------------------------------------------------

def pair_conv3x3_plain(x, weight, scale, bias, residual=None, relu=True):
    """Plain version of K3. x (N, H, W, 64) bf16; weight (3, 3, 64, 64) HWIO
    bf16; scale/bias (64,) f32; residual optional (N, H, W, 64) bf16.
    Returns (N, H, W, 64) bf16 (fp32 conv and epilogue, one rounding)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), weight.float().permute(3, 2, 0, 1),
                 padding=1)
    y = y.permute(0, 2, 3, 1) * scale + bias
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(torch.bfloat16).contiguous()


def pair_conv3x3(x, weight, scale, bias, residual=None, relu=True):
    """3x3 conv with fused epilogue (K3); see pair_conv3x3_plain."""
    if not x.is_cuda:
        return pair_conv3x3_plain(x, weight, scale, bias, residual, relu)
    N, H, W, _ = x.shape
    dev = x.device
    kernel_lib.check_cuda("pair_conv x", x, torch.bfloat16, (N, H, W, 64), dev)
    kernel_lib.check_cuda("pair_conv weight", weight, torch.bfloat16, (3, 3, 64, 64), dev)
    kernel_lib.check_cuda("pair_conv scale", scale, torch.float32, (64,), dev)
    kernel_lib.check_cuda("pair_conv bias", bias, torch.float32, (64,), dev)
    if residual is not None:
        kernel_lib.check_cuda("pair_conv residual", residual, torch.bfloat16,
                              (N, H, W, 64), dev)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        kernel_lib.launch(
            "lfd_pair_conv3x3", x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), N, H, W, int(relu), kernel_lib.stream_of(x),
        )
    pair_conv3x3.launches += 1
    return out


pair_conv3x3.launches = 0
