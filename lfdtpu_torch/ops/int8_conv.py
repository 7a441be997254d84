# K4: int8 convolution with a fused requant epilogue, hand-written CUDA
# (`lfdtpu_torch/csrc/int8_conv.cu`), and the int8 helpers of the fused chain
# (`lfdtpu/deploy/int8_net.py:50-55,267-273`).
#
# K4 replaces XLA's int8 x int8 -> int32 convolution of lfdtpu's fused int8
# chain (`int8_net.py:276-284`) together with the epilogue around it
# (`_cna_int8`, `_block_int8`). Layout: NHWC int8 activations; the weight is
# packed once, at engine build, into K4's (Cout, Kpad) rows
# (pack_int8_weight). The epilogue's arithmetic is lfdtpu's, step by step in
# float32: f = f32(acc) * mult + bias, an optional residual (f32(r8) * s_r or
# a float32 tensor), ReLU, and the requant clip(round(v * inv_out), -127,
# 127) with round half to even.
#
# Three routes, picked by shape (route_of), each counted in int8_conv.routes
# beside int8_conv.launches: "wgmma" (`csrc/int8_conv_wgmma.cuh`) takes 32,
# 48, 64 or 128 input and output channels, 1x1 or 3x3, stride 1 or 2, which
# is every conv of the zoo's int8 chains but the stem; "stem"
# (`csrc/int8_conv_stem.cu`) the 3-channel 3x3/s2 conv to 32, 48 or 64
# channels, every chain's stem0; "mma" (the first, plain mma.sync kernel,
# `csrc/int8_conv.cu`) every other shape: Cout 8, 16, 24 or 96, other kernel
# sizes, which no zoo chain has. All three compute the same function,
# exactly.
#
# K4 is the custom op `lfd::int8_conv` (torch.library): its CUDA kernel picks
# the route from the shapes and launches it, its CPU kernel is the plain
# version, so an exported engine program calls it and the route is chosen at
# every call, not frozen by the export. The wrapper calls the op: the plain
# version for CPU tensors only; for CUDA tensors the kernel, or an error.

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import kernel_lib

K_STEP = 32  # K4's K bytes per mma step: a packed row is a multiple of it
COUTS = (8, 16, 24, 32, 48, 64, 96, 128)  # output channels K4 is built for
ROUTES = ("mma", "stem", "wgmma")  # the C entry point's route numbers, in order
WGMMA_WIDTHS = (32, 48, 64, 128)  # input and output channels of the wgmma route
STEM_COUTS = (32, 48, 64)  # output channels of the stem route


def route_of(cin, cout, kernel_size, stride):
    """The kernel that takes a conv of this shape (see the header)."""
    if (cin in WGMMA_WIDTHS and cout in WGMMA_WIDTHS and kernel_size in (1, 3)
            and stride in (1, 2)):
        return "wgmma"
    if cin == 3 and cout in STEM_COUTS and (kernel_size, stride) == (3, 2):
        return "stem"
    return "mma"


def scale_of(amax_value):
    """A calibrated amax as its symmetric int8 scale (`int8_net.py:267-268`)."""
    return max(float(amax_value), 1e-8) / 127.0


def quantize_to(x, scale):
    """float -> int8 at `scale` (`int8_net.py:271-273`): the reciprocal in
    double, rounded to float32, then round half to even and clip."""
    inv = np.float32(1.0 / scale)
    return torch.round(x.float() * float(inv)).clamp_(-127, 127).to(torch.int8)


def quantize_weights(weight):
    """Per-output-channel symmetric int8 quantization of an OIHW conv weight
    (`int8_net.py:50-55`, HWIO there): amax over (Cin, kh, kw), scale
    max(amax, 1e-8) / 127 and round(w / scale), all in the weight's dtype.
    Returns (int8 OIHW, (Cout,) scale in the weight's dtype)."""
    amax = weight.abs().amax(dim=(1, 2, 3), keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(weight / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def cin_pad(cin):
    """Channels per tap in the packed row: a multiple of K_STEP when Cin is a
    multiple of 16 (a K step then lies inside one tap); 0 for the flat
    layout (taps x Cin, padded to K_STEP once: the 3-channel stem)."""
    return -(-cin // K_STEP) * K_STEP if cin % 16 == 0 else 0


def packed_width(cin, kernel_size):
    taps = kernel_size * kernel_size
    pad = cin_pad(cin)
    return taps * pad if pad else -(-taps * cin // K_STEP) * K_STEP


def pack_int8_weight(q):
    """int8 OIHW -> K4's (Cout, Kpad) rows, k = (dy * kw + dx) * cin_pad + c
    (or * Cin in the flat layout), zero padded."""
    cout, cin, kh, kw = q.shape
    taps = q.permute(0, 2, 3, 1).reshape(cout, kh * kw, cin)  # (Cout, tap, c)
    pad = cin_pad(cin)
    if pad:
        rows = torch.zeros((cout, kh * kw, pad), dtype=torch.int8, device=q.device)
        rows[:, :, :cin] = taps
        return rows.reshape(cout, -1).contiguous()
    rows = torch.zeros((cout, packed_width(cin, kh)), dtype=torch.int8, device=q.device)
    rows[:, :kh * kw * cin] = taps.reshape(cout, -1)
    return rows


def unpack_int8_weight(wpack, cin, kernel_size):
    """Inverse of pack_int8_weight: (Cout, Kpad) -> int8 OIHW."""
    cout, k = wpack.shape[0], kernel_size
    pad = cin_pad(cin)
    if pad:
        taps = wpack.reshape(cout, k * k, pad)[:, :, :cin]
    else:
        taps = wpack[:, :k * k * cin].reshape(cout, k * k, cin)
    return taps.reshape(cout, k, k, cin).permute(0, 3, 1, 2)


def out_hw(h, w, kernel_size, stride):
    p = kernel_size // 2
    return (h + 2 * p - kernel_size) // stride + 1, (w + 2 * p - kernel_size) // stride + 1


def _epilogue(acc, mult, bias, relu, out_scale, residual, residual_scale):
    """lfdtpu's f32 epilogue as separate float32 ops (no contraction)."""
    f = acc.float() * mult
    f = f + bias
    if residual is not None:
        identity = (residual.float() * float(np.float32(residual_scale))
                    if residual.dtype == torch.int8 else residual)
        f = torch.clamp_min(f + identity, 0.0)
    elif relu:
        f = torch.clamp_min(f, 0.0)
    if out_scale is None:
        return f.contiguous()
    return quantize_to(f, out_scale).contiguous()


def int8_conv_plain(x, wpack, mult, bias, kernel_size, stride, relu=False, out_scale=None,
                    residual=None, residual_scale=None):
    """Plain version of K4. x (N, H, W, Cin) int8; wpack (Cout, Kpad) int8
    from pack_int8_weight; mult, bias (Cout,) float32; padding
    kernel_size // 2. out_scale None: float32 out, else int8 requantized at
    out_scale. residual: None, int8 (with residual_scale) or float32
    (N, Ho, Wo, Cout); with one the epilogue ends relu(f + identity).
    The int8 products are summed in float64 (exact: |sum| < 2**53) and cast
    to int32, as a float32 conv is not (127**2 * 1152 > 2**24)."""
    w = unpack_int8_weight(wpack, x.shape[-1], kernel_size)
    with torch.backends.cudnn.flags(enabled=False):  # no FFT or Winograd on the card
        acc = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(), stride=stride,
                       padding=kernel_size // 2)
    acc = acc.to(torch.int32).permute(0, 2, 3, 1)
    return _epilogue(acc, mult, bias, relu, out_scale, residual, residual_scale)


@torch.library.custom_op("lfd::int8_conv", mutates_args=(), device_types="cpu")
def _int8_op(x: torch.Tensor, wpack: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
             kernel_size: int, stride: int, relu: bool, out_scale: Optional[float],
             residual: Optional[torch.Tensor], residual_scale: Optional[float]) -> torch.Tensor:
    """K4's CPU kernel: the plain version."""
    return int8_conv_plain(x, wpack, mult, bias, kernel_size, stride, relu, out_scale,
                           residual, residual_scale)


@_int8_op.register_kernel("cuda")
def _int8_cuda(x, wpack, mult, bias, kernel_size, stride, relu, out_scale, residual,
               residual_scale):
    """K4's CUDA kernel: the route of this shape, launched and counted."""
    route = route_of(x.shape[-1], wpack.shape[0], kernel_size, stride)
    out = launch_on(route, x, wpack, mult, bias, kernel_size, stride, relu, out_scale, residual,
                    residual_scale)
    int8_conv.launches += 1
    int8_conv.routes[route] += 1
    return out


@_int8_op.register_fake
def _int8_fake(x, wpack, mult, bias, kernel_size, stride, relu, out_scale, residual,
               residual_scale):
    n, h, w, _ = x.shape
    ho, wo = out_hw(h, w, kernel_size, stride)
    return x.new_empty((n, ho, wo, wpack.shape[0]),
                       dtype=torch.float32 if out_scale is None else torch.int8)


def int8_conv(x, wpack, mult, bias, kernel_size, stride, relu=False, out_scale=None,
              residual=None, residual_scale=None):
    """int8 conv with its fused epilogue (K4), the op lfd::int8_conv; see
    int8_conv_plain."""
    return torch.ops.lfd.int8_conv(
        x, wpack, mult, bias, int(kernel_size), int(stride), bool(relu),
        None if out_scale is None else float(out_scale), residual,
        None if residual_scale is None else float(residual_scale))


def launch_on(route, x, wpack, mult, bias, kernel_size, stride, relu=False, out_scale=None,
              residual=None, residual_scale=None):
    """K4's kernel of `route` on CUDA tensors, uncounted: int8_conv's launch,
    and a way to time one shape on two routes (the mma route takes every
    shape). A route that cannot take the shape raises."""
    n, h, w, cin = x.shape
    cout = wpack.shape[0]
    if cout not in COUTS:
        raise ValueError(f"int8_conv: K4 is built for Cout in {COUTS}, not {cout}")
    ho, wo = out_hw(h, w, kernel_size, stride)
    dev = x.device
    kernel_lib.check_cuda("int8_conv x", x, torch.int8, (n, h, w, cin), dev)
    kernel_lib.check_cuda("int8_conv weight", wpack, torch.int8,
                          (cout, packed_width(cin, kernel_size)), dev)
    kernel_lib.check_cuda("int8_conv mult", mult, torch.float32, (cout,), dev)
    kernel_lib.check_cuda("int8_conv bias", bias, torch.float32, (cout,), dev)
    res_kind, res_scale = 0, 0.0
    if residual is not None:
        res_kind = 1 if residual.dtype == torch.int8 else 2
        kernel_lib.check_cuda("int8_conv residual", residual,
                              torch.int8 if res_kind == 1 else torch.float32,
                              (n, ho, wo, cout), dev)
        if res_kind == 1:
            res_scale = float(np.float32(residual_scale))
    out_int8 = out_scale is not None
    inv = float(np.float32(1.0 / out_scale)) if out_int8 else 0.0
    out = torch.empty((n, ho, wo, cout), dtype=torch.int8 if out_int8 else torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        kernel_lib.launch(
            "lfd_int8_conv", x.data_ptr(), wpack.data_ptr(), mult.data_ptr(),
            bias.data_ptr(), None if residual is None else residual.data_ptr(), res_kind,
            res_scale, out.data_ptr(), int(out_int8), inv, int(relu), n, h, w, cin, cout,
            kernel_size, stride, ROUTES.index(route), kernel_lib.stream_of(x),
        )
    return out


int8_conv.launches = 0
int8_conv.routes = dict.fromkeys(ROUTES, 0)  # launches per route
