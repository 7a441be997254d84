# Multi-scale deformable attention's sampling (Zhu et al., "Deformable DETR",
# ICLR 2021; mmcv 1.x `multi_scale_deformable_attn_pytorch`): each query
# reads, per head, `points` bilinear samples on each of `levels` value maps
# at fractional locations it computed itself, and sums them with its own
# weights (a softmax over the head's levels x points, taken by the caller).
#
# ms_deform_attn is the one function every MSDA layer of the port calls
# (models/deformable_detr.py, through this module's attribute). It is the
# custom op `lfd::ms_deform_attn` (torch.library): its CPU kernel is the
# plain version, ms_deform_attn_plain; its CUDA kernel is K7
# (`lfdtpu_torch/csrc/msda.cu`), one launch that gathers, weights and sums
# each (query, head)'s samples in registers and reads the value map in place.
# For a CUDA tensor it launches K7 or raises.
#
# The plain version is plain torch: F.grid_sample (bilinear, zero padding,
# align_corners=False) per level. grid_sample takes the grid and the map in
# one dtype, and the locations must stay float32 (in bf16 a location on a
# 167-wide map is off by up to 0.65 cells), so a bf16 value map is sampled
# as a float32 copy and the result cast back.
#
# samples_taken() counts the samples taken in this process (queries x heads x
# levels x points a call, over the batch), whoever wraps the function: the
# engine turns it into the counter engine.msda_samples (deploy/runner.py).
# ms_deform_attn.launches counts K7's launches (engine.msda_kernel there).

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernel_lib

_SAMPLES = 0
HEAD_DIM = 32   # csrc/msda.cu: a head's channels, 8 lanes x 4
MAX_LEVELS = 8  # csrc/msda.cu: the levels' geometry a launch takes by value


def samples_taken():
    """The samples ms_deform_attn has taken in this process."""
    return _SAMPLES


def ms_deform_attn_plain(value, spatial_shapes, level_start, locations, weights):
    """The weighted sum of each query's bilinear samples: the plain version
    of K7.

    value: (B, S, heads, d), the levels' maps flattened (y, x) row-major and
      concatenated; spatial_shapes: the levels' (h, w), Python ints;
      level_start: each level's first row in S;
    locations: (B, Q, heads, levels, points, 2) float32 [x, y], the map's
      extent being [0, 1] (pixel centres at (i + 0.5) / size; a sample off
      the map reads zeros there);
    weights: (B, Q, heads, levels, points) float32.
    Returns (B, Q, heads * d) in value's dtype, head-major."""
    B, S, heads, d = value.shape
    Q, points = locations.shape[1], locations.shape[4]
    v = value.float()
    grids = 2.0 * locations - 1.0
    out = None
    for lvl, ((h, w), start) in enumerate(zip(spatial_shapes, level_start)):
        vl = v[:, start:start + h * w].permute(0, 2, 3, 1).reshape(B * heads, d, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * heads, Q, points, 2)
        sampled = F.grid_sample(vl, g, mode="bilinear", padding_mode="zeros",
                                align_corners=False)  # (B * heads, d, Q, points)
        wl = weights[:, :, :, lvl].transpose(1, 2).reshape(B * heads, 1, Q, points)
        part = (sampled * wl).sum(-1)
        out = part if out is None else out + part
    return out.reshape(B, heads * d, Q).transpose(1, 2).to(value.dtype)


def _levels(spatial_shapes):
    """The op's flat [h0, w0, h1, w1, ...] back to [(h, w)] pairs."""
    return list(zip(spatial_shapes[0::2], spatial_shapes[1::2]))


@torch.library.custom_op("lfd::ms_deform_attn", mutates_args=(), device_types="cpu")
def _msda_op(value: torch.Tensor, spatial_shapes: list[int], level_start: list[int],
             locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """K7's CPU kernel: the plain version, contiguous as K7's output is."""
    return ms_deform_attn_plain(value, _levels(spatial_shapes), level_start, locations,
                                weights).contiguous()


@_msda_op.register_kernel("cuda")
def _msda_cuda(value, spatial_shapes, level_start, locations, weights):
    """K7's CUDA kernel: one launch on the current stream."""
    B, S, heads, d = value.shape
    _, Q, _, levels, points, _ = locations.shape
    dev = value.device
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ms_deform_attn: K7 takes bf16 or float32 values, not {value.dtype}")
    if d != HEAD_DIM:
        raise ValueError(f"ms_deform_attn: K7 is built for heads of {HEAD_DIM} channels, not {d}")
    if levels > MAX_LEVELS:
        raise ValueError(f"ms_deform_attn: K7 takes up to {MAX_LEVELS} levels, not {levels}")
    f32 = torch.float32
    # K7 reads 4 channels of a tap at a time (8 bytes in bf16, 16 in float32),
    # a location as 8 bytes
    for name, t, dtype, shape, align in (
            ("value", value, value.dtype, (B, S, heads, d), 4 * value.element_size()),
            ("locations", locations, f32, (B, Q, heads, levels, points, 2), 8),
            ("weights", weights, f32, (B, Q, heads, levels, points), 4)):
        kernel_lib.check_cuda(f"ms_deform_attn {name}", t, dtype, shape, dev, align)
    out = torch.empty(B, Q, heads * d, dtype=value.dtype, device=dev)
    if B and Q:
        shapes = (ctypes.c_int * (2 * levels))(*spatial_shapes)
        starts = (ctypes.c_int * levels)(*level_start)
        with torch.cuda.device(dev):
            kernel_lib.launch("lfd_ms_deform_attn", value.data_ptr(), locations.data_ptr(),
                              weights.data_ptr(), out.data_ptr(), B, S, Q, heads, levels, points,
                              shapes, starts, int(value.dtype == f32), kernel_lib.stream_of(value))
        _WRAPPER.launches += 1
    return out


@_msda_op.register_fake
def _msda_fake(value, spatial_shapes, level_start, locations, weights):
    B, _, heads, d = value.shape
    return value.new_empty(B, locations.shape[1], heads * d)


def ms_deform_attn(value, spatial_shapes, level_start, locations, weights):
    """The weighted sum of each query's bilinear samples, the op
    lfd::ms_deform_attn: the plain version for CPU tensors, K7 for CUDA ones
    (bf16 or float32 values of 32 channels a head, up to MAX_LEVELS levels,
    contiguous, not requiring grad; anything else raises). Arguments and
    return as ms_deform_attn_plain's; the shapes are checked here, before
    dispatch."""
    global _SAMPLES
    if value.dim() != 4:
        raise ValueError(f"ms_deform_attn value: expected (B, S, heads, d), got "
                         f"{tuple(value.shape)}")
    B, S, heads, _ = value.shape
    levels = len(spatial_shapes)
    if (locations.dim() != 6 or locations.shape[0] != B or locations.shape[2] != heads
            or locations.shape[3] != levels or locations.shape[5] != 2):
        raise ValueError(f"ms_deform_attn locations: expected ({B}, Q, {heads}, {levels}, "
                         f"points, 2), got {tuple(locations.shape)}")
    if tuple(weights.shape) != tuple(locations.shape[:5]):
        raise ValueError(f"ms_deform_attn weights: expected {tuple(locations.shape[:5])}, got "
                         f"{tuple(weights.shape)}")
    for name, t in (("locations", locations), ("weights", weights)):
        if t.dtype != torch.float32:
            raise ValueError(f"ms_deform_attn {name}: expected float32, got {t.dtype}")
    shapes = [int(v) for hw in spatial_shapes for v in hw]
    starts = [int(v) for v in level_start]
    if len(starts) != levels or any(
            h <= 0 or w <= 0 or s < 0 or s + h * w > S
            for (h, w), s in zip(_levels(shapes), starts)):
        raise ValueError(f"ms_deform_attn: levels {list(spatial_shapes)} starting at "
                         f"{list(level_start)} do not lie in the value's {S} tokens")
    if value.is_cuda and any(t.requires_grad for t in (value, locations, weights)):
        raise ValueError("ms_deform_attn: K7 has no backward; the port serves Deformable DETR "
                         "and never trains it (call it under torch.no_grad)")
    _SAMPLES += B * locations.shape[1] * heads * levels * locations.shape[4]
    return torch.ops.lfd.ms_deform_attn(value, shapes, starts, locations, weights)


ms_deform_attn.launches = 0
# the wrapper whose count K7 ticks, also while the module's attribute is
# replaced (a recorder of the calls, a planted fault): the counter is this
# object's, not the attribute's
_WRAPPER = ms_deform_attn
