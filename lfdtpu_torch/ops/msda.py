# Multi-scale deformable attention's sampling (Zhu et al., "Deformable DETR",
# ICLR 2021; mmcv 1.x `multi_scale_deformable_attn_pytorch`): each query
# reads, per head, `points` bilinear samples on each of `levels` value maps
# at fractional locations it computed itself, and sums them with its own
# weights (a softmax over the head's levels x points, taken by the caller).
#
# ms_deform_attn is the one function every MSDA layer of the port calls
# (models/deformable_detr.py, through this module's attribute, so that a
# later kernel replaces this function and nothing else). This version is
# plain torch: F.grid_sample (bilinear, zero padding, align_corners=False)
# per level. grid_sample takes the grid and the map in one dtype, and the
# locations must stay float32 (in bf16 a location on a 167-wide map is off
# by up to 0.65 cells), so a bf16 value map is sampled as a float32 copy and
# the result cast back.
#
# samples_taken() counts the samples taken in this process (queries x heads x
# levels x points a call, over the batch), whoever wraps the function: the
# engine turns it into the counter engine.msda_samples (deploy/runner.py).

from __future__ import annotations

import torch.nn.functional as F

_SAMPLES = 0


def samples_taken():
    """The samples ms_deform_attn has taken in this process."""
    return _SAMPLES


def ms_deform_attn(value, spatial_shapes, level_start, locations, weights):
    """The weighted sum of each query's bilinear samples.

    value: (B, S, heads, d), the levels' maps flattened (y, x) row-major and
      concatenated; spatial_shapes: the levels' (h, w), Python ints;
      level_start: each level's first row in S;
    locations: (B, Q, heads, levels, points, 2) float32 [x, y], the map's
      extent being [0, 1] (pixel centres at (i + 0.5) / size; a sample off
      the map reads zeros there);
    weights: (B, Q, heads, levels, points) float32.
    Returns (B, Q, heads * d) in value's dtype, head-major."""
    global _SAMPLES
    B, S, heads, d = value.shape
    _, Q, _, levels, points, _ = locations.shape
    _SAMPLES += B * Q * heads * levels * points
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
