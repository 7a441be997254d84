"""Seeded weights of Deformable DETR-R50, drawn on the device in two large
calls (one normal, one uniform).

The reference's param_specs (benchmark/reference/deformable_detr.py) name
every weight and say how it is drawn; the benchmark draws them here and
hands the same dict to the program and to the reference. mmdetection's
initializers, with the norms and BatchNorm statistics randomized so that the
BatchNorms, GroupNorms and LayerNorms are exercised, and a small seeded
weight where mmdetection starts at zero (with those at zero every query
would sample alike and the refinement move nothing, so a program that
skipped either would pass the check):
  conv              kaiming normal, fan out (the backbone)
  neck_conv         xavier uniform (mmdetection's ChannelMapper init)
  linear, cls       xavier uniform (the transformer's Linears; the heads')
  linear_bias       N(0, bias_std)
  offsets           N(0, offset_std); bias: mmcv's grid, head h's direction
                    (cos, sin)(2 pi h / heads) over its largest component,
                    times point + 1, on every level
  attn_weights      N(0, attn_std), bias N(0, attn_std)
  cls_bias          bias_init_with_prob(0.01) = -log(99)
  reg_final         N(0, reg_std), bias N(0, reg_std)
  level_embed       N(0, 1)
  norm_weight U(0.5, 1.5), norm_bias N(0, 0.1), running_mean U(-0.5, 0.5),
  running_var U(0.5, 1.5), count 0.
"""

from __future__ import annotations

import math

import torch

from . import weights
from ..reference import deformable_detr as ddetr

def _xavier(shape):
    fan_out, fan_in = shape[0], shape[1]
    field = math.prod(shape[2:])
    return math.sqrt(6.0 / ((fan_in + fan_out) * field))


_STD_KEY = {"linear_bias": "bias_std", "offsets": "offset_std", "attn_weights": "attn_std",
            "attn_weights_bias": "attn_std", "reg_final": "reg_std", "reg_final_bias": "reg_std"}


def _std(shape, kind, d):
    if kind == "conv":
        return math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
    if kind == "level_embed":
        return 1.0
    if kind == "norm_bias":
        return 0.1
    return d[_STD_KEY[kind]]


NORMAL = ("conv", "linear_bias", "offsets", "attn_weights", "attn_weights_bias", "reg_final",
          "reg_final_bias", "level_embed", "norm_bias")
XAVIER = ("neck_conv", "linear", "cls")


def offsets_grid(t):
    """mmcv's sampling_offsets bias: (heads * levels * points * 2,)."""
    nh, lv, pt = t["heads"], t["levels"], t["points"]
    thetas = torch.arange(nh, dtype=torch.float32) * (2.0 * math.pi / nh)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = (grid / grid.abs().max(-1, keepdim=True)[0]).view(nh, 1, 1, 2).repeat(1, lv, pt, 1)
    grid = grid * torch.arange(1, pt + 1, dtype=torch.float32)[None, None, :, None]
    return grid.reshape(-1)


def draw(cfg, seed, device):
    """{name: tensor} on `device`, float32 (long for the counts), from
    `seed`."""
    specs = ddetr.param_specs(cfg)
    d = cfg["weights"]
    g = weights.generator(seed, device)
    normal = [(n, s, k) for n, s, k in specs if k in NORMAL]
    uniform = [(n, s, k) for n, s, k in specs if k in weights.UNIFORM or k in XAVIER]
    z = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=g, device=device)
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=g, device=device)
    out, at = {}, 0
    for n, s, k in normal:
        size = math.prod(s)
        out[n] = (z[at:at + size] * _std(s, k, d)).reshape(s)
        at += size
    at = 0
    for n, s, k in uniform:
        size = math.prod(s)
        lo, hi = weights.UNIFORM[k] if k in weights.UNIFORM else (-_xavier(s), _xavier(s))
        out[n] = (lo + (hi - lo) * u[at:at + size]).reshape(s)
        at += size
    grid = offsets_grid(cfg["transformer"]).to(device)
    for n, s, k in specs:
        if k == "count":
            out[n] = torch.zeros(s, dtype=torch.long, device=device)
        elif k == "offsets_bias":
            out[n] = grid.clone()
        elif k == "cls_bias":
            out[n] = torch.full(s, -math.log(99.0), device=device)
    return out
