"""Seeded weights of FCOS-R50-FPN, drawn on the device in two large calls.

The reference's param_specs (benchmark/reference/fcos.py) name every weight
and say how it is drawn; the benchmark draws them here and hands the same
dict to the program and to the reference. Draws (FCOS's initializers, with
the norms, statistics, biases and Scales randomized so that the folded
BatchNorms, the GroupNorm affines and the Scales are exercised):
  conv        kaiming normal, fan out          norm_weight  U(0.5, 1.5)
  neck_conv   kaiming normal, fan out          norm_bias    N(0, 0.1)
  neck bias   N(0, 0.1)                        running_mean U(-0.5, 0.5)
  head_conv   N(0, 0.01)                       running_var  U(0.5, 1.5)
  cls_final   N(0, cls_std)                    count        0
  ctr_final   N(0, ctr_std)                    scale        U(0.5, 1.5)
  reg_final   N(0, reg_std)
Each final conv's bias is then set so that its outputs centre on a chosen
value: its input is ReLU(GroupNorm(.)), whose mean per channel is
a phi(b/a) + b Phi(b/a) for the norm's scale a and shift b, so the bias is
minus the weights' sum (over taps and channels) against those means, plus
ctr_bias for the centerness and log(reg_px) for the regression (a Scale s
then makes the level's typical distance reg_px ** s pixels). Last, the
classification bias is shifted by one number so that a seeded frame of
`calibration_hw`, of the look the cell serves, yields `candidates`
(point, class) pairs above the threshold among each level's
pre_nms_bbox_limit best points: the NMS budget is then filled on every
seed, whatever spread its weights give the logits, as it is on a real
scene with many objects.
"""

from __future__ import annotations

import math

import torch

from . import weights
from ..reference import fcos

NORMAL = ("conv", "neck_conv", "neck_conv_bias", "head_conv", "cls_final", "ctr_final",
          "reg_final", "norm_bias")


def _std(shape, kind, draw):
    if kind in ("conv", "neck_conv"):
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if kind == "head_conv":
        return 0.01
    if kind in ("cls_final", "ctr_final", "reg_final"):
        return draw[kind.split("_")[0] + "_std"]
    return 0.1  # norm_bias, neck_conv_bias


def draw(cfg, seed, device, look=None):
    """{name: tensor} on `device`, float32, from `seed`; calibrated on a
    frame of `look` (weights.frames)."""
    specs = fcos.param_specs(cfg)
    d = cfg["weights"]
    g = weights.generator(seed, device)
    normal = [(n, s, k) for n, s, k in specs if k in NORMAL]
    uniform = [(n, s, k) for n, s, k in specs if k in weights.UNIFORM]
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
        lo, hi = weights.UNIFORM[k]
        out[n] = (lo + (hi - lo) * u[at:at + size]).reshape(s)
        at += size
    for n, s, k in specs:
        if k == "count":
            out[n] = torch.zeros(s, dtype=torch.long, device=device)
    _centre_heads(out, cfg)
    calibrate(out, cfg, seed, device, look)
    return out


def _centre_heads(w, cfg):
    d = cfg["weights"]
    shift = {"_head._classification": 0.0, "_head._centerness": d["ctr_bias"],
             "_head._regression": math.log(d["reg_px"])}
    for final, gn in fcos.head_finals(cfg):
        mu = weights._relu_mean(w[f"{gn}.weight"], w[f"{gn}.bias"])
        w[f"{final}.bias"] = shift[final] - w[f"{final}.weight"].sum(dim=(2, 3)) @ mu


def candidate_count(cls_logits, ctr, info, cfg, shift):
    """The (point, class) pairs above the threshold among each level's
    pre_nms_bbox_limit best points, with the classifier's logits shifted."""
    scores = fcos.scores_of(cls_logits + shift, ctr)
    top = fcos.top_points(scores.max(dim=-1).values, info["sizes"], cfg["pre_nms_bbox_limit"])
    return int((scores[top] > cfg["classification_threshold"]).sum())


def calibrate(w, cfg, seed, device, look):
    """Shift the classification bias so that a seeded frame gives about
    cfg["weights"]["candidates"] candidate pairs (bisection)."""
    d = cfg["weights"]
    hw = d["calibration_hw"]
    g = weights.generator(seed + 3, device)
    frame = weights.frames(g, 1, hw, device, look)
    pad = [-(-v // cfg["pad_to"]) * cfg["pad_to"] for v in hw]
    x = torch.zeros((1, *pad, 3), dtype=torch.uint8, device=device)
    x[0, :hw[0], :hw[1]] = frame[0]
    info = fcos.level_info(cfg, pad, device)
    with torch.no_grad():
        cls_logits, _, ctr = (t[0] for t in fcos.forward(w, cfg, x))
    inside = (info["points"][:, 0] < hw[1]) & (info["points"][:, 1] < hw[0])
    cls_logits = torch.where(inside[:, None], cls_logits, torch.full_like(cls_logits, -1e4))
    lo, hi = -40.0, 40.0
    for _ in range(40):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if candidate_count(cls_logits, ctr, info, cfg, mid) < \
            d["candidates"] else (lo, mid)
    bias = w["_head._classification.bias"].clone()
    w["_head._classification.bias"] = bias + hi
