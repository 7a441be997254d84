"""Seeded weights, drawn on the device in two large calls.

The reference's param_specs name every weight and say how it is drawn; the
benchmark draws them here and hands the same dict to the program and to the
reference. Draws (the detector's published initializers, with the norms,
statistics and Scales randomized so that the folded BatchNorms and the Scales
are exercised, and the classifier and regressor widened so that rows spread
in score and size):
  conv        kaiming normal, fan out          norm_weight  U(0.5, 1.5)
  head_conv   N(0, 0.01)                       norm_bias    N(0, 0.1)
  cls_final   N(0, cls_std)                    running_mean U(-0.5, 0.5)
  reg_final   N(0, reg_std), bias 0            running_var  U(0.5, 1.5)
  scale       U(0.5, 1.5)                      count        0
Each head output's bias is then set so that its logits centre on 0: its
input is ReLU(GroupNorm(.)), whose mean per channel is a phi(b/a) + b Phi(b/a)
for the norm's scale a and shift b, so the bias is minus the weights' sum
over those means. Last, the classifier's foreground logits are shifted by
one number (its bias, or the background column's with a softmax over C + 1)
so that `share_above` of the points of a seeded frame of `calibration_hw`,
of the kind the cell serves (see frames), score above the classification
threshold: every seed's frames then yield about as many candidate rows,
whatever the spread its weights give the logits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NORMAL = ("conv", "head_conv", "cls_final", "norm_bias")
UNIFORM = {"norm_weight": (0.5, 1.5), "running_mean": (-0.5, 0.5), "running_var": (0.5, 1.5),
           "scale": (0.5, 1.5)}


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def frames(g, n, hw, device, look=None):
    """n uint8 frames (n, h, w, 3) on `device` from generator g. look None:
    uniform noise. look {blob_px, grain}: a field of blobs (uniform values on
    a grid of blob_px cells, bilinear between them) with uniform grain of
    +-grain on top, a scene that neighbouring points of the detector see
    alike, so that its candidates come in overlapping clusters, as on real
    images, and NMS has work."""
    h, w = hw
    if look is None:
        return torch.randint(0, 256, (n, h, w, 3), generator=g, device=device, dtype=torch.uint8)
    cell = look["blob_px"]
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(n):  # one frame's floats at a time: set-up's peak stays small
        coarse = 255.0 * torch.rand((1, 3, -(-h // cell) + 1, -(-w // cell) + 1), generator=g,
                                    device=device)
        field = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        grain = (2.0 * torch.rand((1, 3, h, w), generator=g, device=device) - 1.0) * look["grain"]
        out[i] = (field + grain).clamp(0, 255).round().to(torch.uint8)[0].permute(1, 2, 0)
    return out


def _std(name, shape, kind, draw):
    if kind == "conv":
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if kind == "head_conv":
        return draw["reg_std"] if "_regression_path" in name and shape[0] == 4 else 0.01
    if kind == "cls_final":
        return draw["cls_std"]
    return 0.1  # norm_bias


def draw(specs, seed, device, draw_cfg, look=None):
    """{name: tensor} on `device`, float32 (the master weights the engine
    casts and the train step keeps), from `seed`; calibrated on a frame of
    `look` (see frames)."""
    g = generator(seed, device)
    normal = [(n, s, k) for n, s, k in specs if k in NORMAL]
    uniform = [(n, s, k) for n, s, k in specs if k in UNIFORM]
    z = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=g, device=device)
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=g, device=device)
    out, at = {}, 0
    for n, s, k in normal:
        size = math.prod(s)
        out[n] = (z[at:at + size] * _std(n, s, k, draw_cfg)).reshape(s)
        at += size
    at = 0
    for n, s, k in uniform:
        size = math.prod(s)
        lo, hi = UNIFORM[k]
        out[n] = (lo + (hi - lo) * u[at:at + size]).reshape(s)
        at += size
    for n, s, k in specs:
        if k == "count":
            out[n] = torch.zeros(s, dtype=torch.long, device=device)
        elif k.endswith("_bias") and n not in out:
            out[n] = torch.zeros(s, device=device)
    _centre_heads(out, draw_cfg["_config"])
    _calibrate(out, draw_cfg["_config"], draw_cfg, seed, device, look)
    return out


def _relu_mean(a, b):
    """E[relu(a z + b)] for z ~ N(0, 1), elementwise."""
    r = b / a
    pdf = torch.exp(-0.5 * r * r) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1 + torch.erf(r / math.sqrt(2)))
    return a * pdf + b * cdf


def _centre_heads(w, cfg):
    from ..reference.lfd import head_finals

    for final, gn in head_finals(cfg):
        mu = _relu_mean(w[f"{gn}.weight"], w[f"{gn}.bias"])
        w[f"{final}.bias"] = -(w[f"{final}.weight"][:, :, 0, 0] @ mu)


def _calibrate(w, cfg, draw_cfg, seed, device, look):
    """Shift the foreground logits so that draw_cfg["share_above"] of a
    seeded frame's points score above the threshold (bisection)."""
    from ..reference import lfd

    g = generator(seed + 3, device)
    frame = frames(g, 1, draw_cfg["calibration_hw"], device, look)
    with torch.no_grad():
        logits = lfd.forward(w, cfg, frame)[0][0]
    C, thr = cfg["num_classes"], cfg["classification_threshold"]

    def share(b):
        shifted = torch.cat([logits[:, :C] + b, logits[:, C:]], dim=1)
        return float((lfd.scores_of(shifted, cfg).max(dim=1).values > thr).float().mean())

    lo, hi = -40.0, 40.0
    for _ in range(40):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if share(mid) < draw_cfg["share_above"] else (lo, mid)
    final = lfd.head_finals(cfg)[0][0]
    bias = w[f"{final}.bias"].clone()
    bias[:C] += hi
    w[f"{final}.bias"] = bias
