"""Plain reference of FCOS-R50-FPN, for the benchmark's checks.

Written from the published description: Tian et al., "FCOS: Fully
Convolutional One-Stage Object Detection" (ICCV 2019), as mmdetection's
`configs/fcos/fcos_r50_caffe_fpn_gn-head_1x_coco.py` sets it out (a caffe
ResNet-50 with every BatchNorm in eval mode, an FPN of 256 channels on 5
levels, two towers of four 3x3 convs of 256 with GroupNorm(32), 80 classes,
a centerness branch off the classification tower, per-level Scale then exp).
Plain PyTorch functions in float32 over a dict of named weights (the names
of the program's state_dict), with no kernels, no cache and no batching
tricks. It imports nothing of the program under test, and runs with TF32
off.

Parts:
  param_specs(cfg)       every weight's name, shape and how it is drawn;
  forward(w, cfg, x)     raw NHWC frames -> dense (cls (B, P, 80), reg (B, P, 4)
                         in pixels, ctr (B, P, 1));
  level_info(cfg, hw)    the point grid and its levels;
  decode(...)            one image's dense outputs -> final rows and the wider
                         candidate pool the row comparison matches in.

Where it departs from mmdetection (each where the program departs too):
  - frames are padded to a multiple of 128, the largest stride, as the
    program's predict API pads them (mmdetection pads to 32). Every level
    is then exactly half the one below it, so the FPN's nearest upsample
    by size is the plain 2x repeat;
  - points sit at (j * s, i * s), without mmdetection's half-stride offset
    (the LFD repository's FCOS, which the program ports);
  - the FPN applies the ReLU before both extra convs, P6 included
    (mmdetection's relu_before_extra_convs applies it before P7's only);
  - the regression's exp is clamped at 30 (exp(30) px is past any frame);
  - NMS runs per class by the class-offset trick, greedy, IoU > 0.5
    suppresses, areas without the +1, as mmcv's NMS.
A quantizer `quant` (a callable on tensors) may be passed to forward: each
conv's input and weight go through it first (the benchmark's control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .lfd import greedy_nms

BN_EPS = 1e-5
GN_EPS = 1e-5
STAGES = (3, 4, 6, 3)  # ResNet-50's bottlenecks a stage
EXPANSION = 4


# ------------------------------------------------------------------ structure

def taps(cfg):
    """The tapped (stage, block)s, stages from 1, sorted."""
    return sorted(tuple(t) for t in cfg["backbone"]["out_indices"])


def strides(cfg):
    return list(cfg["strides"])


def _conv(specs, name, cout, cin, k, kind="conv", bias=False):
    specs.append((f"{name}.weight", (cout, cin, k, k), kind))
    if bias:
        specs.append((f"{name}.bias", (cout,), kind + "_bias"))


def _bn(specs, name, c):
    specs += [(f"{name}.weight", (c,), "norm_weight"), (f"{name}.bias", (c,), "norm_bias"),
              (f"{name}.running_mean", (c,), "running_mean"),
              (f"{name}.running_var", (c,), "running_var"),
              (f"{name}.num_batches_tracked", (), "count")]


def _gn(specs, name, c):
    specs += [(f"{name}.weight", (c,), "norm_weight"), (f"{name}.bias", (c,), "norm_bias")]


def stage_plan(cfg):
    """[(stage, [(cin, planes, stride, downsample)])] up to the deepest tap."""
    base = cfg["backbone"]["base_channels"]
    last = max(s for s, _ in taps(cfg))
    cin, out = base, []
    for s in range(1, last + 1):
        planes = base * 2 ** (s - 1)
        blocks = []
        for j in range(STAGES[s - 1]):
            stride = 2 if (j == 0 and s > 1) else 1
            blocks.append((cin, planes, stride, j == 0))
            cin = planes * EXPANSION
        out.append((s, blocks))
    return out


def tap_channels(cfg):
    base = cfg["backbone"]["base_channels"]
    return [base * 2 ** (s - 1) * EXPANSION for s, _ in taps(cfg)]


def param_specs(cfg):
    """[(name, shape, kind)] of every weight and buffer, in the program's
    state_dict names. kinds: conv (backbone), neck_conv (+ neck_conv_bias),
    head_conv (the towers), cls_final / reg_final / ctr_final (+ _bias),
    norm_weight, norm_bias, running_mean, running_var, count, scale."""
    specs = []
    base = cfg["backbone"]["base_channels"]
    _conv(specs, "_backbone.conv1", base, 3, 7)
    _bn(specs, "_backbone.bn1", base)
    for s, blocks in stage_plan(cfg):
        for j, (cin, planes, _, down) in enumerate(blocks):
            p = f"_backbone.layer{s}.{j}"
            for k, (ci, co, ks) in enumerate(((cin, planes, 1), (planes, planes, 3),
                                              (planes, planes * EXPANSION, 1)), 1):
                _conv(specs, f"{p}.conv{k}", co, ci, ks)
                _bn(specs, f"{p}.bn{k}", co)
            if down:
                _conv(specs, f"{p}.downsample.0", planes * EXPANSION, cin, 1)
                _bn(specs, f"{p}.downsample.1", planes * EXPANSION)
    c = cfg["neck"]["channels"]
    for i, cin in enumerate(tap_channels(cfg)):
        _conv(specs, f"_neck.lateral{i}.0", c, cin, 1, "neck_conv", True)
    for i in range(cfg["neck"]["num_outputs"]):
        _conv(specs, f"_neck.fpn_out{i}", c, c, 3, "neck_conv", True)
    h = cfg["head"]
    for tower in ("_classification_path", "_regression_path"):
        for i in range(h["conv_layers"]):
            _conv(specs, f"_head.{tower}.{3 * i}", h["channels"], c if i == 0 else h["channels"],
                  3, "head_conv")
            _gn(specs, f"_head.{tower}.{3 * i + 1}", h["channels"])
    _conv(specs, "_head._classification", cfg["num_classes"], h["channels"], 3, "cls_final", True)
    _conv(specs, "_head._centerness", 1, h["channels"], 3, "ctr_final", True)
    _conv(specs, "_head._regression", 4, h["channels"], 3, "reg_final", True)
    for i in range(len(strides(cfg))):
        specs.append((f"_head._scales.{i}._scale", (), "scale"))
    return specs


def head_finals(cfg):
    """[(final conv name, the GroupNorm before it)] of the three outputs (a
    ReLU lies between them)."""
    last = 3 * (cfg["head"]["conv_layers"] - 1) + 1
    cls_gn = f"_head._classification_path.{last}"
    return [("_head._classification", cls_gn), ("_head._centerness", cls_gn),
            ("_head._regression", f"_head._regression_path.{last}")]


# ------------------------------------------------------------------- forward

def _conv2d(x, w, b=None, stride=1, quant=None):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride, w.shape[-1] // 2)


def _bn_act(x, w, name, relu=True):
    """BatchNorm on its running statistics (mmdetection's norm_eval), ReLU."""
    y = F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"], w[f"{name}.weight"],
                     w[f"{name}.bias"], False, 0.0, BN_EPS)
    return F.relu(y) if relu else y


def backbone(w, cfg, x, quant=None):
    """Caffe ResNet-50 (the stride on each bottleneck's first 1x1): the
    tapped blocks' outputs."""
    x = _bn_act(_conv2d(x, w["_backbone.conv1.weight"], stride=2, quant=quant), w, "_backbone.bn1")
    x = F.max_pool2d(x, 3, 2, 1)
    feats, tapped = [], set(taps(cfg))
    for s, blocks in stage_plan(cfg):
        for j, (_, _, stride, down) in enumerate(blocks):
            p = f"_backbone.layer{s}.{j}"
            out = _bn_act(_conv2d(x, w[f"{p}.conv1.weight"], stride=stride, quant=quant), w,
                      f"{p}.bn1")
            out = _bn_act(_conv2d(out, w[f"{p}.conv2.weight"], quant=quant), w, f"{p}.bn2")
            out = _bn_act(_conv2d(out, w[f"{p}.conv3.weight"], quant=quant), w, f"{p}.bn3",
                      relu=False)
            ident = (_bn_act(_conv2d(x, w[f"{p}.downsample.0.weight"], stride=stride, quant=quant),
                         w, f"{p}.downsample.1", relu=False) if down else x)
            x = F.relu(out + ident)
            if (s, j) in tapped:
                feats.append(x)
    return feats


def fpn(w, cfg, feats, quant=None):
    """Laterals, top-down nearest upsample adds, 3x3 outputs, then the extra
    stride-2 levels on the FPN's own output, a ReLU before each."""
    def conv(name, t, stride=1):
        return _conv2d(t, w[f"_neck.{name}.weight"], w[f"_neck.{name}.bias"], stride, quant)

    lat = [conv(f"lateral{i}.0", f) for i, f in enumerate(feats)]
    for i in range(len(lat) - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], size=lat[i - 1].shape[-2:],
                                                mode="nearest")
    outs = [conv(f"fpn_out{i}", t) for i, t in enumerate(lat)]
    for i in range(len(lat), cfg["neck"]["num_outputs"]):
        outs.append(conv(f"fpn_out{i}", F.relu(outs[-1]), 2))
    return outs


def head(w, cfg, feats, quant=None):
    """Per level (cls, reg in pixels, ctr) NCHW."""
    h = cfg["head"]

    def tower(t, name):
        for i in range(h["conv_layers"]):
            t = _conv2d(t, w[f"_head.{name}.{3 * i}.weight"], quant=quant)
            g = f"_head.{name}.{3 * i + 1}"
            t = F.relu(F.group_norm(t, h["norm_groups"], w[f"{g}.weight"], w[f"{g}.bias"],
                                    GN_EPS))
        return t

    def final(t, name):
        return _conv2d(t, w[f"_head.{name}.weight"], w[f"_head.{name}.bias"], quant=quant)

    out = []
    for lvl, f in enumerate(feats):
        c = tower(f, "_classification_path")
        r = final(tower(f, "_regression_path"), "_regression") * w[f"_head._scales.{lvl}._scale"]
        out.append((final(c, "_classification"), torch.exp(r.float().clamp(max=30.0)),
                    final(c, "_centerness")))
    return out


def flatten(levels):
    """Per-level NCHW maps -> (B, P, C), level-major, (y, x) row-major."""
    return torch.cat([t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, t.shape[1])
                      for t in levels], dim=1)


def normalize(frames, cfg):
    """Raw NHWC frames -> normalized NCHW float32: (x - mean*255) /
    (std*255), the caffe normalize (BGR kept, std 1) in the serve config's
    0-1 units."""
    s = cfg["serve"]
    x = frames.float()
    if s.get("bgr2rgb"):
        x = x.flip(-1)
    mean = torch.tensor(s["mean"], device=x.device) * 255.0
    std = torch.tensor(s["std"], device=x.device) * 255.0
    return ((x - mean) / std).permute(0, 3, 1, 2)


def forward(w, cfg, frames, quant=None, dtype=torch.float32):
    """Raw NHWC frames -> dense (cls, reg, ctr), each (B, P, C) float32.
    dtype: the net's activations (the weights `w` given in it); the
    normalize runs in float32 first, the regression's exp in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = normalize(frames, cfg).to(dtype)
    levels = head(w, cfg, fpn(w, cfg, backbone(w, cfg, x, quant), quant), quant)
    return tuple(flatten([lv[k] for lv in levels]).float() for k in range(3))


# --------------------------------------------------------------- point grid

def level_info(cfg, hw, device="cpu"):
    """points (P, 2) [x, y] = (j*s, i*s) and the per-level point counts."""
    pts, sizes = [], []
    for s in strides(cfg):
        h, w = -(-hw[0] // s), -(-hw[1] // s)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32) * s,
                                torch.arange(w, dtype=torch.float32) * s, indexing="ij")
        pts.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        sizes.append(h * w)
    return {"points": torch.cat(pts).to(device), "sizes": sizes}


# ------------------------------------------------------------- decode + NMS

def scores_of(cls_logits, ctr):
    """(P, C) class scores: sigmoid(cls) times the point's sigmoid(ctr)."""
    return torch.sigmoid(cls_logits) * torch.sigmoid(ctr)


def top_points(point_max, sizes, per_level):
    """The `per_level` points of highest score of each level (all of a
    level with fewer), in level order: indices into P."""
    out, at = [], 0
    for n in sizes:
        order = torch.argsort(point_max[at:at + n], descending=True, stable=True)
        out.append(order[:per_level] + at)
        at += n
    return torch.cat(out)


def candidates(cls_logits, reg, ctr, info, valid_hw, cfg, per_level, pairs_budget):
    """The (point, class) pairs above the threshold among each level's
    `per_level` points of highest score inside the valid extent, the top
    `pairs_budget` of them, with their boxes clamped to the extent.
    Returns (boxes xyxy, scores, labels)."""
    scores = scores_of(cls_logits, ctr)
    pts = info["points"]
    h, w = float(valid_hw[0]), float(valid_hw[1])
    inside = (pts[:, 0] < w) & (pts[:, 1] < h)
    point_max = torch.where(inside, scores.max(dim=-1).values, torch.zeros(()).to(scores))
    top = top_points(point_max, info["sizes"], per_level)
    s = torch.where(inside[top, None], scores[top], torch.zeros(()).to(scores))
    C = s.shape[1]
    flat = s.reshape(-1)
    thr = cfg["classification_threshold"]
    pairs = torch.argsort(torch.where(flat > thr, flat, torch.full_like(flat, -1.0)),
                          descending=True, stable=True)[:pairs_budget]
    pairs = pairs[flat[pairs] > thr]
    point = top[pairs // C]
    d, p = reg[point], pts[point]
    boxes = torch.stack([(p[:, 0] - d[:, 0]).clamp(min=0).clamp(max=w),
                         (p[:, 1] - d[:, 1]).clamp(min=0).clamp(max=h),
                         (p[:, 0] + d[:, 2]).clamp(min=0).clamp(max=w),
                         (p[:, 1] + d[:, 3]).clamp(min=0).clamp(max=h)], -1)
    return boxes, flat[pairs], pairs % C


def decode(cls_logits, reg, ctr, info, valid_hw, cfg, pool=4000):
    """One image's dense outputs -> (rows, pool):
    rows: the detector's result, a dict of boxes (K, 4) xyxy, scores (K,),
    labels (K,) with K <= post_nms_bbox_limit: candidates from each level's
    pre_nms_bbox_limit best points and the pre_nms_bbox_limit best pairs,
    per-class greedy NMS at nms_threshold, the best post_nms_bbox_limit;
    pool: the same candidate rule with `pool` points a level and pairs,
    before NMS, for matching served rows."""
    cls_logits, reg, ctr = cls_logits.float(), reg.float(), ctr.float()
    limit = cfg["pre_nms_bbox_limit"]
    boxes, scores, labels = candidates(cls_logits, reg, ctr, info, valid_hw, cfg, limit, limit)
    keep = greedy_nms(boxes, scores, labels, cfg["nms_threshold"])[:cfg["post_nms_bbox_limit"]]
    rows = dict(boxes=boxes[keep], scores=scores[keep], labels=labels[keep])
    if not pool:
        return rows, None
    pb, ps, pl = candidates(cls_logits, reg, ctr, info, valid_hw, cfg, pool, pool)
    return rows, dict(boxes=pb, scores=ps, labels=pl)
