"""Plain reference of the LFD detector family, for the benchmark's checks.

Written from the published description of LFD (github.com/YonghaoHe/
LFD-A-Light-and-Fast-Detector, `lfd/model/lfd.py`, `lfd_resnet.py`,
`simple_neck.py`, `lfd_head.py`, `losses/`): plain PyTorch functions in
float32 over a dict of named weights, with no kernels, no cache and no
batching tricks. It imports nothing of the program under test.

Parts:
  param_specs(cfg)       every weight's upstream state_dict name, shape and
                         how it is drawn (the benchmark draws them);
  forward(w, cfg, x)     raw NHWC frames -> dense (cls (B, P, Cc), reg (B, P, 4));
  level_info(cfg, hw)    the point grid, strides and ranges of every level;
  decode(...)            one image's dense outputs -> final rows and the
                         wider candidate pool the row comparison matches in;
  assign, loss           the training targets and the focal / CE + IoU loss.

A quantizer `quant` (a callable on tensors) may be passed to forward: each
conv's input and weight go through it first. The benchmark's control uses it
to compute the reference in fp8.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
GN_EPS = 1e-5


# ------------------------------------------------------------------ structure

def stem_plan(mode, channels):
    """[(out channels, kernel, stride)] of the stem's conv + BN + ReLU units
    (`lfd_resnet.py`: 'fast' halves once, 'faster' twice)."""
    if mode == "fast":
        return [(channels, 3, 2), (channels, 1, 1)]
    if mode == "faster":
        return [(channels, 3, 2), (channels, 1, 1), (channels, 3, 2), (channels, 1, 1)]
    raise ValueError(f"stem mode {mode}")


def block_convs(block, cin, cout, stride):
    """[(cin, cout, kernel, stride)] of a residual block's main path."""
    if block == "faster":
        return [(cin, cout, 3, stride), (cout, cout, 3, 1)]
    if block == "fast":
        return [(cin, cout, 3, stride), (cout, cout, 1, 1), (cout, cout, 3, 1)]
    raise ValueError(f"block {block}")


def body(cfg):
    """The stages as a list of lists of (cin, cout, stride, downsample),
    trimmed to the deepest tapped stage, and the tapped (stage, block)s."""
    bb = cfg["backbone"]
    taps = sorted(tuple(t) for t in bb["out_indices"])
    last = max(s for s, _ in taps)
    cin = bb["stem_channels"]
    stages = []
    for n, ch in list(zip(bb["arch"], bb["channels"]))[:last + 1]:
        blocks = []
        for j in range(n):
            blocks.append((cin, ch, 2 if j == 0 else 1, j == 0))
            cin = ch
        stages.append(blocks)
    return stages, taps


def strides(cfg):
    """The output stride of every tapped level."""
    bb = cfg["backbone"]
    stem = 2 if bb["stem"] == "fast" else 4
    _, taps = body(cfg)
    return [stem * 2 ** (s + 1) for s, _ in taps]


def tap_channels(cfg):
    stages, taps = body(cfg)
    return [stages[s][b][1] for s, b in taps]


def cls_channels(cfg):
    extra = cfg["classification_loss"]["type"] == "CrossEntropyLoss"
    return cfg["num_classes"] + (1 if extra else 0)


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


def _head_trunk(specs, prefix, cin, cfg):
    """conv 1x1 + GroupNorm + ReLU, num_conv_layers times (Sequential
    indices 0, 1, 2, 3, 4, 5, ...); returns the next free index."""
    h = cfg["head"]
    for i in range(h["conv_layers"]):
        _conv(specs, f"{prefix}.{3 * i}", h["channels"], cin if i == 0 else h["channels"], 1,
              "head_conv")
        _gn(specs, f"{prefix}.{3 * i + 1}", h["channels"])
    return 3 * h["conv_layers"]


def param_specs(cfg):
    """[(name, shape, kind)] of every weight and buffer, in the upstream
    state_dict's names. The head is shared by every level, so only level
    0's names are listed (`_head.head0_*`); the program's own state_dict
    repeats them for every level."""
    specs = []
    bb = cfg["backbone"]
    cin, idx = 3, 0
    for ch, k, s in stem_plan(bb["stem"], bb["stem_channels"]):
        _conv(specs, f"_backbone._stem.{idx}", ch, cin, k)
        _bn(specs, f"_backbone._stem.{idx + 1}", ch)
        cin, idx = ch, idx + 3
    stages, _ = body(cfg)
    for i, blocks in enumerate(stages):
        for j, (bcin, bcout, stride, down) in enumerate(blocks):
            base = f"_backbone.stage{i}.{j}"
            for n, (ci, co, k, _) in enumerate(block_convs(bb["block"], bcin, bcout, stride), 1):
                _conv(specs, f"{base}._conv{n}", co, ci, k)
                _bn(specs, f"{base}._norm{n}", co)
            if down:
                _conv(specs, f"{base}._downsample.0", bcout, bcin, 1)
                _bn(specs, f"{base}._downsample.1", bcout)
    neck = cfg["neck_channels"]
    for i, c in enumerate(tap_channels(cfg)):
        _conv(specs, f"_neck.neck{i}.0", neck, c, 1)
        _bn(specs, f"_neck.neck{i}.1", neck)
    h = cfg["head"]
    cc = cls_channels(cfg)
    if h["merge_path"]:
        _head_trunk(specs, "_head.head0_merge_path", neck, cfg)
        _conv(specs, "_head.head0_classification_path.0", cc, h["channels"], 1, "cls_final",
              True)
        _conv(specs, "_head.head0_regression_path.0", 4, h["channels"], 1, "head_conv", True)
    else:
        n = _head_trunk(specs, "_head.head0_classification_path", neck, cfg)
        _conv(specs, f"_head.head0_classification_path.{n}", cc, h["channels"], 1,
              "cls_final", True)
        n = _head_trunk(specs, "_head.head0_regression_path", neck, cfg)
        _conv(specs, f"_head.head0_regression_path.{n}", 4, h["channels"], 1, "head_conv", True)
    for i in range(len(strides(cfg))):
        specs.append((f"_head._scales.{i}._scale", (), "scale"))
    return specs


def head_finals(cfg):
    """[(final conv name, the GroupNorm before it)] of the shared head's
    classification and regression outputs (a ReLU lies between them)."""
    h = cfg["head"]
    last = 3 * (h["conv_layers"] - 1) + 1
    if h["merge_path"]:
        gn = f"_head.head0_merge_path.{last}"
        return [("_head.head0_classification_path.0", gn), ("_head.head0_regression_path.0", gn)]
    n = 3 * h["conv_layers"]
    return [(f"_head.head0_{p}_path.{n}", f"_head.head0_{p}_path.{last}")
            for p in ("classification", "regression")]


def shared_names(cfg, name):
    """The program's names for weight `name`: every level's copy of a
    shared head weight, else the name itself."""
    if name.startswith("_head.head0_"):
        return [name.replace("head0_", f"head{k}_", 1) for k in range(len(strides(cfg)))]
    return [name]


# ------------------------------------------------------------------- forward

def _conv2d(x, w, stride, quant):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, None, stride, w.shape[-1] // 2)


def _bn_act(x, w, name, train, relu=True):
    """BatchNorm (eval: running statistics; train: the batch's moments) and
    ReLU."""
    if train:
        y = F.batch_norm(x, None, None, w[f"{name}.weight"], w[f"{name}.bias"], True, 0.0,
                         BN_EPS)
    else:
        y = F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"],
                         w[f"{name}.weight"], w[f"{name}.bias"], False, 0.0, BN_EPS)
    return F.relu(y) if relu else y


def _gn_act(x, w, name, groups):
    return F.relu(F.group_norm(x, groups, w[f"{name}.weight"], w[f"{name}.bias"], GN_EPS))


def dense_net(w, cfg, x, train=False, quant=None):
    """Normalized NCHW float32 input -> per-level (cls, reg) NCHW lists.
    train: BatchNorm on the batch's own moments (no running update)."""
    bb = cfg["backbone"]
    idx = 0
    for ch, k, s in stem_plan(bb["stem"], bb["stem_channels"]):
        x = _bn_act(_conv2d(x, w[f"_backbone._stem.{idx}.weight"], s, quant), w,
                    f"_backbone._stem.{idx + 1}", train)
        idx += 3
    stages, taps = body(cfg)
    feats = []
    for i, blocks in enumerate(stages):
        for j, (bcin, bcout, stride, down) in enumerate(blocks):
            base = f"_backbone.stage{i}.{j}"
            convs = block_convs(bb["block"], bcin, bcout, stride)
            out = x
            for n, (_, _, _, s) in enumerate(convs, 1):
                out = _conv2d(out, w[f"{base}._conv{n}.weight"], s, quant)
                out = _bn_act(out, w, f"{base}._norm{n}", train, relu=n < len(convs))
            if down:
                ident = _bn_act(_conv2d(x, w[f"{base}._downsample.0.weight"], stride, quant),
                                w, f"{base}._downsample.1", train, relu=False)
            else:
                ident = x
            x = F.relu(out + ident)
            if (i, j) in taps:
                feats.append(x)
    feats = [_bn_act(_conv2d(f, w[f"_neck.neck{i}.0.weight"], 1, quant), w, f"_neck.neck{i}.1",
                     train) for i, f in enumerate(feats)]
    h = cfg["head"]
    groups = h["norm_groups"]

    def trunk(t, prefix):
        for i in range(h["conv_layers"]):
            t = _gn_act(_conv2d(t, w[f"{prefix}.{3 * i}.weight"], 1, quant), w,
                        f"{prefix}.{3 * i + 1}", groups)
        return t

    def final(t, name):
        return _conv2d(t, w[f"{name}.weight"], 1, quant) + w[f"{name}.bias"][None, :, None, None]

    n = 3 * h["conv_layers"]
    cls_out, reg_out = [], []
    for lvl, f in enumerate(feats):
        if h["merge_path"]:
            t = trunk(f, "_head.head0_merge_path")
            c = final(t, "_head.head0_classification_path.0")
            r = final(t, "_head.head0_regression_path.0")
        else:
            c = final(trunk(f, "_head.head0_classification_path"),
                      f"_head.head0_classification_path.{n}")
            r = final(trunk(f, "_head.head0_regression_path"),
                      f"_head.head0_regression_path.{n}")
        cls_out.append(c)
        reg_out.append(r * w[f"_head._scales.{lvl}._scale"])
    return cls_out, reg_out


def flatten(levels):
    """Per-level NCHW maps -> (B, P, C), level-major, (y, x) row-major."""
    return torch.cat([t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, t.shape[1])
                      for t in levels], dim=1)


def normalize(frames, cfg):
    """Raw NHWC frames (uint8 or float pixels) -> normalized NCHW float32,
    as the served configuration's device normalize: (x - mean*255) /
    (std*255), channels flipped first when it swaps BGR to RGB."""
    s = cfg["serve"]
    x = frames.float()
    if s.get("bgr2rgb"):
        x = x.flip(-1)
    mean = torch.tensor(s["mean"], device=x.device) * 255.0
    std = torch.tensor(s["std"], device=x.device) * 255.0
    return ((x - mean) / std).permute(0, 3, 1, 2)


def forward(w, cfg, frames, train=False, quant=None, dtype=torch.float32):
    """Raw NHWC frames -> dense (cls (B, P, Cc), reg (B, P, 4)) float32.
    dtype: the net's activations (the weights `w` given in it); the
    normalize runs in float32 first and the outputs come back float32."""
    c, r = dense_net(w, cfg, normalize(frames, cfg).to(dtype), train, quant)
    return flatten(c).float(), flatten(r).float()


# --------------------------------------------------------------- point grid

def level_info(cfg, hw, device="cpu"):
    """points (P, 2) [x, y] = (j*s, i*s) with no half-stride offset,
    per-point strides (P,), ranges (P, 2) and gray ranges (P, 2)."""
    lo_f, up_f = min(cfg["gray_range_factors"]), max(cfg["gray_range_factors"])
    pts, st, rr, gr = [], [], [], []
    for s, (lo, up) in zip(strides(cfg), cfg["regression_ranges"]):
        h, w = -(-hw[0] // s), -(-hw[1] // s)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32) * s,
                                torch.arange(w, dtype=torch.float32) * s, indexing="ij")
        pts.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        n = h * w
        st.append(torch.full((n,), float(s)))
        rr.append(torch.tensor([[lo, up]], dtype=torch.float32).expand(n, 2))
        gr.append(torch.tensor([[int(lo * lo_f), int(up * up_f)]], dtype=torch.float32)
                  .expand(n, 2))
    return {k: torch.cat(v).to(device) for k, v in
            (("points", pts), ("strides", st), ("ranges", rr), ("gray_ranges", gr))}


def distances(reg, ranges, cfg):
    """Regression outputs -> (l, t, r, b) pixel distances."""
    if cfg["distance_to_bbox_mode"] == "sigmoid":
        return torch.sigmoid(reg) * ranges.max(dim=-1, keepdim=True).values
    return torch.exp(reg.clamp(max=30.0))


def scores_of(cls_logits, cfg):
    """(P, C) class scores: sigmoid, or the foreground columns of a softmax
    over C + 1 with CrossEntropyLoss."""
    if cfg["classification_loss"]["type"] == "CrossEntropyLoss":
        return torch.softmax(cls_logits, dim=-1)[:, :cfg["num_classes"]]
    return torch.sigmoid(cls_logits)


# ------------------------------------------------------------- decode + NMS

def iou_matrix(a, b):
    """(m, n) IoU of xyxy boxes, areas without the +1."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-6)


def greedy_nms(boxes, scores, labels, thr):
    """Per-class greedy NMS: in descending score order keep a box unless a
    kept box of its class overlaps it by IoU > thr. Returns kept indices
    in descending score order."""
    order = torch.argsort(scores, descending=True, stable=True)
    iou = iou_matrix(boxes[order], boxes[order]).cpu().numpy()
    same = (labels[order][:, None] == labels[order][None, :]).cpu().numpy()
    suppressed = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= (iou[i] > thr) & same[i]
    return order[torch.as_tensor(keep, dtype=torch.long, device=order.device)]


def candidates(cls_logits, reg, info, valid_hw, cfg, points_budget, pairs_budget):
    """The (point, class) pairs above the threshold among the
    `points_budget` points of highest class score inside the valid extent,
    the top `pairs_budget` of them, with their boxes clamped to the extent.
    Returns (boxes xyxy, scores, labels)."""
    scores = scores_of(cls_logits, cfg)
    pts = info["points"]
    h, w = float(valid_hw[0]), float(valid_hw[1])
    inside = (pts[:, 0] < w) & (pts[:, 1] < h)
    point_max = torch.where(inside, scores.max(dim=-1).values, torch.zeros(()).to(scores))
    top = torch.argsort(point_max, descending=True, stable=True)[:points_budget]
    s = torch.where(inside[top, None], scores[top], torch.zeros(()).to(scores))
    C = s.shape[1]
    flat = s.reshape(-1)
    pairs = torch.argsort(torch.where(flat > cfg["classification_threshold"], flat,
                                      torch.full_like(flat, -1.0)),
                          descending=True, stable=True)[:pairs_budget]
    pairs = pairs[flat[pairs] > cfg["classification_threshold"]]
    point = top[pairs // C]
    dist = distances(reg[point], info["ranges"][point], cfg)
    p = pts[point]
    boxes = torch.stack([(p[:, 0] - dist[:, 0]).clamp(min=0).clamp(max=w),
                         (p[:, 1] - dist[:, 1]).clamp(min=0).clamp(max=h),
                         (p[:, 0] + dist[:, 2]).clamp(min=0).clamp(max=w),
                         (p[:, 1] + dist[:, 3]).clamp(min=0).clamp(max=h)], -1)
    return boxes, flat[pairs], pairs % C


def decode(cls_logits, reg, info, valid_hw, cfg, pool=4000):
    """One image's dense outputs -> (rows, pool):
    rows: the detector's result, a dict of boxes (K, 4) xyxy, scores (K,),
    labels (K,) with K <= post_nms_bbox_limit: candidates from the
    pre_nms_bbox_limit best points and pairs, per-class greedy NMS at
    nms_threshold, the best post_nms_bbox_limit kept;
    pool: the same candidate rule with `pool` points and pairs, before NMS:
    every box the detector could have emitted, for matching served rows."""
    cls_logits, reg = cls_logits.float(), reg.float()
    limit = cfg["pre_nms_bbox_limit"]
    boxes, scores, labels = candidates(cls_logits, reg, info, valid_hw, cfg, limit, limit)
    keep = greedy_nms(boxes, scores, labels, cfg["nms_threshold"])[:cfg["post_nms_bbox_limit"]]
    rows = dict(boxes=boxes[keep], scores=scores[keep], labels=labels[keep])
    if not pool:
        return rows, None
    pb, ps, pl = candidates(cls_logits, reg, info, valid_hw, cfg, pool, pool)
    return rows, dict(boxes=pb, scores=ps, labels=pl)


# ---------------------------------------------------------------- training

def assign(info, gt_xywh, gt_labels, gt_mask, cfg):
    """LFD's targets for one image (`lfd.py:155-259`). gt_xywh (N, 4) with
    inclusive extents (x2 = x + w - 1), gt_mask (N,) bool.
    Returns cls targets (P, C): per class the largest center score of a GT
    whose measure falls in the point's range, -1 where a GT falls in the
    point's gray band; reg targets (P, 4): (l, t, r, b) to the GT of the
    highest score at the point (the first on ties), zero where none."""
    pts, st = info["points"], info["strides"]
    gt = gt_xywh[gt_mask]
    lab = gt_labels[gt_mask].long()
    P, C = pts.shape[0], cfg["num_classes"]
    cls_t = torch.zeros(P, C, device=pts.device)
    if gt.shape[0] == 0:
        return cls_t, torch.zeros(P, 4, device=pts.device)
    x1, y1 = gt[:, 0], gt[:, 1]
    x2, y2 = gt[:, 0] + gt[:, 2] - 1.0, gt[:, 1] + gt[:, 3] - 1.0
    l = pts[:, 0:1] - x1
    t = pts[:, 1:2] - y1
    r = x2 - pts[:, 0:1]
    b = y2 - pts[:, 1:2]
    inside = torch.minimum(torch.minimum(l, t), torch.minimum(r, b)) >= 0
    mode = cfg["range_assign_mode"]
    if mode == "dist":
        measure = torch.maximum(torch.maximum(l, t), torch.maximum(r, b))
    elif mode == "longer":
        measure = torch.maximum(gt[:, 2], gt[:, 3]).expand(P, -1)
    elif mode == "shorter":
        measure = torch.minimum(gt[:, 2], gt[:, 3]).expand(P, -1)
    else:
        measure = torch.sqrt(gt[:, 2] * gt[:, 3]).expand(P, -1)
    lo, up = info["ranges"][:, 0:1], info["ranges"][:, 1:2]
    glo, gup = info["gray_ranges"][:, 0:1], info["gray_ranges"][:, 1:2]
    green = inside & (measure >= lo) & (measure <= up)
    gray = inside & (((measure >= glo) & (measure < lo)) | ((measure > up) & (measure <= gup)))
    cx, cy = gt[:, 0] + gt[:, 2] / 2.0, gt[:, 1] + gt[:, 3] / 2.0
    half = st[:, None] / 2.0
    fx = ((pts[:, 0:1] - cx).abs() / half).clamp(min=1.0)
    fy = ((pts[:, 1:2] - cy).abs() / half).clamp(min=1.0)
    score = torch.sqrt(1.0 / fx) * torch.sqrt(1.0 / fy) * green
    for c in range(C):
        of_c = lab == c
        if of_c.any():
            cls_t[:, c] = score[:, of_c].max(dim=1).values
            cls_t[:, c] = torch.where(gray[:, of_c].any(dim=1), -1.0, cls_t[:, c])
    best, sel = score.max(dim=1)
    reg_t = torch.stack([d.gather(1, sel[:, None])[:, 0] for d in (l, t, r, b)], -1)
    reg_t = torch.where((best > 0)[:, None], reg_t, torch.zeros_like(reg_t))
    return cls_t, reg_t


def focal_loss(logits, labels, gamma, alpha):
    """Sigmoid focal loss per element (N, C); labels == C is background.
    log p is clamped at log(FLT_MIN) as the reference's CUDA extension."""
    C = logits.shape[1]
    onehot = F.one_hot(labels.clamp(max=C - 1), C).float() * (labels < C).float()[:, None]
    p = torch.sigmoid(logits)
    logp = F.logsigmoid(logits).clamp(min=math.log(1.1754943508222875e-38))
    log1mp = F.logsigmoid(-logits)
    pos = -alpha * (1.0 - p) ** gamma * logp
    neg = -(1.0 - alpha) * p ** gamma * log1mp
    return onehot * pos + (1.0 - onehot) * neg


def iou_loss(pred, target, eps):
    """-log(IoU) of aligned xyxy boxes, union and IoU clamped at eps."""
    lt = torch.maximum(pred[:, :2], target[:, :2])
    rb = torch.minimum(pred[:, 2:], target[:, 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[:, 0] * wh[:, 1]
    ap = (pred[:, 2] - pred[:, 0]) * (pred[:, 3] - pred[:, 1])
    ag = (target[:, 2] - target[:, 0]) * (target[:, 3] - target[:, 1])
    union = (ap + ag - overlap).clamp(min=eps)
    return -torch.log((overlap / union).clamp(min=eps))


def loss(cls_pred, reg_pred, cls_t, reg_t, info, cfg):
    """LFD's loss over a batch (`lfd.py:284-395`): gray rows left out,
    positives where the best target score is at least 0.001; the
    classification loss over (num_pos + 1), the IoU loss of the decoded
    boxes over num_pos."""
    C = cfg["num_classes"]
    B = cls_pred.shape[0]
    cls_pred = cls_pred.reshape(-1, cls_pred.shape[-1])
    reg_pred = reg_pred.reshape(-1, 4)
    cls_t = cls_t.reshape(-1, C)
    reg_t = reg_t.reshape(-1, 4)
    valid = (cls_t.min(dim=-1).values >= 0).float()
    best, idx = cls_t.max(dim=-1)
    pos = valid * (best >= 0.001).float()
    num_pos = pos.sum()
    labels = torch.where(pos > 0, idx, torch.full_like(idx, C))
    lc = cfg["classification_loss"]
    if lc["type"] == "FocalLoss":
        cls_loss = (focal_loss(cls_pred, labels, lc["gamma"], lc["alpha"])
                    * valid[:, None]).sum() / (num_pos + 1.0)
    else:  # CrossEntropyLoss over C + 1
        ce = -F.log_softmax(cls_pred, dim=-1).gather(1, labels[:, None])[:, 0]
        cls_loss = (ce * valid).sum() / (num_pos + 1.0)
    pts = info["points"].repeat(B, 1)
    rmax = info["ranges"].max(dim=-1, keepdim=True).values.repeat(B, 1)
    dist = (torch.sigmoid(reg_pred) * rmax if cfg["distance_to_bbox_mode"] == "sigmoid"
            else torch.exp(reg_pred.clamp(max=30.0)))

    def xyxy(d):
        return torch.stack([pts[:, 0] - d[:, 0], pts[:, 1] - d[:, 1],
                            pts[:, 0] + d[:, 2], pts[:, 1] + d[:, 3]], -1)

    eps = cfg["regression_loss"]["eps"]
    reg_loss = (iou_loss(xyxy(dist), xyxy(reg_t), eps) * pos).sum() / num_pos.clamp(min=1e-6)
    return cls_loss + reg_loss, cls_loss, reg_loss, num_pos
