# LFD (v1) and LFDv2 target assignment (`lfdtpu/ops/assign.py:26-233`),
# batched.
#
# The reference generates targets with a per-image CPU loop over GT lists and
# data-dependent scatter writes (`lfd/model/lfd.py:109-259`). lfdtpu
# reformulates it as one (P, Nmax) broadcast over *padded* GT arrays with a
# validity mask; here the same broadcast carries a leading batch dim
# (lfdtpu vmaps it), so it runs on the device with no host sync:
#
#   - "ascending sort, highest score written last" == a per-class max over the
#     GT axis (scatter_reduce amax over the label index);
#   - gray writes come after green writes, so a gray hit overrides a green
#     score of the same class at the same point with -1;
#   - regression target = deltas of the argmax-score green GT, first index
#     on ties (torch.argmax and jnp.argmax both return the first maximum).
#
# Memory: the (B, P, N) pair tensors are processed in batch chunks of at most
# _PAIR_BUDGET elements, and the four (l, t, r, b) deltas stay separate
# (P, N) planes, gathered only at the selected GT.
#
# fcos_assign, fcos_v1_assign and centerness_target come with the FCOS
# detectors.

from __future__ import annotations

import torch

_PAIR_BUDGET = 1 << 25  # (chunk, P, N) elements per pass


def _point_gt_geometry(points, gt_bboxes):
    """Shared (B, P, N) geometry: the (l, t, r, b) deltas as four planes and
    the GT centers (B, N). gt_bboxes (B, N, 4) are xywh with inclusive
    extents: right = x + w - 1 (`lfd/model/lfd.py:201-205`)."""
    px = points[None, :, 0, None]  # (1, P, 1)
    py = points[None, :, 1, None]
    gx = gt_bboxes[:, None, :, 0]  # (B, 1, N)
    gy = gt_bboxes[:, None, :, 1]
    gw = gt_bboxes[:, None, :, 2]
    gh = gt_bboxes[:, None, :, 3]
    delta = (px - gx, py - gy, (gx + gw - 1.0) - px, (gy + gh - 1.0) - py)
    cx = gt_bboxes[..., 0] + gt_bboxes[..., 2] / 2.0
    cy = gt_bboxes[..., 1] + gt_bboxes[..., 3] / 2.0
    return delta, cx, cy


def _assign_measure(mode, gt_bboxes, delta):
    """Range-assignment measure per (B, P, N) pair (`lfd.py:208-217`)."""
    gw = gt_bboxes[:, None, :, 2]
    gh = gt_bboxes[:, None, :, 3]
    shape = delta[0].shape
    if mode == "longer":
        return torch.maximum(gw, gh).expand(shape)
    if mode == "shorter":
        return torch.minimum(gw, gh).expand(shape)
    if mode == "sqrt":
        return torch.sqrt(gw * gh).expand(shape)
    if mode == "dist":
        d_l, d_t, d_r, d_b = delta
        return torch.maximum(torch.maximum(d_l, d_t), torch.maximum(d_r, d_b))
    raise ValueError(f"Unsupported range assign mode: {mode}")


def _select_regression_target(scores, delta):
    """(B, P, 4) deltas of the max-score GT per point; zeros where no GT
    scores above 0 (lfdtpu's `num_gt == 0` early exit, `lfd.py:170-172`)."""
    best, sel = scores.max(dim=2)  # first index on ties
    sel = sel[..., None]
    out = torch.stack([d.gather(2, sel)[..., 0] for d in delta], dim=-1)
    return torch.where((best > 0)[..., None], out, torch.zeros_like(out))


def _lfd_assign_chunk(points, strides, regression_ranges, gray_ranges,
                      gt_bboxes, gt_labels, gt_mask, num_classes,
                      range_assign_mode, normalize_by_range):
    delta, cx, cy = _point_gt_geometry(points, gt_bboxes)

    # center-proximity score in (0, 1]: sqrt(1/max(1, |dx|/(s/2))) per axis
    # (`lfd.py:190-199`)
    half_s = (strides / 2.0)[None, :, None]
    ax = (points[None, :, 0, None] - cx[:, None, :]).abs() / half_s
    ay = (points[None, :, 1, None] - cy[:, None, :]).abs() / half_s
    ax = ax.clamp(min=1.0)
    ay = ay.clamp(min=1.0)
    point_scores = torch.sqrt(1.0 / ax) * torch.sqrt(1.0 / ay)  # (B, P, N)

    measure = _assign_measure(range_assign_mode, gt_bboxes, delta)
    rr_lo = regression_ranges[None, :, 0, None]
    rr_up = regression_ranges[None, :, 1, None]
    gr_lo = gray_ranges[None, :, 0, None]
    gr_up = gray_ranges[None, :, 1, None]

    d_l, d_t, d_r, d_b = delta
    hit = torch.minimum(torch.minimum(d_l, d_t), torch.minimum(d_r, d_b)) >= 0
    hit = hit & gt_mask[:, None, :]
    green = (rr_lo <= measure) & (measure <= rr_up) & hit
    gray = (((gr_lo <= measure) & (measure < rr_lo))
            | ((rr_up < measure) & (measure <= gr_up))) & hit

    # per-class green score: max over GTs of that class (== "largest score
    # written last", `lfd.py:243-246`); gray overrides green (`:248-251`)
    # (a GT with an out-of-range label may still be selected for regression,
    # as in lfdtpu)
    green_scores = point_scores * green
    cls_green = _class_max(green_scores, gt_labels, num_classes)
    gray_any = _class_max(gray.to(green_scores.dtype), gt_labels, num_classes) > 0
    cls_targets = torch.where(gray_any, torch.full_like(cls_green, -1.0), cls_green)

    reg_targets = _select_regression_target(green_scores, delta)
    if normalize_by_range:
        # dividing the selected deltas equals selecting divided deltas
        reg_targets = reg_targets / regression_ranges[None, :, 1, None]
    return cls_targets, reg_targets


@torch.no_grad()
def lfd_assign(points, strides, regression_ranges, gray_ranges, gt_bboxes,
               gt_labels, gt_mask, num_classes, range_assign_mode="dist",
               normalize_by_range=False):
    """LFD (v1) target assignment (`lfd/model/lfd.py:155-259`), batched.

    Args:
      points: (P, 2) float [x, y] image coordinates.
      strides: (P,) float per-point stride.
      regression_ranges: (P, 2) float per-point (low, up).
      gray_ranges: (P, 2) float per-point gray band (low, up).
      gt_bboxes: (B, N, 4) float xywh (padded).
      gt_labels: (B, N) int 0-based class labels (padded).
      gt_mask: (B, N) bool validity of each GT row.
      num_classes: C.
      range_assign_mode: 'longer' | 'shorter' | 'sqrt' | 'dist'.
      normalize_by_range: True for independent (SmoothL1/MSE) regression:
        deltas divided by the range upper bound (`lfd.py:219-220`).

    Returns:
      cls_targets: (B, P, C) float soft scores; -1 marks gray-ignored entries.
      reg_targets: (B, P, 4) float (l, t, r, b) deltas of the selected GT.
    """
    return _in_chunks(_lfd_assign_chunk, points, strides, regression_ranges, gray_ranges,
                      gt_bboxes, gt_labels, gt_mask, num_classes, range_assign_mode,
                      normalize_by_range)


def _in_chunks(chunk_fn, points, strides, regression_ranges, gray_ranges, gt_bboxes,
               gt_labels, gt_mask, *args):
    """chunk_fn over batch chunks of at most _PAIR_BUDGET (b, P, N) pairs."""
    B, N = gt_bboxes.shape[:2]
    P = points.shape[0]
    chunk = max(1, _PAIR_BUDGET // max(P * N, 1))
    outs = [
        chunk_fn(points, strides, regression_ranges, gray_ranges, gt_bboxes[b:b + chunk],
                 gt_labels[b:b + chunk], gt_mask[b:b + chunk], *args)
        for b in range(0, B, chunk)
    ]
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _class_max(point_scores, gt_labels, num_classes):
    """(B, P, C): per class, the max over GTs of that class of the (B, P, N)
    scores (lfdtpu's one-hot product and max). A label outside [0, C) has an
    all-zero one-hot row in lfdtpu: it writes no class score."""
    B, P, N = point_scores.shape
    label_ok = ((gt_labels >= 0) & (gt_labels < num_classes))[:, None, :]
    label_idx = gt_labels.clamp(0, num_classes - 1).long()[:, None, :].expand(B, P, N)
    return point_scores.new_zeros(B, P, num_classes).scatter_reduce(
        2, label_idx, point_scores * label_ok, "amax")


def _lfdv2_assign_chunk(points, strides, regression_ranges, gray_ranges,
                        gt_bboxes, gt_labels, gt_mask, num_classes,
                        range_assign_mode, normalize_by_range):
    delta, cx, cy = _point_gt_geometry(points, gt_bboxes)
    d_l, d_t, d_r, d_b = delta
    hit = torch.minimum(torch.minimum(d_l, d_t), torch.minimum(d_r, d_b)) >= 0

    # centerness on hit-filtered deltas (`lfdv2.py:325-337`)
    fl, ft, fr, fb = (d * hit for d in delta)
    lr_min = torch.minimum(fl, fr).clamp(min=0.0)
    lr_max = torch.maximum(fl, fr).clamp(min=0.01)
    tb_min = torch.minimum(ft, fb).clamp(min=0.0)
    tb_max = torch.maximum(ft, fb).clamp(min=0.01)
    point_scores = torch.sqrt((lr_min / lr_max) * (tb_min / tb_max))

    # core zone: within stride/2 of the GT center, score 1 (`lfdv2.py:339-348`)
    px = points[None, :, 0, None]
    py = points[None, :, 1, None]
    s2 = (strides / 2.0)[None, :, None]
    cx, cy = cx[:, None, :], cy[:, None, :]
    core = (px >= cx - s2) & (px <= cx + s2) & (py >= cy - s2) & (py <= cy + s2) & hit
    point_scores = torch.where(core, torch.ones_like(point_scores), point_scores)

    # linear gray-zone relaxation instead of hard ignores (`lfdv2.py:364-378`)
    measure = _assign_measure(range_assign_mode, gt_bboxes, delta)
    rr_lo = regression_ranges[None, :, 0, None]
    rr_up = regression_ranges[None, :, 1, None]
    gr_lo = gray_ranges[None, :, 0, None]
    gr_up = gray_ranges[None, :, 1, None]
    left_mult = (measure - gr_lo) / (rr_lo - gr_lo).clamp(min=0.01)
    left_ind = (gr_lo <= measure) & (measure < rr_lo)
    in_range = (rr_lo <= measure) & (measure <= rr_up)
    right_mult = (gr_up - measure) / (gr_up - rr_up).clamp(min=0.01)
    right_ind = (rr_up < measure) & (measure <= gr_up)
    relaxation = left_mult * left_ind + in_range + right_mult * right_ind
    point_scores = point_scores * relaxation * gt_mask[:, None, :]

    cls_targets = _class_max(point_scores * (point_scores > 0), gt_labels, num_classes)
    reg_targets = _select_regression_target(point_scores, delta)
    if normalize_by_range:
        reg_targets = reg_targets / regression_ranges[None, :, 1, None]
    return cls_targets, reg_targets


@torch.no_grad()
def lfdv2_assign(points, strides, regression_ranges, gray_ranges, gt_bboxes,
                 gt_labels, gt_mask, num_classes, range_assign_mode="longer",
                 normalize_by_range=False):
    """LFDv2 target assignment (`lfd/model/lfdv2.py:281-418`), batched; the
    arguments and returns of lfd_assign. Unlike v1: an FCOS-style centerness
    score, a stride-sized core zone around the GT center forced to 1.0, and a
    linear gray-zone relaxation multiplier instead of hard -1 ignores, so no
    target is -1."""
    return _in_chunks(_lfdv2_assign_chunk, points, strides, regression_ranges, gray_ranges,
                      gt_bboxes, gt_labels, gt_mask, num_classes, range_assign_mode,
                      normalize_by_range)
