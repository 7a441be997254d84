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
# lfd_assign is the custom op `lfd::lfd_assign` (torch.library): its CPU
# kernel is the plain version above, lfd_assign_plain; its CUDA kernel is K6
# (`lfdtpu_torch/csrc/assign.cu`), one launch, a thread per point over its
# image's real GT rows, float32 only, bit for bit the plain version's
# targets, with no (B, P, N) tensor. For a CUDA tensor it launches K6 or
# raises. The other rules (LFDv2, FCOS) keep their plain paths.
#
# fcos_assign, fcos_v1_assign and centerness_target (`:235-311`) serve the
# FCOS detectors: hard labels with min-area disambiguation (argmin over
# INF-masked areas, first index on ties as jnp.argmin).

from __future__ import annotations

import torch

from . import kernel_lib

_PAIR_BUDGET = 1 << 25  # (chunk, P, N) elements per pass
INF = 1e8
MODES = ("longer", "shorter", "sqrt", "dist")  # range assign modes; K6 takes their index
MAX_CLASSES = 384  # csrc/assign.cu: a block's C x 129 class scores in shared memory


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
def lfd_assign_plain(points, strides, regression_ranges, gray_ranges, gt_bboxes,
                     gt_labels, gt_mask, num_classes, range_assign_mode="dist",
                     normalize_by_range=False):
    """LFD (v1) target assignment (`lfd/model/lfd.py:155-259`), batched:
    the plain version of K6.

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
    return _in_chunks(_lfd_assign_chunk, (points, strides, regression_ranges, gray_ranges),
                      gt_bboxes, gt_labels, gt_mask, num_classes, range_assign_mode,
                      normalize_by_range)


@torch.library.custom_op("lfd::lfd_assign", mutates_args=(), device_types="cpu")
def _assign_op(points: torch.Tensor, strides: torch.Tensor, regression_ranges: torch.Tensor,
               gray_ranges: torch.Tensor, gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_mask: torch.Tensor, num_classes: int, range_assign_mode: str,
               normalize_by_range: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's CPU kernel: the plain version."""
    return lfd_assign_plain(points, strides, regression_ranges, gray_ranges, gt_bboxes,
                            gt_labels, gt_mask, num_classes, range_assign_mode,
                            normalize_by_range)


@_assign_op.register_kernel("cuda")
def _assign_cuda(points, strides, regression_ranges, gray_ranges, gt_bboxes, gt_labels,
                 gt_mask, num_classes, range_assign_mode, normalize_by_range):
    """K6's CUDA kernel: one launch on the current stream."""
    B, N = gt_bboxes.shape[:2]
    P = points.shape[0]
    dev = gt_bboxes.device
    if range_assign_mode not in MODES:
        raise ValueError(f"Unsupported range assign mode: {range_assign_mode}")
    if not 0 < num_classes <= MAX_CLASSES:
        raise ValueError(f"lfd_assign: K6 takes 1 to {MAX_CLASSES} classes, not {num_classes}")
    if gt_labels.is_floating_point() or gt_labels.is_complex() or gt_labels.dtype == torch.bool:
        raise ValueError(f"lfd_assign labels: expected an integer tensor, got {gt_labels.dtype}")
    labels = gt_labels.long()  # exact for every integer label
    f32 = torch.float32
    # K6 reads gt rows as 16-byte vectors, (x, y) pairs as 8-byte ones
    for name, t, dtype, shape, align in (
            ("points", points, f32, (P, 2), 8), ("strides", strides, f32, (P,), 4),
            ("regression_ranges", regression_ranges, f32, (P, 2), 8),
            ("gray_ranges", gray_ranges, f32, (P, 2), 8),
            ("gt_bboxes", gt_bboxes, f32, (B, N, 4), 16),
            ("gt_labels", labels, torch.int64, (B, N), 8),
            ("gt_mask", gt_mask, torch.bool, (B, N), 1)):
        kernel_lib.check_cuda(f"lfd_assign {name}", t, dtype, shape, dev, align)
    cls = torch.empty(B, P, num_classes, dtype=f32, device=dev)
    reg = torch.empty(B, P, 4, dtype=f32, device=dev)
    if B and P:
        with torch.cuda.device(dev):
            kernel_lib.launch("lfd_assign", points.data_ptr(), strides.data_ptr(),
                              regression_ranges.data_ptr(), gray_ranges.data_ptr(),
                              gt_bboxes.data_ptr(), labels.data_ptr(), gt_mask.data_ptr(),
                              cls.data_ptr(), reg.data_ptr(), B, P, N, num_classes,
                              MODES.index(range_assign_mode), int(normalize_by_range),
                              kernel_lib.stream_of(gt_bboxes))
        lfd_assign.launches += 1
    return cls, reg


@_assign_op.register_fake
def _assign_fake(points, strides, regression_ranges, gray_ranges, gt_bboxes, gt_labels,
                 gt_mask, num_classes, range_assign_mode, normalize_by_range):
    B, P = gt_bboxes.shape[0], points.shape[0]
    dtype = torch.promote_types(points.dtype, gt_bboxes.dtype)
    return (gt_bboxes.new_empty(B, P, num_classes, dtype=dtype),
            gt_bboxes.new_empty(B, P, 4, dtype=dtype))


def lfd_assign(points, strides, regression_ranges, gray_ranges, gt_bboxes, gt_labels, gt_mask,
               num_classes, range_assign_mode="dist", normalize_by_range=False):
    """LFD (v1) target assignment, the op lfd::lfd_assign: the plain
    version for CPU tensors, K6 for CUDA float32 ones (another CUDA dtype
    raises). Arguments and returns as lfd_assign_plain's."""
    return torch.ops.lfd.lfd_assign(points, strides, regression_ranges, gray_ranges, gt_bboxes,
                                    gt_labels, gt_mask, int(num_classes),
                                    str(range_assign_mode), bool(normalize_by_range))


lfd_assign.launches = 0


def _in_chunks(chunk_fn, per_point, gt_bboxes, gt_labels, gt_mask, *args):
    """chunk_fn(*per_point, gt chunk, *args) over batch chunks of at most
    _PAIR_BUDGET (b, P, N) pairs; per_point[0] is the (P, 2) points."""
    B, N = gt_bboxes.shape[:2]
    P = per_point[0].shape[0]
    chunk = max(1, _PAIR_BUDGET // max(P * N, 1))
    outs = [
        chunk_fn(*per_point, gt_bboxes[b:b + chunk], gt_labels[b:b + chunk],
                 gt_mask[b:b + chunk], *args)
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
    return _in_chunks(_lfdv2_assign_chunk, (points, strides, regression_ranges, gray_ranges),
                      gt_bboxes, gt_labels, gt_mask, num_classes, range_assign_mode,
                      normalize_by_range)


def _fcos_valid_and_min_area(points, regression_ranges, gt_bboxes, gt_mask):
    """(B, P, N) deltas, the valid (point, GT) pairs (strictly inside
    (`fcos.py:163`), max distance within the level's inclusive range, a real
    GT row) and per point the smallest valid GT's area and index (INF and 0
    where none is valid)."""
    delta, _, _ = _point_gt_geometry(points, gt_bboxes)
    d_l, d_t, d_r, d_b = delta
    inside = torch.minimum(torch.minimum(d_l, d_t), torch.minimum(d_r, d_b)) > 0
    max_dist = torch.maximum(torch.maximum(d_l, d_t), torch.maximum(d_r, d_b))
    in_range = ((max_dist >= regression_ranges[None, :, 0, None])
                & (max_dist <= regression_ranges[None, :, 1, None]))
    valid = inside & in_range & gt_mask[:, None, :]
    areas = (gt_bboxes[..., 2] * gt_bboxes[..., 3])[:, None, :]
    min_areas, min_idx = torch.where(valid, areas, torch.full_like(areas, INF)).min(dim=2)
    return delta, valid, min_areas, min_idx


def _gather_delta(delta, idx):
    """(B, P, 4) deltas of GT `idx` (B, P) per point."""
    return torch.stack([d.gather(2, idx[..., None])[..., 0] for d in delta], dim=-1)


def _fcos_assign_chunk(points, regression_ranges, gt_bboxes, gt_labels, gt_mask,
                       num_classes):
    delta, _, min_areas, min_idx = _fcos_valid_and_min_area(
        points, regression_ranges, gt_bboxes, gt_mask)
    labels = torch.where(min_areas >= INF, torch.full_like(min_idx, num_classes),
                         gt_labels.long().gather(1, min_idx))
    # a point with no valid GT regresses GT 0, as lfdtpu's argmin over INFs
    return labels.to(torch.int32), _gather_delta(delta, min_idx)


@torch.no_grad()
def fcos_assign(points, regression_ranges, gt_bboxes, gt_labels, gt_mask, num_classes):
    """FCOS target assignment (`lfd/model/fcos.py:116-186`), batched.

    Args as lfd_assign's, without strides and gray ranges. Returns labels
    (B, P) int32, `num_classes` for background, and reg_targets (B, P, 4),
    the (l, t, r, b) deltas of the smallest valid GT."""
    return _in_chunks(_fcos_assign_chunk, (points, regression_ranges), gt_bboxes,
                      gt_labels, gt_mask, num_classes)


def _fcos_v1_assign_chunk(points, regression_ranges, gt_bboxes, gt_labels, gt_mask,
                          num_classes):
    delta, valid, _, min_idx = _fcos_valid_and_min_area(
        points, regression_ranges, gt_bboxes, gt_mask)
    # each valid pair marks its GT's class at the point: a max over the GTs
    # of each class, never lfdtpu's (P, N, C) one-hot product
    fg = _class_max(valid.to(delta[0].dtype), gt_labels, num_classes) > 0
    return fg, _gather_delta(delta, min_idx)


@torch.no_grad()
def fcos_v1_assign(points, regression_ranges, gt_bboxes, gt_labels, gt_mask, num_classes):
    """FCOSv1 multi-class-per-point assignment (`lfd/model/fcos.py:575-640`),
    batched: fg (B, P, C) bool, every class with a valid GT at the point;
    reg_targets (B, P, 4) of the smallest valid GT, as fcos_assign."""
    return _in_chunks(_fcos_v1_assign_chunk, (points, regression_ranges), gt_bboxes,
                      gt_labels, gt_mask, num_classes)


def centerness_target(reg_targets, eps=0.0):
    """FCOS centerness sqrt((min/max of l, r) * (min/max of t, b))
    (`fcos.py:211-215`) of (..., 4) deltas."""
    l, t, r, b = reg_targets.unbind(-1)
    ratio = ((torch.minimum(l, r) / torch.maximum(l, r).clamp(min=1e-12))
             * (torch.minimum(t, b) / torch.maximum(t, b).clamp(min=1e-12)))
    return torch.sqrt(ratio.clamp(min=0.0) + eps)
