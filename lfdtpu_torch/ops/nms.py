# Non-maximum suppression (`lfdtpu/ops/nms.py`), exact greedy semantics
# (sort by score desc, suppress IoU > thr, exclusive-area IoU) on two paths:
#
#   1. Host path: numpy, for the numpy-array `nms()` / `soft_nms()` /
#      `nms_match()` public API (`lfd/model/utils/nms.py:7-116`). lfdtpu
#      also carries a C++ copy of these loops (`lfdtpu/native`), a faster
#      host build of the same functions that it falls back from to numpy;
#      the port keeps the numpy path alone (ROADMAP queue 1, item 10).
#
#   2. Device path: batched over images, shape-static, the keep mask itself
#      K1 (`nms_kernel.py`); `multiclass_nms` is its static-shape caller.

from __future__ import annotations

import numpy as np
import torch

from .nms_kernel import nms_mask_sorted, nms_mask_sorted_plain_op


def nms_mask(boxes, scores, iou_thr, valid=None, use_kernel=True):
    """Exact greedy-NMS keep mask.

    boxes (B, K, 4) xyxy in any order, scores (B, K) for the greedy order,
    valid (B, K) bool: invalid rows never keep nor suppress.
    use_kernel: route the mask through K1's op (which launches the CUDA
    kernel for CUDA tensors); False forces the plain version, as an op of
    its own (lfd::nms_mask_sorted_plain) so that an engine exports.
    Returns (B, K) bool in the ORIGINAL order.

    Tie order follows `lfdtpu`: a stable ascending argsort, reversed, so among
    equal scores the HIGHER index comes first.
    """
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    ranked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(ranked, dim=-1, stable=True).flip(-1)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    svalid = torch.gather(valid, 1, order).contiguous()
    fn = nms_mask_sorted if use_kernel else nms_mask_sorted_plain_op
    keep_sorted = fn(sboxes, svalid, iou_thr)
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)


def batched_nms(boxes, scores, idxs, iou_thr, valid=None, class_agnostic=False,
                use_kernel=True):
    """Per-class NMS in one call via the class-offset trick
    (`lfdtpu/ops/nms.py::batched_nms_jax`). Returns a (B, K) keep mask."""
    if not class_agnostic:
        row_max = boxes.max(dim=-1).values
        if valid is not None:
            row_max = torch.where(valid, row_max, torch.zeros_like(row_max))
        max_coord = row_max.max(dim=-1, keepdim=True).values
        offsets = idxs.to(boxes.dtype) * (max_coord + 1.0)
        boxes = boxes + offsets[..., None]
    return nms_mask(boxes, scores, iou_thr, valid=valid, use_kernel=use_kernel)


def multiclass_nms(bboxes, scores, score_thr, iou_thr, max_num=100, class_agnostic=False,
                   valid=None, use_kernel=True):
    """Static-shape multiclass NMS (`lfdtpu/ops/nms.py::multiclass_nms_jax`,
    `lfd/model/utils/nms.py:161-220`) on torch tensors.

    bboxes (K, 4) or (B, K, 4) xyxy candidates (already top-k pre-filtered),
    scores (K,) or (B, K), valid: optional bool of the same shape marking
    live rows. As in lfdtpu the boxes carry no labels, so class_agnostic
    changes nothing: a per-class NMS offsets the boxes by class first
    (batched_nms). use_kernel: the keep mask through K1 (for CUDA tensors),
    or its plain version.

    Returns (keep, order, count):
      keep: bool, scores > score_thr, NMS survivors, ranks past max_num dropped;
      order: int64, indices sorting the survivors by descending score (a
        stable ascending argsort reversed, as lfdtpu: among equal scores the
        higher index first); the tail past the survivors is arbitrary;
      count: int32, the number of survivors clipped at max_num.
    """
    del class_agnostic  # lfdtpu's signature; see above
    squeeze = bboxes.dim() == 2
    if squeeze:
        bboxes, scores = bboxes[None], scores[None]
        valid = None if valid is None else valid[None]
    live = scores > score_thr
    valid = live if valid is None else valid & live
    keep = nms_mask(bboxes, scores, iou_thr, valid=valid, use_kernel=use_kernel)
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(masked, dim=-1, stable=True).flip(-1)
    count = keep.sum(-1).clamp(max=max_num).to(torch.int32)
    ranks = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ranks)
    keep = keep & (rank < max_num)
    if squeeze:
        return keep[0], order[0], count[0]
    return keep, order, count


# ---------------------------------------------------------------- host path

def _suppression_ious(dets):
    """(the rows' greedy order: score descending, stable; iou_with(i): row
    i's IoU with every row) of a (K, 5) [x1, y1, x2, y2, score] array."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1) * (y2 - y1)
    order = np.argsort(-scores, kind="stable")

    def iou_with(i):
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        return inter / (areas[i] + areas - inter)

    return order, iou_with


def _nms_numpy_impl(dets, iou_thr):
    order, iou_with = _suppression_ious(dets)
    keep = []
    suppressed = np.zeros(len(dets), dtype=bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou_with(i) > iou_thr
        suppressed[i] = True  # kept, never revisited
    return np.asarray(keep, dtype=np.int64)


def nms(dets, iou_thr):
    """Greedy NMS on a (K, 5) [x1, y1, x2, y2, score] array.

    Returns (kept_dets, kept_indices) like `lfd/model/utils/nms.py:7-59`."""
    dets = np.asarray(dets)
    if dets.shape[0] == 0:
        return dets, np.zeros((0,), dtype=np.int64)
    inds = _nms_numpy_impl(dets, iou_thr)
    return dets[inds, :], inds


def soft_nms(dets, iou_thr, method="linear", sigma=0.5, min_score=1e-3):
    """Soft-NMS (linear / gaussian), mirroring `nms/src/cpu/nms_cpu.cpp:76-293`
    / `lfd/model/utils/nms.py:62-116`.

    Returns (new_dets (K', 5), indices (K',))."""
    if method not in ("linear", "gaussian"):
        raise ValueError(f"soft_nms method {method!r}: 'linear' or 'gaussian'")
    dets = np.array(dets, dtype=np.float32, copy=True)
    n = dets.shape[0]
    if n == 0:
        return dets[:, :5], np.zeros((0,), dtype=np.int64)
    kept_rows, kept_inds = [], []
    boxes = dets[:, :4].copy()
    scores = dets[:, 4].copy()
    active = np.ones(n, dtype=bool)
    while active.any():
        cand = np.where(active)[0]
        i = cand[np.argmax(scores[cand])]
        kept_rows.append(np.concatenate([boxes[i], [scores[i]]]))
        kept_inds.append(i)
        active[i] = False
        if not active.any():
            break
        rest = np.where(active)[0]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / (area_i + area_r - inter)
        if method == "linear":
            decay = np.where(iou > iou_thr, 1.0 - iou, 1.0)
        else:
            decay = np.exp(-(iou * iou) / sigma)
        scores[rest] *= decay
        active[rest] &= scores[rest] >= min_score
    return np.stack(kept_rows, axis=0), np.asarray(kept_inds, dtype=np.int64)


def nms_match(dets, iou_thr):
    """Group boxes by greedy-NMS suppression (`nms_cpu.cpp` nms_match_cpu):
    a list of index groups, each led by a kept box followed by the boxes it
    suppressed."""
    dets = np.asarray(dets)
    if dets.shape[0] == 0:
        return []
    order, iou_with = _suppression_ious(dets)
    suppressed = np.zeros(len(dets), dtype=bool)
    groups = []
    for i in order:
        if suppressed[i]:
            continue
        iou = iou_with(i)
        members = [int(i)]
        for j in order:
            if j == i or suppressed[j]:
                continue
            if iou[j] > iou_thr:
                suppressed[j] = True
                members.append(int(j))
        suppressed[i] = True
        groups.append(members)
    return groups
