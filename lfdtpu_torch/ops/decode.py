# Fused dense-prediction decode: scores -> top-k -> distance2bbox -> NMS
# (`lfdtpu/ops/decode.py`), batched over images with static shapes:
#
#   stage 1: per-point max-class score -> top `pre_nms_points` points (or,
#            with `per_level_limit`, LFDv2's top points of each level)
#   stage 2: the kept points' (point, class) pairs above the threshold ->
#            top `nms_budget` candidates
#   stage 3: decode the candidates' boxes, class-offset NMS (K1), emit a
#            fixed (max_det, ...) result and a valid count.
#
# Tie order matters for exact parity: `lax.top_k` breaks ties by ascending
# index, which a STABLE descending sort reproduces (`torch.topk` leaves the
# order of ties unspecified).

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .nms import batched_nms


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Static decode configuration (`lfdtpu/ops/decode.py::DecodeSpec`)."""

    num_classes: int
    use_softmax: bool = False  # CrossEntropyLoss head: C+1 channels, softmax
    reg_mode: str = "exp"  # 'exp' | 'sigmoid' | 'independent' | 'direct'
    score_thr: float = 0.05
    nms_iou: float = 0.4
    pre_nms_points: int = 1000  # stage-1 top-k over points
    nms_budget: int = 1000  # stage-2 candidate budget fed to NMS
    max_det: int = 100
    class_agnostic: bool = False
    # LFDv2's `pre_nms_bbox_limit` applies PER LEVEL before the levels are
    # concatenated (`lfdv2.py:618-624`), and only to a level with more points
    # than the limit. > 0 switches stage 1 to that; decode_predictions then
    # needs the static `level_sizes`.
    per_level_limit: int = 0
    # K1 switch (the JAX knob is `nms_use_pallas`): True routes the keep mask
    # through the kernel wrapper, which launches the CUDA kernel for CUDA
    # tensors and runs the plain version for CPU tensors; False forces plain.
    nms_use_kernel: bool = True


def _top_k(values, k):
    """(values, indices) of the k largest along the last dim, ties by
    ascending index (the `lax.top_k` order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x, idx):
    """x (B, N, D), idx (B, M) -> (B, M, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _decode_distances(reg, ranges, mode):
    """Distance head -> (l, t, r, b) in pixels (`lfd.py:604-625`)."""
    if mode == "exp":
        # clamped: inf distances would produce NaN IoUs inside NMS
        return torch.exp(torch.clamp_max(reg.float(), 30.0))
    if mode == "sigmoid":
        range_max = ranges.max(dim=-1, keepdim=True).values
        return torch.sigmoid(reg.float()) * range_max
    if mode == "independent":
        return reg * ranges[..., 1, None]
    if mode == "direct":
        # distances already in pixels (the FCOS head applies exp itself)
        return reg.float()
    raise ValueError(f"unknown reg mode {mode}")


def decode_predictions(cls_logits, reg, points, ranges, spec: DecodeSpec,
                       image_hw, point_valid=None, score_factors=None, level_sizes=None):
    """Decode a batch of dense predictions into final detections.

    cls_logits (B, P, C) logits, or (B, P, C+1) when spec.use_softmax;
    reg (B, P, 4); points, ranges (P, 2); image_hw (B, 2) float [h, w], the
    valid extent of each image inside its padded input (boxes clamp to it);
    point_valid optional (B, P) bool masking points inside the padding;
    score_factors optional (B, P) non-negative multiplier of every class
    score of a point (FCOS's sigmoid centerness, `fcos.py:403-410`);
    level_sizes: the per-level point counts (Python ints summing to P),
    needed when spec.per_level_limit > 0.

    Returns dict: boxes (B, max_det, 4) xyxy, scores (B, max_det),
    labels (B, max_det) int32, count (B,) int32; rows >= count are zero;
    candidates (B,) int32, the valid candidates that enter NMS (K1's work,
    at most nms_budget).
    """
    B, P, Cc = cls_logits.shape
    C = spec.num_classes
    cls_logits = cls_logits.float()
    reg = reg.float()

    # stage 1 ranks one scalar per point: sigmoid is monotonic, and softmax's
    # foreground max is exp(max_fg - m) / z with the row's shared m and z
    if spec.use_softmax:
        m = cls_logits.max(dim=-1).values
        z = torch.exp(cls_logits - m[..., None]).sum(dim=-1)
        point_max = torch.exp(cls_logits[..., :C].max(dim=-1).values - m) / z
    else:
        point_max = torch.sigmoid(cls_logits.max(dim=-1).values)
    if score_factors is not None:
        # non-negative factors commute with the per-point max
        score_factors = score_factors.float()
        point_max = point_max * score_factors
    if point_valid is not None:
        point_max = torch.where(point_valid, point_max, torch.zeros_like(point_max))
    if spec.per_level_limit > 0:
        # LFDv2 (`lfdtpu/ops/decode.py:142-160`): per level, its top `lim`
        # points when it has more than `lim`, else all of them; then concat
        assert level_sizes is not None and sum(level_sizes) == P, (
            "per_level_limit needs static level_sizes summing to P")
        lim, off, parts = spec.per_level_limit, 0, []
        for n in level_sizes:
            if n > lim:
                parts.append(_top_k(point_max[:, off:off + n], lim)[1] + off)
            else:
                parts.append(torch.arange(off, off + n, device=point_max.device)
                             .expand(B, n))
            off += n
        top_idx = torch.cat(parts, dim=1)
        kp = top_idx.shape[1]
    else:
        kp = min(spec.pre_nms_points, P)
        _, top_idx = _top_k(point_max, kp)  # (B, Kp)

    sel_logits = _gather_rows(cls_logits, top_idx)
    if spec.use_softmax:
        sel_probs = torch.softmax(sel_logits, dim=-1)[..., :C]
    else:
        sel_probs = torch.sigmoid(sel_logits)
    if score_factors is not None:
        sel_probs = sel_probs * torch.gather(score_factors, 1, top_idx)[..., None]
    if point_valid is not None:
        sel_valid = torch.gather(point_valid, 1, top_idx)
        sel_probs = torch.where(sel_valid[..., None], sel_probs,
                                torch.zeros_like(sel_probs))
    sel_reg = _gather_rows(reg, top_idx)
    sel_points = points[top_idx]  # (B, Kp, 2)
    sel_ranges = ranges[top_idx]

    # stage 2: (point, class) pairs above threshold, top nms_budget
    flat_scores = sel_probs.reshape(B, -1)
    flat_valid = flat_scores > spec.score_thr
    kb = min(spec.nms_budget, kp * C)
    cand_scores, cand_flat = _top_k(
        torch.where(flat_valid, flat_scores, torch.full_like(flat_scores, -1.0)), kb
    )
    cand_point = cand_flat // C
    cand_label = (cand_flat % C).to(torch.int32)
    cand_valid = cand_scores > spec.score_thr

    # stage 3: decode candidate boxes, class-offset NMS
    dist = _decode_distances(_gather_rows(sel_reg, cand_point),
                             _gather_rows(sel_ranges, cand_point), spec.reg_mode)
    px = _gather_rows(sel_points, cand_point)
    h = image_hw[:, 0:1].float()
    w = image_hw[:, 1:2].float()
    x1 = torch.minimum((px[..., 0] - dist[..., 0]).clamp_min(0), w)
    y1 = torch.minimum((px[..., 1] - dist[..., 1]).clamp_min(0), h)
    x2 = torch.minimum((px[..., 0] + dist[..., 2]).clamp_min(0), w)
    y2 = torch.minimum((px[..., 1] + dist[..., 3]).clamp_min(0), h)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)

    keep = batched_nms(boxes, cand_scores, cand_label, spec.nms_iou,
                       valid=cand_valid, class_agnostic=spec.class_agnostic,
                       use_kernel=spec.nms_use_kernel)

    # final order: the kept rows by descending score, ties by ascending index
    masked = torch.where(keep, cand_scores, torch.full_like(cand_scores, float("-inf")))
    md = spec.max_det
    k = min(md, kb)
    _, out_idx = _top_k(masked, k)
    out_keep = torch.gather(keep, 1, out_idx)
    if md > k:  # fewer candidates than max_det: pad with dead rows
        out_idx = torch.cat([out_idx, out_idx.new_zeros((B, md - k))], dim=1)
        out_keep = torch.cat([out_keep, out_keep.new_zeros((B, md - k))], dim=1)
    count = out_keep.sum(dim=-1, dtype=torch.int32)

    out_boxes = _gather_rows(boxes, out_idx)
    return dict(
        boxes=torch.where(out_keep[..., None], out_boxes, torch.zeros_like(out_boxes)),
        scores=torch.where(out_keep, torch.gather(cand_scores, 1, out_idx),
                           torch.zeros_like(out_keep, dtype=cand_scores.dtype)),
        labels=torch.where(out_keep, torch.gather(cand_label, 1, out_idx),
                           torch.zeros_like(out_keep, dtype=torch.int32)),
        count=count,
        candidates=cand_valid.sum(dim=-1, dtype=torch.int32),
    )


def detections_to_lists(decoded, resize_scale=1.0):
    """Host side: one image's fixed-size decode output (numpy or tensors) ->
    reference result rows [class_label, score, x1, y1, w, h] with
    w = x2 - x1 + 1 (`lfd.py:646-654`)."""
    decoded = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
               for k, v in decoded.items()}
    count = int(decoded["count"])
    boxes = decoded["boxes"][:count] / float(resize_scale)
    scores = decoded["scores"][:count]
    labels = decoded["labels"][:count]
    results = []
    for i in range(count):
        x1, y1, x2, y2 = boxes[i]
        results.append(
            [int(labels[i]), float(scores[i]), float(x1), float(y1),
             float(x2 - x1 + 1), float(y2 - y1 + 1)]
        )
    return results
