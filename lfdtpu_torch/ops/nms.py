# Non-maximum suppression, device path (`lfdtpu/ops/nms.py:162-241`):
# exact greedy semantics (sort by score desc, suppress IoU > thr,
# exclusive-area IoU), batched over images, shape-static. The keep mask
# itself is K1 (`nms_kernel.py`).

from __future__ import annotations

import torch

from .nms_kernel import nms_mask_sorted, nms_mask_sorted_plain


def nms_mask(boxes, scores, iou_thr, valid=None, use_kernel=True):
    """Exact greedy-NMS keep mask.

    boxes (B, K, 4) xyxy in any order, scores (B, K) for the greedy order,
    valid (B, K) bool: invalid rows never keep nor suppress.
    use_kernel: route the mask through K1's wrapper (which launches the CUDA
    kernel for CUDA tensors); False forces the plain version.
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
    fn = nms_mask_sorted if use_kernel else nms_mask_sorted_plain
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
