# Box geometry primitives (`lfdtpu/ops/boxes.py`), on torch tensors of any
# leading batch shape.
#
# Conventions follow the reference exactly:
#   - Annotations are xywh with inclusive pixel extents: x2 = x1 + w - 1
#     (reference `lfd/model/lfd.py:201-205`, result rows `lfd.py:646-654`).
#   - Decoded/IoU boxes are xyxy with *exclusive* area math (no +1), matching
#     `lfd/model/losses/iou_loss.py:11-102`.

from __future__ import annotations

import torch


def xywh_to_xyxy(boxes, inclusive=True):
    """[x, y, w, h] -> [x1, y1, x2, y2]; x2 = x1+w-1 when inclusive."""
    off = 1.0 if inclusive else 0.0
    x1 = boxes[..., 0]
    y1 = boxes[..., 1]
    x2 = boxes[..., 0] + boxes[..., 2] - off
    y2 = boxes[..., 1] + boxes[..., 3] - off
    return torch.stack([x1, y1, x2, y2], dim=-1)


def xyxy_to_xywh(boxes, inclusive=True):
    """[x1, y1, x2, y2] -> [x, y, w, h]; w = x2-x1+1 when inclusive."""
    off = 1.0 if inclusive else 0.0
    w = boxes[..., 2] - boxes[..., 0] + off
    h = boxes[..., 3] - boxes[..., 1] + off
    return torch.stack([boxes[..., 0], boxes[..., 1], w, h], dim=-1)


def distance2bbox(points, distance, max_shape=None):
    """Decode (l, t, r, b) distances at `points` into xyxy boxes
    (`lfd/model/lfd.py:261-282`), optionally clamped to (h, w) of
    `max_shape`. points (..., 2), distance (..., 4)."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        h, w = max_shape
        x1 = x1.clamp(0, w)
        y1 = y1.clamp(0, h)
        x2 = x2.clamp(0, w)
        y2 = y2.clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox2distance(points, bboxes):
    """Inverse of distance2bbox: xyxy boxes -> (l, t, r, b) at `points`."""
    l = points[..., 0] - bboxes[..., 0]
    t = points[..., 1] - bboxes[..., 1]
    r = bboxes[..., 2] - points[..., 0]
    b = bboxes[..., 3] - points[..., 1]
    return torch.stack([l, t, r, b], dim=-1)


def _area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def bbox_overlaps(bboxes1, bboxes2, mode="iou", is_aligned=False, eps=1e-6):
    """Pairwise / aligned IoU (or IoF) of xyxy boxes, union clamped to
    >= eps. Shapes: (..., m, 4) x (..., n, 4) -> (..., m, n), or aligned
    (..., m, 4) x (..., m, 4) -> (..., m)."""
    assert mode in ("iou", "iof")
    if not is_aligned:
        bboxes1 = bboxes1[..., :, None, :]
        bboxes2 = bboxes2[..., None, :, :]
    lt = torch.maximum(bboxes1[..., :2], bboxes2[..., :2])
    rb = torch.minimum(bboxes1[..., 2:], bboxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    area1 = _area(bboxes1)
    if mode == "iou":
        union = area1 + _area(bboxes2) - overlap
    else:
        union = area1.expand(overlap.shape)
    return overlap / union.clamp(min=eps)
