# K1: greedy-NMS keep mask, hand-written CUDA (`lfdtpu_torch/csrc/nms.cu`).
#
# Replaces `lfdtpu/ops/nms_pallas.py::nms_mask_pallas_sorted` (fixpoint sweeps
# over a VMEM-resident suppression matrix). On the H100 the work is tiny and
# the cost is the serial greedy chain plus launches: the CUDA version builds a
# 64-box IoU bitmask in one launch and walks the greedy chain on the device in
# a second, one block per image, with no host sync and no K limit.
#
# The plain PyTorch version below is the fixpoint of the TPU kernel, batched.
# Both must give the same mask bit for bit.

from __future__ import annotations

import torch

from . import kernel_lib


def _iou_matrix(boxes):
    """(B, K, K) exclusive-area IoU, `lfdtpu/ops/nms.py::_iou_matrix`."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    xx1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    yy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    xx2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    yy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = (xx2 - xx1).clamp_min(0) * (yy2 - yy1).clamp_min(0)
    union = area[:, :, None] + area[:, None, :] - inter
    return inter / union.clamp_min(1e-12)


def nms_mask_sorted_plain(boxes_sorted, valid_sorted, iou_thr):
    """Plain version of K1: keep = valid & !(any kept earlier row with
    IoU > thr), iterated to its fixpoint (the suppression chain depth).

    boxes_sorted (B, K, 4) f32 xyxy, sorted by descending score;
    valid_sorted (B, K) bool. Returns (B, K) bool, in sorted order."""
    K = boxes_sorted.shape[1]
    upper = torch.ones(K, K, dtype=torch.bool, device=boxes_sorted.device).triu(1)
    sup = (_iou_matrix(boxes_sorted.float()) > iou_thr) & upper
    sup = sup & valid_sorted[:, :, None]
    keep = valid_sorted
    while True:
        suppressed = (sup & keep[:, :, None]).any(dim=1)
        new_keep = valid_sorted & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def nms_mask_sorted(boxes_sorted, valid_sorted, iou_thr):
    """Greedy-NMS keep mask for boxes sorted by descending score, batched.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    raise on anything it does not take). boxes_sorted (B, K, 4) f32,
    valid_sorted (B, K) bool -> (B, K) bool."""
    if not boxes_sorted.is_cuda:
        return nms_mask_sorted_plain(boxes_sorted, valid_sorted, iou_thr)
    B, K = boxes_sorted.shape[:2]
    dev = boxes_sorted.device
    kernel_lib.check_cuda("nms boxes", boxes_sorted, torch.float32, (B, K, 4), dev)
    kernel_lib.check_cuda("nms valid", valid_sorted, torch.bool, (B, K), dev)
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes_sorted.device)
    col_blocks = (K + 63) // 64
    scratch = torch.empty((B, K, col_blocks), dtype=torch.int64,
                          device=boxes_sorted.device)
    with torch.cuda.device(boxes_sorted.device):
        kernel_lib.launch(
            "lfd_nms_mask_sorted", boxes_sorted.data_ptr(),
            valid_sorted.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
            B, K, float(iou_thr), kernel_lib.stream_of(boxes_sorted),
        )
    nms_mask_sorted.launches += 1
    return keep


nms_mask_sorted.launches = 0
