# K1: greedy-NMS keep mask, hand-written CUDA (`lfdtpu_torch/csrc/nms.cu`).
#
# Replaces `lfdtpu/ops/nms_pallas.py::nms_mask_pallas_sorted` (fixpoint sweeps
# over a VMEM-resident suppression matrix). On the H100 the work is tiny and
# the cost is the serial greedy chain: the CUDA version builds a 64-box IoU
# bitmask over the upper triangle on many SMs, then one block per image walks
# the chain a 64-box chunk at a time from shared memory, with no host sync and
# no K limit below the one the kernel has always had.
#
# The plain PyTorch version below is the fixpoint of the TPU kernel, batched.
# Both must give the same mask bit for bit.
#
# The kernel is the custom op `lfd::nms_mask_sorted` (torch.library): its CUDA
# kernel is the launch, its CPU kernel the plain version, so a program
# exported with torch.export (deploy/engine_io.py) calls it like any aten op.
# `lfd::nms_mask_sorted_plain` is the plain version as an op of its own, on
# both devices: what an engine built with nms_use_kernel=False calls, since
# its convergence loop asks the device whether the mask still changes, which
# export cannot trace.

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


def nms_mask_sorted_plain(boxes_sorted, valid_sorted, iou_thr, fixed_rounds=None):
    """Plain version of K1: keep = valid & !(any kept earlier row with
    IoU > thr), iterated to its fixpoint (the suppression chain depth).

    boxes_sorted (B, K, 4) f32 xyxy, sorted by descending score;
    valid_sorted (B, K) bool. Returns (B, K) bool, in sorted order.
    fixed_rounds: run K - 1 rounds without asking whether the mask still
    changes (no host sync); None means only inside a CUDA-graph capture."""
    K = boxes_sorted.shape[1]
    upper = torch.ones(K, K, dtype=torch.bool, device=boxes_sorted.device).triu(1)
    sup = (_iou_matrix(boxes_sorted.float()) > iou_thr) & upper
    sup = sup & valid_sorted[:, :, None]
    keep = valid_sorted
    if fixed_rounds is None:
        fixed_rounds = boxes_sorted.is_cuda and torch.cuda.is_current_stream_capturing()
    if fixed_rounds:
        # Inside a CUDA-graph capture the loop cannot ask the device whether
        # it has converged (that is a host sync). Round t settles row t at
        # the latest and a settled mask stays as it is, so K - 1 rounds give
        # the same mask, at K times the work: the oracle's price when it is
        # captured.
        for _ in range(K - 1):
            keep = valid_sorted & ~(sup & keep[:, :, None]).any(dim=1)
        return keep
    while True:
        suppressed = (sup & keep[:, :, None]).any(dim=1)
        new_keep = valid_sorted & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def walk_cases(B, K):
    """The greedy walk's hard cases at thr 0.4, each a pair of CPU tensors:
    boxes (B, K, 4) f32, already sorted (box i ranks above box i + 1), and
    valid (B, K) bool, all true. Image b is shifted b to the right.

    chain: boxes 10 wide, each 3 to the right of the last (IoU(i, i+1) = 7/13,
        IoU(i, i+2) = 1/4), so box i suppresses only box i + 1 and greedy
        keeps every other box;
    all kept: disjoint boxes on a grid 64 boxes wide;
    all suppressed: identical boxes, the first kept."""
    i = torch.arange(K, dtype=torch.float32)[None]
    shift = torch.arange(B, dtype=torch.float32)[:, None]
    zero = torch.zeros(B, K)
    layouts = {"chain": (i * 3 + shift, zero, 10.0),
               "all kept": ((i % 64) * 20 + shift, (i // 64) * 20 + zero, 10.0),
               "all suppressed": (5.0 + shift + zero, 5.0 + zero, 20.0)}
    return {name: (torch.stack([x, y, x + side, y + side], -1),
                   torch.ones(B, K, dtype=torch.bool))
            for name, (x, y, side) in layouts.items()}


def scratch_words(B, K):
    """Length of K1's int64 scratch (`csrc/nms.cu::image_words` per image):
    cb = ceil(K / 64) words of valid bits (padded to an even count), 64 * cb
    diagonal words and the packed upper triangle of the 64-box word mask."""
    cb = (K + 63) // 64
    return B * (cb + cb % 2 + 32 * cb * (cb + 1))


@torch.library.custom_op("lfd::nms_mask_sorted", mutates_args=(), device_types="cpu")
def _nms_op(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
            iou_thr: float) -> torch.Tensor:
    """K1's CPU kernel: the plain version (a copy: an op's output never
    aliases its input)."""
    return nms_mask_sorted_plain(boxes_sorted, valid_sorted, iou_thr).clone()


@_nms_op.register_kernel("cuda")
def _nms_cuda(boxes_sorted, valid_sorted, iou_thr):
    """K1's CUDA kernel: the launch on the current stream, counted."""
    B, K = boxes_sorted.shape[:2]
    dev = boxes_sorted.device
    kernel_lib.check_cuda("nms boxes", boxes_sorted, torch.float32, (B, K, 4), dev)
    kernel_lib.check_cuda("nms valid", valid_sorted, torch.bool, (B, K), dev)
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    scratch = torch.empty(scratch_words(B, K), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        kernel_lib.launch(
            "lfd_nms_mask_sorted", boxes_sorted.data_ptr(), valid_sorted.data_ptr(),
            keep.data_ptr(), scratch.data_ptr(), B, K, float(iou_thr),
            kernel_lib.stream_of(boxes_sorted),
        )
    nms_mask_sorted.launches += 1
    return keep


@_nms_op.register_fake
def _nms_fake(boxes_sorted, valid_sorted, iou_thr):
    return boxes_sorted.new_empty(boxes_sorted.shape[:2], dtype=torch.bool)


@torch.library.custom_op("lfd::nms_mask_sorted_plain", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _nms_plain_op(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                  iou_thr: float) -> torch.Tensor:
    """The plain version on either device (K - 1 fixed rounds inside a
    CUDA-graph capture)."""
    return nms_mask_sorted_plain(boxes_sorted, valid_sorted, iou_thr).clone()


_nms_plain_op.register_fake(_nms_fake)


def nms_mask_sorted(boxes_sorted, valid_sorted, iou_thr):
    """Greedy-NMS keep mask for boxes sorted by descending score, batched:
    the op lfd::nms_mask_sorted.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    raise on anything it does not take). boxes_sorted (B, K, 4) f32,
    valid_sorted (B, K) bool -> (B, K) bool."""
    return torch.ops.lfd.nms_mask_sorted(boxes_sorted, valid_sorted, float(iou_thr))


def nms_mask_sorted_plain_op(boxes_sorted, valid_sorted, iou_thr):
    """nms_mask_sorted_plain as the op lfd::nms_mask_sorted_plain, on either
    device: nms_mask's route with use_kernel=False."""
    return torch.ops.lfd.nms_mask_sorted_plain(boxes_sorted, valid_sorted, float(iou_thr))


nms_mask_sorted.launches = 0
