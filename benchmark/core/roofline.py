"""The yardstick of the hand-written kernels: what one launch must move and
compute, and the least time an H100 could take for it.

A frozen copy of the port's on-card check (`kernel_work`, `kernel_bound_ms`):
each input byte read once and each output byte written once, the operations
the inputs need; published NVIDIA H100 SXM peaks (dense): 3.35 TB/s of HBM,
989 TFLOP/s bf16 on the tensor cores, 1,979 TOP/s int8, 67 TFLOP/s fp32.

`frame_launches(cfg, hw)` lists the K1-K3 launches one served frame of a
configuration makes, from the configuration's plan: K2 (the uint8 stem) once,
K3 (the 64-channel 3x3 pair conv) twice for every stride-1 64-channel
FasterBlock with BatchNorm, K1 (the NMS keep mask) once over the decode's
candidate budget.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
IOU_FLOPS = 14  # per box pair: 4 min/max, 2 sub, 2 clamp, mul, 2 add/sub, max, div, compare

# the kernels' names in a profile (K1 is two kernels: the IoU and the walk)
KERNEL_NAMES = {"nms_mask_sorted": ("nms_iou_kernel", "nms_walk_kernel"),
                "stem_conv": ("stem_conv_kernel",),
                "pair_conv3x3": ("pair_conv_kernel",)}


def kernel_work(name, shape, residual=False):
    """(bytes, operations, their type) of one launch. shape: (N, H, W) of
    K3's activations or K2's frame; (B, K) for K1."""
    if name == "pair_conv3x3":
        n, h, w = shape
        act = n * h * w * 64 * 2  # bf16 NHWC
        weights = 9 * 64 * 64 * 2 + 2 * 64 * 4  # + fp32 scale, bias
        return act * (3 if residual else 2) + weights, 2 * n * h * w * 64 * 9 * 64, "bf16"
    if name == "stem_conv":
        n, h, w = shape
        out = n * ((h + 1) // 2) * ((w + 1) // 2)
        consts = 27 * 64 * 4 + 2 * 3 * 4 + 2 * 64 * 4  # fp32 weights, mean/std, scale/bias
        return n * h * w * 3 + out * 64 * 2 + consts, 2 * out * 64 * 27, "bf16"
    if name == "nms_mask_sorted":
        b, k = shape  # fp32 xyxy boxes and a bool mask in, a bool mask out
        return b * k * (16 + 1 + 1), b * k * (k - 1) // 2 * IOU_FLOPS, "fp32"
    raise ValueError(f"unknown kernel {name}")


def kernel_bound_s(name, shape, residual=False):
    """The larger of the launch's bytes over the memory rate and its
    operations over the peak rate of their type, in seconds."""
    nbytes, ops, kind = kernel_work(name, shape, residual)
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[kind])


def frame_launches(cfg, hw, batch=1):
    """[(kernel, shape, residual)] of one served call of `batch` frames at
    the padded size hw, with K1-K3 switched on as the configuration serves."""
    s = cfg["serve"]
    out = []
    bb = cfg["backbone"]
    if s.get("kernel_stem") and bb["stem_channels"] == 64:
        out.append(("stem_conv", (batch, hw[0], hw[1]), False))
    if s.get("kernel_convs") and s["precision"] == "bf16" and bb["block"] == "faster":
        stem = 2 if bb["stem"] == "fast" else 4
        h, w = -(-hw[0] // stem), -(-hw[1] // stem)
        taps = sorted(tuple(t) for t in bb["out_indices"])
        last = max(t[0] for t in taps)
        for i, (n, ch) in enumerate(list(zip(bb["arch"], bb["channels"]))[:last + 1]):
            h, w = -(-h // 2), -(-w // 2)
            for j in range(1, n):  # block 0 of a stage strides and projects
                if ch == 64:
                    out.append(("pair_conv3x3", (batch, h, w), False))
                    out.append(("pair_conv3x3", (batch, h, w), True))
    if s.get("nms_use_kernel", True):
        k = min(cfg["pre_nms_bbox_limit"], cfg["pre_nms_bbox_limit"] * cfg["num_classes"])
        out.append(("nms_mask_sorted", (batch, k), False))
    return out


def frame_bound_s(cfg, hw, batch=1):
    """{kernel: seconds} of the bounds of one call's launches, summed by kernel."""
    bounds = {}
    for name, shape, residual in frame_launches(cfg, hw, batch):
        bounds[name] = bounds.get(name, 0.0) + kernel_bound_s(name, shape, residual)
    return bounds
