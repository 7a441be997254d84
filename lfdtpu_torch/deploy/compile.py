# Deployment engine (`lfdtpu/deploy/compile.py`, the counterpart of the
# reference's TensorRT `build_engine.py:22-152`): one end-to-end callable
# (device preprocess -> conv net -> decode -> class-offset NMS) at a fixed
# input resolution and precision:
#   fp32 -> float32 weights and math   (reference TRT fp32 engine)
#   bf16 -> bfloat16 weights and math  (reference TRT fp16 engine)
# It takes raw uint8 NHWC frames (padded to the resolution bucket) and
# returns fixed-shape detections, decode and NMS included.
#
# The engine holds its own copy of the weights and the point grids on its
# device and runs eagerly (a CUDA-graph engine is later work). The int8,
# split, s2d_stem, mesh, approx_topk, int8_head_dtype and output_dtype
# options of the JAX engine are not ported yet.

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .kernel_net import attach_kernels, prepack_stem

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def cast_variables(net, dtype):
    """A copy of `net` with every floating parameter and buffer in `dtype`
    (lfdtpu casts params + batch_stats the same way)."""
    return copy.deepcopy(net).to(dtype)


class DevicePreprocess(nn.Module):
    """Device-side normalization matching the host Normalize transform
    (`augmentation_pipeline.py:14-36`): the host ships raw uint8 frames.
    `mean`/`std` are in pixel units; the stem kernel folds them in."""

    def __init__(self, mean, std, bgr2rgb=False):
        super().__init__()
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32))
        self.register_buffer("std", torch.as_tensor(std, dtype=torch.float32))
        self.bgr2rgb = bgr2rgb

    def forward(self, image):
        x = image.float()
        if self.bgr2rgb:
            x = x.flip(-1)
        return (x - self.mean) / self.std


def make_device_preprocess(mean, std, max_pixel_value=255.0, bgr2rgb=False):
    mean = np.asarray(mean, np.float32) * max_pixel_value
    std = np.asarray(std, np.float32) * max_pixel_value
    return DevicePreprocess(mean, std, bgr2rgb)


def _pack_detections(out):
    """The decode dict as ONE (B, max_det, 7) tensor
    [x1, y1, x2, y2, score, label, valid]; host side: unpack_detections."""
    boxes, scores = out["boxes"], out["scores"]
    md = boxes.shape[-2]
    valid = (torch.arange(md, device=boxes.device) < out["count"][..., None])
    return torch.cat([boxes, scores[..., None],
                      out["labels"][..., None].to(boxes.dtype),
                      valid[..., None].to(boxes.dtype)], dim=-1)


def unpack_detections(packed):
    """Host-side inverse of pack_output: (..., max_det, 7) -> the decode
    dict (numpy): boxes, scores, labels (int32), count (int32)."""
    a = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    return dict(
        boxes=a[..., :4],
        scores=a[..., 4],
        labels=a[..., 5].astype(np.int32),
        count=a[..., 6].astype(np.int32).sum(axis=-1),
    )


class Engine:
    """Compiled engine: engine(images, valid_hw) -> decoded dict of tensors
    on the engine's device (or the packed tensor with pack_output).

    images: (B, H, W, 3) uint8 numpy array or tensor at input_resolution;
    valid_hw: (2,) shared or (B, 2) per-image unpadded extents.
    `dense` and `decode` expose the two halves for checks and timing."""

    def __init__(self, detector, net, preprocess, spec, input_hw, precision,
                 batch_size, device, pack_output, kernel_stem):
        self.detector = detector
        self.net = net
        self.preprocess = preprocess
        self.spec = spec
        self.input_resolution = input_hw
        self.precision_mode = precision
        self.batch_size = batch_size
        self.device = device
        self.pack_output = pack_output
        self.kernel_stem = kernel_stem
        self.compute_dtype = _DTYPES[precision]
        self.level_arrays = detector.level_arrays(input_hw, device)

    def _images(self, images):
        x = torch.as_tensor(images)
        if x.ndim != 4 or tuple(x.shape[1:3]) != self.input_resolution:
            raise ValueError(f"expected (B, {self.input_resolution[0]}, "
                             f"{self.input_resolution[1]}, C) images, got {tuple(x.shape)}")
        if x.shape[0] != self.batch_size:
            raise ValueError(f"engine batch_size is {self.batch_size}, got {x.shape[0]}")
        return x.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def dense(self, images):
        """Raw frames -> dense (cls (B, P, Cc), reg (B, P, 4)) in the
        engine's dtype."""
        x = self._images(images)
        if self.kernel_stem:
            if x.dtype != torch.uint8:
                raise ValueError("the stem kernel consumes raw uint8 frames")
        else:
            if self.preprocess is not None:
                x = self.preprocess(x)
            x = x.to(self.compute_dtype)
        return self.net(x)

    @torch.inference_mode()
    def decode(self, cls_o, reg_o, valid_hw):
        vhw = torch.as_tensor(valid_hw, dtype=torch.float32).to(self.device)
        vhw = vhw.reshape(-1, 2).expand(cls_o.shape[0], 2)
        out = self.detector.decode_batch(
            (cls_o.float(), reg_o.float()), self.input_resolution, vhw,
            self.spec, level_arrays=self.level_arrays)
        return _pack_detections(out) if self.pack_output else out

    def __call__(self, images, valid_hw):
        cls_o, reg_o = self.dense(images)
        return self.decode(cls_o, reg_o, valid_hw)


def compile_inference(
    detector,
    input_hw,
    precision="fp32",
    preprocess=None,
    classification_threshold=None,
    nms_threshold=None,
    class_agnostic=False,
    max_det=None,
    batch_size=1,
    nms_use_kernel=True,
    kernel_convs=False,
    kernel_stem=False,
    pack_output=False,
    pre_nms_points=None,
    nms_budget=None,
    device=None,
):
    """Build one inference engine from `detector` (its net's current
    weights) on `device`: the card ("cuda") unless the caller asks for
    another (device="cpu" serves on the CPU); without a CUDA device an
    omitted device raises.

    Kernel switches (the JAX knobs in brackets), with lfdtpu's defaults:
      nms_use_kernel [nms_use_pallas], default on: K1 for CUDA tensors.
      kernel_convs [pallas_convs], default off: eligible FasterBlocks run as
        two K3 launches each (bf16 engines; fp32 activations stay on
        F.conv2d, as lfdtpu's eligibility leaves fp32 on XLA).
      kernel_stem [pallas_stem], default off: normalize + stem0 conv + BN +
        ReLU as one K2 launch on the raw uint8 frame; needs precision "bf16",
        a make_device_preprocess preprocess, and a 3 -> 64 BatchNorm stem0.
    On CPU tensors every switch runs the kernels' plain versions.
    """
    input_hw = (int(input_hw[0]), int(input_hw[1]))
    if precision not in _DTYPES:
        raise ValueError(f"unknown precision {precision}")
    spec = detector.decode_spec(classification_threshold, nms_threshold,
                                class_agnostic, max_det)
    spec = dataclasses.replace(spec, nms_use_kernel=bool(nms_use_kernel))
    if pre_nms_points is not None:
        spec = dataclasses.replace(spec, pre_nms_points=int(pre_nms_points))
    if nms_budget is not None:
        spec = dataclasses.replace(spec, nms_budget=int(nms_budget))
    device = resolve_device(device)

    net = cast_variables(detector.net, _DTYPES[precision])
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    if preprocess is not None:
        preprocess = copy.deepcopy(preprocess).to(device)

    stem_pack = None
    if kernel_stem:
        if precision != "bf16":
            raise ValueError("kernel_stem requires precision='bf16'")
        if not isinstance(preprocess, DevicePreprocess):
            raise ValueError("kernel_stem needs a make_device_preprocess "
                             "preprocess (its mean/std fold into the stem kernel)")
        stem_pack = prepack_stem(net, preprocess.mean, preprocess.std,
                                 bgr2rgb=preprocess.bgr2rgb)
        if stem_pack is None:
            raise ValueError("kernel_stem: the backbone's stem0 is not a "
                             "conv 3x3/s2 3 -> 64 + BatchNorm + ReLU")
    attach_kernels(net, block_kernels=kernel_convs and precision == "bf16",
                   stem_pack=stem_pack)
    return Engine(detector, net, preprocess, spec, input_hw, precision,
                  batch_size, device, pack_output, stem_pack is not None)
