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
# device. On a CUDA device it is ONE captured CUDA graph (dense + decode +
# pack) that a call replays, the counterpart of lfdtpu's single jitted
# program (`lfdtpu/deploy/compile.py:403-444`); on the CPU, or when asked
# (captured=False), it runs eagerly. A capture that fails raises: no engine
# quietly runs eagerly in its place. What breaks a capture: a host sync
# (.item(), .cpu(), torch.equal, a boolean-mask index), a tensor made from
# host data, or a CUDA allocation outside torch's allocator, anywhere in
# Engine._forward.
#
# The int8, split, s2d_stem, mesh, approx_topk, int8_head_dtype and
# output_dtype options of the JAX engine are not ported yet.

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.conv_kernels import pair_conv3x3, stem_conv
from ..ops.nms_kernel import nms_mask_sorted
from .kernel_net import attach_kernels, prepack_stem

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
_WARMUP_CALLS = 3  # eager calls before a capture


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


_COUNTED = (nms_mask_sorted, stem_conv, pair_conv3x3)  # the kernel wrappers


def _launch_counts():
    return {fn.__name__: fn.launches for fn in _COUNTED}


class Engine:
    """Compiled engine: engine(images, valid_hw) -> decoded dict of tensors
    on the engine's device (or the packed tensor with pack_output).

    images: (B, H, W, 3) numpy array or tensor at input_resolution (a
    captured engine takes raw uint8 frames only);
    valid_hw: (2,) shared or (B, 2) per-image unpadded extents.
    `dense` and `decode` expose the two halves, always eager, for checks and
    timing.

    A captured engine (`captured`, the default on a CUDA device) holds
    dense + decode (+ pack) as ONE CUDA graph over static buffers and a call
    replays it: the counterpart of lfdtpu's single jitted program. A numpy
    frame goes through one pinned staging buffer and an asynchronous copy
    on the current stream; a CUDA tensor is copied into the static input.
    The host does no allocation per call. A call runs on the current stream;
    calls from different streams share the graph's buffers, so the caller
    orders them. `captured_launches` holds how
    often the graph launches each hand-written kernel (their wrappers'
    counters tick while the graph is captured, not when it replays)."""

    def __init__(self, detector, net, preprocess, spec, input_hw, precision,
                 batch_size, device, pack_output, kernel_stem, captured=False):
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
        self.captured = False
        self.captured_launches = None
        if captured:
            self._capture()
            self.captured = True

    # ---------------------------------------------------------- host side
    def _check_images(self, images):
        shape = tuple(images.shape)
        if len(shape) != 4 or shape[1:3] != self.input_resolution:
            raise ValueError(f"expected (B, {self.input_resolution[0]}, "
                             f"{self.input_resolution[1]}, C) images, got {shape}")
        if shape[0] != self.batch_size:
            raise ValueError(f"engine batch_size is {self.batch_size}, got {shape[0]}")

    def _images(self, images):
        x = torch.as_tensor(images)
        self._check_images(x)
        return x.to(self.device, non_blocking=True)

    def _valid_hw(self, valid_hw):
        vhw = torch.as_tensor(valid_hw, dtype=torch.float32).to(self.device)
        return vhw.reshape(-1, 2).expand(self.batch_size, 2)

    # -------------------------------------------------------- device side
    # Everything below takes tensors on the engine's device and touches no
    # host data, makes no host sync and has no data-dependent shape: it is
    # what a captured engine records.
    def _dense(self, x):
        if self.kernel_stem:
            if x.dtype != torch.uint8:
                raise ValueError("the stem kernel consumes raw uint8 frames")
        else:
            if self.preprocess is not None:
                x = self.preprocess(x)
            x = x.to(self.compute_dtype)
        return self.net(x)

    def _decode(self, cls_o, reg_o, vhw):
        out = self.detector.decode_batch(
            (cls_o.float(), reg_o.float()), self.input_resolution, vhw,
            self.spec, level_arrays=self.level_arrays)
        return _pack_detections(out) if self.pack_output else out

    @torch.inference_mode()
    def _forward(self, x, vhw):
        return self._decode(*self._dense(x), vhw)

    # ------------------------------------------------------- eager halves
    @torch.inference_mode()
    def dense(self, images):
        """Raw frames -> dense (cls (B, P, Cc), reg (B, P, 4)) in the
        engine's dtype (eager)."""
        return self._dense(self._images(images))

    @torch.inference_mode()
    def decode(self, cls_o, reg_o, valid_hw):
        """Dense outputs -> detections (eager)."""
        return self._decode(cls_o, reg_o, self._valid_hw(valid_hw))

    # ------------------------------------------------------------ capture
    def _capture(self):
        if self.device.type != "cuda":
            raise RuntimeError(f"a captured engine needs a CUDA device, not {self.device}; "
                               "on the CPU build an eager one (captured=False)")
        dev, shape = self.device, (self.batch_size, *self.input_resolution, 3)
        with torch.cuda.device(dev):
            self._in = torch.zeros(shape, dtype=torch.uint8, device=dev)
            self._vhw = torch.tensor([self.input_resolution] * self.batch_size,
                                     dtype=torch.float32, device=dev)
            self._in_host = torch.zeros(shape, dtype=torch.uint8).pin_memory()
            self._vhw_host = torch.zeros((self.batch_size, 2)).pin_memory()
            self._in_host_np, self._vhw_host_np = self._in_host.numpy(), self._vhw_host.numpy()
            # set after each call's asynchronous copies out of the staging
            # buffers: the next call waits for it before it overwrites them
            self._staged = torch.cuda.Event()
            # Eager calls on a side stream first: the kernels' build and
            # load at first use, cuDNN's plan selection and CUDA's lazy
            # module loading must all be over before the capture begins.
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_CALLS):
                    self._forward(self._in, self._vhw)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            try:
                # thread_local: another thread's CUDA calls (a loader
                # pinning memory) do not fail this capture
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    out = self._forward(self._in, self._vhw)
            except Exception as e:
                # never an eager engine in its place
                torch.cuda.synchronize(dev)
                raise RuntimeError(
                    f"capturing the engine into a CUDA graph failed: {e}") from e
            self.captured_launches = {k: v - before[k] for k, v in _launch_counts().items()}
            self._graph, self._out = graph, out

    def _load(self, images, valid_hw):
        """Put one call's inputs into the static buffers, in stream order."""
        if not isinstance(images, (torch.Tensor, np.ndarray)):
            images = np.asarray(images)
        self._check_images(images)
        if images.dtype != (torch.uint8 if isinstance(images, torch.Tensor) else np.uint8):
            raise ValueError(f"a captured engine takes raw uint8 frames, got {images.dtype}: "
                             "build an eager engine (captured=False) for other input")
        host_in = not (isinstance(images, torch.Tensor) and images.is_cuda)
        host_vhw = not (isinstance(valid_hw, torch.Tensor) and valid_hw.is_cuda)
        if host_in or host_vhw:
            self._staged.synchronize()
        if host_in:
            if isinstance(images, torch.Tensor):
                self._in_host.copy_(images)
            else:
                np.copyto(self._in_host_np, images)
            self._in.copy_(self._in_host, non_blocking=True)
        else:
            self._in.copy_(images)
        if host_vhw:
            self._vhw_host_np[...] = np.asarray(valid_hw, np.float32).reshape(-1, 2)
            self._vhw.copy_(self._vhw_host, non_blocking=True)
        else:
            self._vhw.copy_(valid_hw.reshape(-1, 2))
        if host_in or host_vhw:
            self._staged.record()

    def __call__(self, images, valid_hw):
        if not self.captured:
            x, vhw = self._images(images), self._valid_hw(valid_hw)
            return self._forward(x, vhw)
        with torch.cuda.device(self.device):
            self._load(images, valid_hw)
            self._graph.replay()
            # Copies, so that call n's result survives call n + 1 (the
            # graph writes the same output tensors every replay): one small
            # device copy per output, max_det rows each (B x 100 x 7 floats
            # when packed, four such launches for the dict).
            if self.pack_output:
                return self._out.clone()
            return {k: v.clone() for k, v in self._out.items()}


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
    captured=None,
):
    """Build one inference engine from `detector` (its net's current
    weights) on `device`: the card ("cuda") unless the caller asks for
    another (device="cpu" serves on the CPU); without a CUDA device an
    omitted device raises.

    captured: None (default) builds a captured (CUDA-graph) engine on a CUDA
      device and an eager one on the CPU; False builds an eager engine on any
      device (the oracle of the captured one); True on the CPU raises. A
      capture that fails raises. A captured engine takes raw uint8 frames.

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
    if captured is None:
        captured = device.type == "cuda"
    return Engine(detector, net, preprocess, spec, input_hw, precision,
                  batch_size, device, pack_output, stem_pack is not None,
                  captured=bool(captured))
