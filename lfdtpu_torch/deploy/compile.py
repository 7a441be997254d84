# Deployment engine (`lfdtpu/deploy/compile.py`, the counterpart of the
# reference's TensorRT `build_engine.py:22-152`): one end-to-end callable
# (device preprocess -> conv net -> decode -> class-offset NMS) at a fixed
# input resolution and precision:
#   fp32 -> float32 weights and math   (reference TRT fp32 engine)
#   bf16 -> bfloat16 weights and math  (reference TRT fp16 engine)
#   int8 -> the calibrated fused int8 chain (reference TRT int8 engine;
#           deploy/int8_net.py, K4), then the float remainder in float32
#           (or bfloat16 with int8_head_dtype="bf16")
# It takes uint8 NHWC frames (raw, padded to the resolution bucket) or float
# ones (normalized on the host) and returns fixed-shape detections, decode
# and NMS included.
#
# The engine holds its own copy of the weights and the point grids on its
# device. On a CUDA device it is a captured CUDA graph (dense + decode +
# pack + output cast) that a call replays, one per frame dtype, the
# counterpart of lfdtpu's jitted program (`lfdtpu/deploy/compile.py:403-444`),
# which jit traces once per input dtype; on the CPU, or when asked
# (captured=False), it runs eagerly. The call, the graphs and their staging
# live in deploy/runner.py, shared with the engines load_engine restores. A
# capture that fails raises: no engine quietly runs eagerly in its place.
# What breaks a capture: a host sync (.item(), .cpu(), torch.equal, a
# boolean-mask index), a tensor made from host data, or a CUDA allocation
# outside torch's allocator, anywhere in Engine._forward.
#
# Engine.program and Engine.example_args are lfdtpu's export hook
# (`export_parts`, `example_args`): the engine's device side as an nn.Module
# whose buffers are all the engine holds on its device, which
# deploy/engine_io.py exports with torch.export. The hand-written kernels are custom ops (torch.ops.lfd.*), so
# the exported program calls them.
#
# The split, s2d_stem and approx_topk options of the JAX engine are TPU
# workarounds, decided not to port (ROADMAP queue 1, item 10); its mesh
# option, the multi-chip engine, is item 8b.

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .int8_net import Int8Chain, calibrate_module_amax
from .kernel_net import attach_kernels, prepack_stem
from .runner import GraphRunner

# the float dtype of each precision's net (int8: its float remainder's default)
_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.float32}
_HEAD_DTYPES = {None: torch.float32, "bf16": torch.bfloat16}  # int8_head_dtype
CALIBRATION_FRAMES = 2  # noise frames of the default int8 calibration (lfdtpu's)
# output_dtype (`lfdtpu/deploy/compile.py:197-206`): lfdtpu's names; "f32"
# means no cast
_OUTPUT_DTYPES = {None: None, "f32": None, "f16": torch.float16, "float16": torch.float16,
                  "bf16": torch.bfloat16}


def output_dtype_of(output_dtype):
    """compile_inference's output_dtype as a torch float dtype, or None for
    the full-precision outputs."""
    if output_dtype not in _OUTPUT_DTYPES:
        raise ValueError(f"unknown output_dtype {output_dtype}")
    return _OUTPUT_DTYPES[output_dtype]


def cast_outputs(out, dtype):
    """Quantized outputs (`lfdtpu/deploy/compile.py:427-440`): boxes and
    scores in `dtype`, labels int16, the count int32; a packed tensor is
    cast whole. None leaves them as they are."""
    if dtype is None:
        return out
    if isinstance(out, torch.Tensor):
        return out.to(dtype)
    return dict(boxes=out["boxes"].to(dtype), scores=out["scores"].to(dtype),
                labels=out["labels"].to(torch.int16), count=out["count"])


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


class EngineProgram(nn.Module):
    """An engine's device side, what a captured engine records and what
    lfdtpu's `export_parts` is: forward(images, valid_hw) -> the engine's
    detections, valid_hw (2,) or (B, 2). Its submodules and buffers are
    everything the engine holds on its device: the net (with the kernels'
    packed weights), the device preprocess, the int8 chain's packed
    weights, multipliers and biases, and the level arrays (`level_<key>`).
    The detector is no module: its decode's geometry, not its weights.

    Everything here takes tensors on the engine's device and touches no
    host data, makes no host sync and has no data-dependent shape."""

    def __init__(self, detector, net, preprocess, int8_chain, spec, input_hw, precision,
                 kernel_stem, pack_output, output_dtype, device):
        super().__init__()
        self.detector = detector
        self.net = net
        self.preprocess = preprocess
        self.int8_chain = int8_chain
        self.spec = spec
        self.input_resolution = input_hw
        self.compute_dtype = _DTYPES[precision]
        self.kernel_stem = kernel_stem
        self.pack_output = pack_output
        self.output_dtype = output_dtype
        levels = detector.level_arrays(input_hw, device)
        self._level_keys = tuple(levels)
        for k, v in levels.items():
            self.register_buffer(f"level_{k}", v)

    def dense(self, x):
        if self.int8_chain is not None:
            # preprocess in float32, quantize with __input__#out, the chain,
            # the float remainder in the chain's dequant dtype
            if self.preprocess is not None:
                x = self.preprocess(x)
            return self.int8_chain(x.float())
        if self.kernel_stem:
            if x.dtype != torch.uint8:
                raise ValueError("the stem kernel consumes raw uint8 frames")
        else:
            if self.preprocess is not None:
                x = self.preprocess(x)
            x = x.to(self.compute_dtype)
        return self.net(x)

    def decode(self, cls_o, reg_o, vhw):
        levels = {k: getattr(self, f"level_{k}") for k in self._level_keys}
        out = self.detector.decode_batch(
            (cls_o.float(), reg_o.float()), self.input_resolution, vhw,
            self.spec, level_arrays=levels)
        if self.pack_output:
            out = _pack_detections(out)
        return cast_outputs(out, self.output_dtype)

    def forward(self, images, valid_hw):
        vhw = valid_hw.reshape(-1, 2).expand(images.shape[0], 2)
        return self.decode(*self.dense(images), vhw)


class Engine(GraphRunner):
    """Compiled engine: engine(images, valid_hw) -> decoded dict of tensors
    on the engine's device (or the packed tensor with pack_output), in
    output_dtype when one was given.

    images: (B, H, W, 3) numpy array or tensor at input_resolution: raw
    uint8 frames, or float frames normalized on the host (any dtype but
    uint8 reaches the net as float32; the stem kernel takes uint8 only);
    valid_hw: (2,) shared or (B, 2) per-image unpadded extents.
    `dense` and `decode` expose the two halves, always eager, for checks and
    timing.

    `program` is the device side (EngineProgram). A captured engine
    (`captured`, the default on a CUDA device) holds it as a CUDA graph over
    static buffers and a call replays it: the counterpart of lfdtpu's jitted
    program. The call, the graphs (one per frame dtype) and their pinned
    staging are GraphRunner's (deploy/runner.py). `program` and
    `example_args` are the export hook of deploy/engine_io.py."""

    def __init__(self, program, precision, batch_size, device, captured=False):
        self.program = program
        self.net = program.net
        self.int8_chain = program.int8_chain
        self.spec = program.spec
        self.input_resolution = program.input_resolution
        self.precision_mode = precision
        self.batch_size = batch_size
        self.device = device
        self.pack_output = program.pack_output
        self.kernel_stem = program.kernel_stem
        self.output_dtype = program.output_dtype
        self._init_runner(captured)

    @torch.inference_mode()
    def _forward(self, x, vhw):
        return self.program(x, vhw)

    # ------------------------------------------------------- eager halves
    @torch.inference_mode()
    def dense(self, images):
        """Raw frames -> dense (cls (B, P, Cc), reg (B, P, 4)) in the
        engine's dtype (eager)."""
        return self.program.dense(self._images(images))

    @torch.inference_mode()
    def decode(self, cls_o, reg_o, valid_hw):
        """Dense outputs -> detections (eager)."""
        return self.program.decode(cls_o, reg_o, self._valid_hw(valid_hw))

    # -------------------------------------------------------- export hook
    def example_args(self):
        """The arguments the program is exported with (lfdtpu's example_args):
        zero frames, uint8 for the stem kernel's engine and float32 for every
        other (a uint8 frame reaches those nets as float32 at once, so the
        program serves both frame dtypes), and a (B, 2) valid extent when the
        batch is above 1, else (2,)."""
        dtype = torch.uint8 if self.kernel_stem else torch.float32
        vhw_shape = (self.batch_size, 2) if self.batch_size > 1 else (2,)
        return (torch.zeros((self.batch_size, *self.input_resolution, 3), dtype=dtype,
                            device=self.device),
                torch.zeros(vhw_shape, dtype=torch.float32, device=self.device))


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
    act_scales=None,
    int8_head_dtype=None,
    output_dtype=None,
):
    """Build one inference engine from `detector` (its net's current
    weights) on `device`: the card ("cuda") unless the caller asks for
    another (device="cpu" serves on the CPU); without a CUDA device an
    omitted device raises.

    captured: None (default) builds a captured (CUDA-graph) engine on a CUDA
      device and an eager one on the CPU; False builds an eager engine on any
      device (the oracle of the captured one); True on the CPU raises. A
      capture that fails raises. A captured engine takes uint8 frames and
      float frames (a graph for each, the float one captured at its first
      float call), as the eager one does.

    Kernel switches (the JAX knobs in brackets), with lfdtpu's defaults:
      nms_use_kernel [nms_use_pallas], default on: K1 for CUDA tensors.
      kernel_convs [pallas_convs], default off: eligible FasterBlocks run as
        two K3 launches each (bf16 engines; fp32 activations stay on
        F.conv2d, as lfdtpu's eligibility leaves fp32 on XLA).
      kernel_stem [pallas_stem], default off: normalize + stem0 conv + BN +
        ReLU as one K2 launch on the raw uint8 frame; needs precision "bf16",
        a make_device_preprocess preprocess, and a 3 -> 64 BatchNorm stem0.
    On CPU tensors every switch runs the kernels' plain versions.

    int8 (`lfdtpu/deploy/compile.py:162-167,216-247`): the fused int8 chain
      of deploy/int8_net.py, every conv of the backbone and the neck (and of
      a norm-free head) a K4 launch, then the float remainder (the GroupNorm
      head, the output convs, the Scales). LFD nets only.
      act_scales: calibrate_module_amax's dict (the port's keys; lfdtpu's map
        through execution.jax_amax_to_port); None calibrates on lfdtpu's two
        noise frames, np.random.RandomState(0).randint(0, 255, (batch_size,
        H, W, 3), uint8) drawn twice.
      int8_head_dtype: None runs the float remainder in float32; "bf16" casts
        the weights to bfloat16 first, so the chain quantizes from the bf16
        weights and the remainder runs in bf16, as lfdtpu.
      kernel_convs is ignored and kernel_stem raises, as lfdtpu's int8 branch
      runs no conv pack and its pallas_stem needs bf16.

    output_dtype (`lfdtpu/deploy/compile.py:197-206,427-440`): "f16" (or
      "float16") returns boxes and scores in float16, labels in int16 and the
      count in int32; "bf16" the same in bfloat16; None or "f32" change
      nothing. With pack_output the packed tensor is cast. The cast is
      the last step of the captured graph: it halves the result's bytes from
      the device (boxes exact to 0.5 px below 2048, scores within 1e-3).
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
    if int8_head_dtype not in _HEAD_DTYPES:
        raise ValueError(f"unknown int8_head_dtype {int8_head_dtype}")
    output_dtype = output_dtype_of(output_dtype)

    net = cast_variables(detector.net, _DTYPES[precision])
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    if preprocess is not None:
        preprocess = copy.deepcopy(preprocess).to(device)

    int8_chain = None
    if precision == "int8":
        if kernel_stem:
            raise ValueError("kernel_stem requires precision='bf16'")
        if act_scales is None:
            rng = np.random.RandomState(0)
            calib = [rng.randint(0, 255, (batch_size,) + input_hw + (3,), dtype=np.uint8)
                     for _ in range(CALIBRATION_FRAMES)]
            act_scales = calibrate_module_amax(net, calib, preprocess=preprocess)
        head_dtype = _HEAD_DTYPES[int8_head_dtype]
        net = net.to(head_dtype)  # the chain quantizes from these weights
        int8_chain = Int8Chain(net, act_scales, dequant_dtype=head_dtype, device=device)
        kernel_convs = False

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
    program = EngineProgram(detector, net, preprocess, int8_chain, spec, input_hw, precision,
                            stem_pack is not None, pack_output, output_dtype, device)
    return Engine(program, precision, batch_size, device, captured=bool(captured))
