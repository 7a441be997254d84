# The fused int8 chain (`lfdtpu/deploy/int8_net.py:215-524`), the engine path
# of compile_inference(precision="int8").
#
# Activations stay int8 from the quantized input through the backbone and
# the neck. Every conv unit [conv, BatchNorm?, ReLU?] is one K4 launch
# (ops/int8_conv.py): int8 x int8 -> int32, then one fused epilogue
# f32(acc) * (s_in * w_scale * bn_scale) + folded bias, ReLU, requant to the
# next calibrated scale. A residual block's last conv adds its identity (the
# int8 input times its scale, or the shortcut's float32 output) in the same
# epilogue before the ReLU and the requant. Whatever is not int8-eligible
# (GroupNorm heads, the output convs, the Scales) gets one dequant to
# `dequant_dtype` and runs as float modules.
#
# Every scale is a static Python float known when the engine is built, so the
# chain is a static plan: each weight is quantized once, each epilogue's
# constants folded once on the CPU in float32 (then copied to the engine's
# device), each requant target picked once. lfdtpu's trace-time _Tracker has
# no counterpart; its prequantize_weights + weight_scales is what the plan
# holds, with the same values (_quantize_weights is deterministic).
#
# The port's net has no ConvNormAct module: a unit is a flat run [conv,
# norm?, act?] of a Sequential (models/layers.py). The plan walks the port's
# structure in lfdtpu's order: `_backbone._stem` units, each `stage{i}.{j}`
# block (`_conv{k}`, `_norm{k}`, `_downsample`), each `_neck.neck{i}` unit,
# and per level the head's paths (`_head.head{i}_merge_path` units, then the
# trunk units and output conv of the classification and regression paths).
# Supported nets: LFD's DetectionNet (LFDResNet, SimpleNeck, LFDHead), which
# every zoo model and LFDv2 use; another structure raises.
#
# Amax keys (calibrate_module_amax): a unit is named by its conv's state_dict
# name (`_backbone._stem.0`, `_backbone.stage0.0._conv1`,
# `_backbone.stage0.0._downsample.0`, `_neck.neck0.0`,
# `_head.head0_merge_path.0`), a block by its own (`_backbone.stage0.0`), each
# with `#in` or `#out`, plus `__input__#out`. A shared head module is one
# object under every level's name; it is keyed by head 0's.
# execution/jax_convert.py::jax_amax_to_port maps lfdtpu's keys onto these.
#
# F15 (ROADMAP queue 3; lfdtpu's own, mirrored): a module that runs more than
# once keeps the amax of its LAST call, as lfdtpu's
# `{k: v for k, v in zip(names, amax)}` (`int8_net.py:263-264`) does. The
# shared head runs once per level, so its merge units keep level 4's range.
#
# Not ported (ROADMAP queue 1, item 10): the legacy per-conv interceptor
# (int8_interception, int8_apply, calibrate_activation_scales,
# ActScaleObserver; `int8_net.py:89-212`), which lfdtpu's engines do not use.

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from ..models.heads import LFDHead
from ..models.lfd_resnet import LFDResNet
from ..models.necks import SimpleNeck
from ..ops.int8_conv import (int8_conv, pack_int8_weight, quantize_to, quantize_weights,
                             scale_of)
from .kernel_net import FusedGroupNormReLU, folded_norm

INPUT_KEY = "__input__#out"


# --------------------------------------------------------------------------
# The net's structure, in lfdtpu's order
# --------------------------------------------------------------------------

@dataclass
class UnitSpec:
    """One conv unit: the conv, its norm and activation (each may be None),
    and the modules in the order they run."""

    name: str
    conv: nn.Conv2d
    norm: nn.Module = None
    act: nn.Module = None
    layers: list = field(default_factory=list)

    def run(self, x):
        for m in self.layers:
            x = m(x)
        return x


def split_units(seq, prefix):
    """A flat Sequential [conv, norm?, act?, conv, ...] as its units."""
    units = []
    for idx, m in enumerate(seq):
        if isinstance(m, nn.Conv2d):
            units.append(UnitSpec(f"{prefix}.{idx}", m, layers=[m]))
            continue
        if not units:
            raise ValueError(f"{prefix}: a unit must start with a conv, got {type(m).__name__}")
        units[-1].layers.append(m)
        if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, FusedGroupNormReLU)):
            units[-1].norm = m  # K5's module: the norm, the Identity after it the act
        else:
            units[-1].act = m
    return units


def block_units(name, block):
    """A residual block's conv units (the last without its activation) and
    its shortcut unit (None without a downsample)."""
    units = []
    for k in range(1, block._num_convs + 1):
        conv = getattr(block, f"_conv{k}")
        norm = getattr(block, f"_norm{k}") if block.norm_cfg is not None else None
        act = block._act if k < block._num_convs else None
        units.append(UnitSpec(f"{name}._conv{k}", conv, norm, act,
                              [m for m in (conv, norm, act) if m is not None]))
    shortcut = (split_units(block._downsample, f"{name}._downsample")[0]
                if block.use_downsample else None)
    return units, shortcut


@dataclass
class HeadLevel:
    merge: list
    cls: list   # trunk units, then the output conv's unit
    reg: list
    scale: nn.Module = None


@dataclass
class NetStructure:
    stem: list
    blocks: list     # (name, block, tapped)
    neck: list       # one unit per level
    head: list       # HeadLevel per level


def net_structure(net):
    """The int8 chain's view of an LFD DetectionNet; raises for other nets."""
    bb, neck, head = net._backbone, net._neck, net._head
    if not (isinstance(bb, LFDResNet) and isinstance(neck, SimpleNeck)
            and isinstance(head, LFDHead)):
        raise ValueError(
            "the int8 chain supports LFD nets (LFDResNet, SimpleNeck, LFDHead), not "
            f"{type(bb).__name__} / {type(neck).__name__} / {type(head).__name__}")
    names = {id(m): n for n, m in net.named_modules()}  # a shared module: head 0's name
    blocks = [(f"_backbone.stage{i}.{j}", b, (i, j) in bb.out_indices)
              for i, stage in enumerate(bb.stages()) for j, b in enumerate(stage)]
    levels = []
    for i in range(head.num_heads):
        def path(kind):
            seq = getattr(head, f"head{i}_{kind}_path")
            return split_units(seq, names[id(seq)])
        levels.append(HeadLevel(
            merge=path("merge") if head.merge_path_flag else [],
            cls=path("classification"), reg=path("regression"),
            scale=head._scales[i] if head.with_scale else None))
    return NetStructure(
        stem=split_units(bb._stem, "_backbone._stem"), blocks=blocks,
        neck=[split_units(getattr(neck, f"neck{i}"), f"_neck.neck{i}")[0]
              for i in range(neck.num_levels)],
        head=levels)


def flatten_levels(cls_outs, reg_outs):
    """Per-level NCHW head outputs -> dense (B, P, C) / (B, P, 4), as
    DetectionNet.forward."""
    def flat(outs):
        return torch.cat([o.permute(0, 2, 3, 1).reshape(o.shape[0], -1, o.shape[1])
                          for o in outs], dim=1)
    return flat(cls_outs), flat(reg_outs)


# --------------------------------------------------------------------------
# Calibration (`int8_net.py:219-264`)
# --------------------------------------------------------------------------

def _float_walk(st, x, note):
    """The float forward of an LFD net along its structure, calling
    note(key, tensor) at every point calibrate_module_amax records. x: the
    preprocessed NHWC input. Returns the dense outputs (net(x)'s)."""
    note(INPUT_KEY, x)
    h = x.permute(0, 3, 1, 2)

    def unit(u, v):
        note(u.name + "#in", v)
        v = u.run(v)
        note(u.name + "#out", v)
        return v

    for u in st.stem:
        h = unit(u, h)
    feats = []
    for name, block, tapped in st.blocks:
        note(name + "#in", h)
        units, shortcut = block_units(name, block)
        out = h
        for u in units:
            out = unit(u, out)
        identity = unit(shortcut, h) if shortcut is not None else h
        h = block._act(out + identity)
        note(name + "#out", h)
        if tapped:
            feats.append(h)
    feats = [unit(u, f) for u, f in zip(st.neck, feats)]
    cls_outs, reg_outs = [], []
    for lv, v in zip(st.head, feats):
        for u in lv.merge:
            v = unit(u, v)
        outs = []
        for path in (lv.cls, lv.reg):
            y = v
            for u in path[:-1]:
                y = unit(u, y)
            outs.append(path[-1].run(y))  # the output conv: not a ConvNormAct in lfdtpu
        cls_outs.append(outs[0])
        reg_outs.append(lv.scale(outs[1]) if lv.scale is not None else outs[1])
    return flatten_levels(cls_outs, reg_outs)


@torch.inference_mode()
def calibrate_module_amax(detector, batches, preprocess=None):
    """Per-module activation amax for the fused int8 chain.

    Records the input and output abs-max of every conv unit, residual block
    and shortcut (keys `<name>#in` / `<name>#out`) and of the preprocessed
    net input (`__input__#out`), maximised over `batches` of raw NHWC frames,
    running the net (`detector.net`, or a net) in eval mode on its own
    device. A module that runs more than once keeps its LAST call's amax
    (F15, as lfdtpu). Returns {str: float}: pass it to
    compile_inference(act_scales=...)."""
    net = getattr(detector, "net", detector)
    st = net_structure(net)
    device = next(net.parameters()).device
    was_training = net.training
    net.eval()
    amax = None
    try:
        for batch in batches:
            x = torch.as_tensor(np.asarray(batch)).to(device)
            if preprocess is not None:
                x = preprocess(x)
            rec = {}
            _float_walk(st, x.float(), lambda k, t: rec.__setitem__(k, t.abs().amax()))
            names = list(rec)
            vec = torch.stack([rec[k].float() for k in names]).cpu().numpy()
            amax = vec if amax is None else np.maximum(amax, vec)
    finally:
        net.train(was_training)
    return {k: float(v) for k, v in zip(names, amax)}


# --------------------------------------------------------------------------
# Eligibility (`int8_net.py:347-356`)
# --------------------------------------------------------------------------

def _cna_eligible(u):
    """A unit the chain runs in int8: BatchNorm or no norm, ReLU or no act."""
    return ((u.norm is None or isinstance(u.norm, nn.BatchNorm2d))
            and (u.act is None or isinstance(u.act, nn.ReLU))
            and len(u.layers) == 1 + (u.norm is not None) + (u.act is not None))


def _block_eligible(block):
    norm = block.norm_cfg if block.norm_cfg is not None else {"type": "BatchNorm2d"}
    act = block.act_cfg or {"type": "ReLU"}
    return norm.get("type") == "BatchNorm2d" and act.get("type") == "ReLU"


# --------------------------------------------------------------------------
# The static plan
# --------------------------------------------------------------------------

class Int8Unit(nn.Module):
    """One conv unit as a K4 launch with its constants folded:
    mult = (f32(s_in) * w_scale) * bn_scale (lfdtpu's left-to-right
    `s_in * w_scale * nscale`), bias the folded bias. The packed weight,
    mult and bias are buffers, so an exported engine holds them."""

    def __init__(self, name, wpack, mult, bias, kernel_size, stride, relu, out_scale):
        super().__init__()
        self.name = name
        self.register_buffer("wpack", wpack)
        self.register_buffer("mult", mult)
        self.register_buffer("bias", bias)
        self.kernel_size, self.stride = kernel_size, stride
        self.relu, self.out_scale = relu, out_scale

    def forward(self, x8, residual=None, residual_scale=None):
        return int8_conv(x8, self.wpack, self.mult, self.bias, self.kernel_size, self.stride,
                         self.relu, self.out_scale, residual, residual_scale)


class _Planner:
    """Builds the chain's steps from a net, an amax dict and a device."""

    def __init__(self, amax, device):
        self.amax = amax
        self.device = device
        self._weights = {}  # id(conv) -> (packed int8 on device, w_scale f32 CPU)

    def weights(self, conv):
        if id(conv) not in self._weights:
            q, w_scale = quantize_weights(conv.weight.detach().cpu())
            self._weights[id(conv)] = (pack_int8_weight(q).to(self.device),
                                       w_scale.float())
        return self._weights[id(conv)]

    def unit(self, u, s_in, relu, out_scale):
        if u.conv.groups != 1 or u.conv.dilation != (1, 1) or \
                u.conv.padding != (u.conv.kernel_size[0] // 2,) * 2:
            raise ValueError(f"{u.name}: K4 runs plain convs with padding k // 2")
        wpack, w_scale = self.weights(u.conv)
        nscale, nbias = folded_norm(u.conv, u.norm, "cpu")
        mult = (torch.tensor(np.float32(s_in)) * w_scale) * nscale
        return Int8Unit(u.name, wpack, mult.to(self.device), nbias.to(self.device),
                        u.conv.kernel_size[0], u.conv.stride[0], relu, out_scale)

    def in_scale(self, name, kind):
        """(s_in, quantize first?) for an input of `kind` (a scale: int8;
        None: float), or (None, False) when the module must run in float
        (`_in_scale`, `int8_net.py:359-372`)."""
        if kind is not None:
            return kind, False
        a = self.amax.get(name + "#in")
        return (None, False) if a is None else (scale_of(a), True)


def _to_float(v, dtype):
    """A chain value as a float NCHW tensor: an (int8 NHWC, scale) pair is
    dequantized (`_dequant_args`, `int8_net.py:439-446`), a float passes."""
    if isinstance(v, tuple):
        x8, s = v
        return (x8.float() * float(np.float32(s))).to(dtype).permute(0, 3, 1, 2)
    return v


def _to_int8(v, s):
    """A float NCHW value quantized at its module's calibrated input scale."""
    return quantize_to(v.permute(0, 2, 3, 1), s).contiguous()


class _UnitStep:
    def __init__(self, unit, quantize_in, s_in):
        self.unit, self.quantize_in, self.s_in = unit, quantize_in, s_in

    def __call__(self, v, dtype):
        x8 = _to_int8(v, self.s_in) if self.quantize_in else v[0]
        return (self.unit(x8), self.unit.out_scale)


class _BlockStep:
    def __init__(self, units, shortcut, quantize_in, s_in, s_out):
        self.units, self.shortcut = units, shortcut
        self.quantize_in, self.s_in, self.s_out = quantize_in, s_in, s_out

    def __call__(self, v, dtype):
        x8 = _to_int8(v, self.s_in) if self.quantize_in else v[0]
        h = x8
        for u in self.units[:-1]:
            h = u(h)
        if self.shortcut is not None:
            out = self.units[-1](h, residual=self.shortcut(x8))
        else:
            out = self.units[-1](h, residual=x8, residual_scale=self.s_in)
        return (out, self.s_out)


class _FloatStep:
    """A module run in float on the dequantized value."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, v, dtype):
        return self.fn(_to_float(v, dtype))


class Int8Chain(nn.Module):
    """The fused int8 chain of one net as a static plan. Call it with the
    preprocessed float NHWC frames; returns the dense (cls, reg) outputs in
    `dequant_dtype` (the float remainder's). `units` lists every K4 launch
    of one call in order: the plan's count of launches per frame. The units
    are its submodules (`kernels`), so their constants are its buffers; the
    float remainder runs the net's own modules, which it does not hold.
    gather_levels: as DetectionNet's, on the head's (cls, reg) level maps
    before flatten_levels."""

    gather_levels = None

    def __init__(self, net, amax, dequant_dtype=torch.float32, device=None):
        super().__init__()
        st = net_structure(net)
        device = torch.device(device) if device is not None else \
            next(net.parameters()).device
        self.dequant_dtype = dequant_dtype
        self.amax = dict(amax)  # the scales it was planned from
        self.s_input = scale_of(amax[INPUT_KEY])
        plan = _Planner(amax, device)
        self.units = []
        kind = self.s_input  # the input is quantized once

        def unit_step(u, kind):
            s_in, quantize_in = plan.in_scale(u.name, kind)
            if _cna_eligible(u) and (u.name + "#out") in amax and s_in is not None:
                s_out = scale_of(amax[u.name + "#out"])
                iu = plan.unit(u, s_in, relu=u.act is not None, out_scale=s_out)
                self.units.append(iu)
                return (u.name, _UnitStep(iu, quantize_in, s_in)), s_out
            return (u.name, _FloatStep(u.run)), None

        def block_step(name, block, kind):
            s_in, quantize_in = plan.in_scale(name, kind)
            if not (_block_eligible(block) and (name + "#out") in amax and s_in is not None):
                return (name, _FloatStep(block)), None
            units, shortcut = block_units(name, block)
            s_out = scale_of(amax[name + "#out"])
            ius, h_scale = [], s_in
            for k, u in enumerate(units):
                last = k == len(units) - 1
                # the last conv's epilogue adds the identity, applies the
                # ReLU and requantizes to the block's output scale
                out_scale = s_out if last else scale_of(amax[u.name + "#out"])
                ius.append(plan.unit(u, h_scale, relu=not last, out_scale=out_scale))
                h_scale = out_scale
            sc = plan.unit(shortcut, s_in, relu=False, out_scale=None) if shortcut else None
            self.units += ius + ([sc] if sc is not None else [])
            return (name, _BlockStep(ius, sc, quantize_in, s_in, s_out)), s_out

        self.stem = []
        for u in st.stem:
            step, kind = unit_step(u, kind)
            self.stem.append(step)
        self.blocks, tap_kinds = [], []
        for name, block, tapped in st.blocks:
            step, kind = block_step(name, block, kind)
            self.blocks.append((step, tapped))
            if tapped:
                tap_kinds.append(kind)
        self.neck, level_kinds = [], []
        for u, k in zip(st.neck, tap_kinds):
            step, k = unit_step(u, k)
            self.neck.append(step)
            level_kinds.append(k)
        self.head = []
        for lv, k in zip(st.head, level_kinds):
            merge = []
            for u in lv.merge:
                step, k = unit_step(u, k)
                merge.append(step)
            paths = []
            for path in (lv.cls, lv.reg):
                steps, kp = [], k
                for u in path[:-1]:
                    step, kp = unit_step(u, kp)
                    steps.append(step)
                steps.append((path[-1].name, _FloatStep(path[-1].run)))
                paths.append(steps)
            self.head.append((merge, paths[0], paths[1], lv.scale))
        self.kernels = nn.ModuleList(self.units)

    def int8_edges(self):
        """The names of the steps whose outputs stay int8 (units and blocks
        run by K4), in the chain's order: the capture keys of its int8
        edges."""
        steps = list(self.stem) + [step for step, _ in self.blocks] + list(self.neck)
        for merge, cls_path, reg_path, _ in self.head:
            steps += list(merge) + list(cls_path) + list(reg_path)
        return [name for name, fn in steps if isinstance(fn, (_UnitStep, _BlockStep))]

    def forward(self, images_f32, capture=None):
        """images_f32: preprocessed (B, H, W, 3) float frames. capture: a dict
        whose keys name units or blocks (the amax keys without #in/#out);
        each one's output is stored there, an (int8 NHWC, scale) pair or a
        float NCHW tensor (a shared head unit: its last level's)."""
        dtype = self.dequant_dtype

        def run(step, v):
            name, fn = step
            out = fn(v, dtype)
            if capture is not None and name in capture:
                capture[name] = out
            return out

        v = (quantize_to(images_f32, self.s_input).contiguous(), self.s_input)
        for step in self.stem:
            v = run(step, v)
        feats = []
        for step, tapped in self.blocks:
            v = run(step, v)
            if tapped:
                feats.append(v)
        feats = [run(step, f) for step, f in zip(self.neck, feats)]
        cls_outs, reg_outs = [], []
        for (merge, cls_path, reg_path, scale), v in zip(self.head, feats):
            for step in merge:
                v = run(step, v)
            outs = []
            for path in (cls_path, reg_path):
                y = v
                for step in path:
                    y = run(step, y)
                outs.append(y)
            cls_outs.append(outs[0])
            reg_outs.append(scale(outs[1]) if scale is not None else outs[1])
        if self.gather_levels is not None:
            cls_outs, reg_outs = self.gather_levels((cls_outs, reg_outs))
        return flatten_levels(cls_outs, reg_outs)


class _EveryKey(dict):
    """An amax dict that holds every key (at 1.0): what a calibration gives."""

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        return 1.0

    def get(self, key, default=None):
        return 1.0


def planned_launches(net):
    """K4 launches per call of the chain of `net` with a calibrated amax
    dict (every key present), counted from the net's structure."""
    return len(Int8Chain(net, _EveryKey(), device="cpu").units)


def int8_fused_apply(net, images_f32, amax, dequant_dtype=torch.float32, capture=None):
    """Run `net` (eval mode) through the fused int8 chain, planned anew: the
    counterpart of lfdtpu's `int8_fused_apply` (`int8_net.py:449-524`). An
    engine builds its Int8Chain once instead."""
    return Int8Chain(net, amax, dequant_dtype, images_f32.device)(images_f32, capture)
