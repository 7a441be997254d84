# Weight bridge lfdtpu -> lfdtpu_torch: a JAX variables tree
# ({"params", "batch_stats"} with numpy leaves) into the port's state_dict,
# and a JAX TrainState (with its SGD momentum) into the port's TrainState.
# The inverse of `lfdtpu/execution/torch_convert.py::
# convert_reference_state_dict`, which reads a port state_dict because the
# port uses the upstream reference's module names.
#
# Mapping (JAX path -> port module), LFD parts:
#   backbone/stem{n}/...                 -> _backbone._stem.{i} (n-th conv/norm)
#   backbone/stage{i}_block{j}/ConvNormAct_{k}/... -> _backbone.stage{i}.{j}._conv{k+1}/_norm{k+1}
#   backbone/stage{i}_block{j}/_Shortcut_0/...     -> ..._downsample.{0,1}
#   neck/neck{i}/...                     -> _neck.neck{i}.{0,1}
#   head/{shared|head{k}}_merge/conv{m}  -> _head.head{k}_merge_path (m-th conv/norm)
#   head/..._cls|_reg/conv{m}, final     -> _head.head{k}_{classification,regression}_path
#   head/scale{i}/scale                  -> _head._scales.{i}._scale
# ResNet, FPN / SimpleFPN, LFDHeadV1 and FCOSHead:
#   backbone/stem0 (stem{n} deep)        -> _backbone.conv1/bn1 (_backbone.stem.{i})
#   backbone/stage{s}_block{j}/ConvNormAct_{k}/... -> _backbone.layer{s}.{j}.conv{k+1}/bn{k+1},
#                                           the last ConvNormAct the downsample.{0,1}
#   neck/lateral{i}/..., neck/fpn_out{i} -> _neck.lateral{i}.{0,1}, _neck.fpn_out{i}
#   head/{cls,reg}_trunk/conv{m}, head/{cls,reg}_final{i} -> LFDHeadV1's same names
#   head/{cls,reg}_tower/conv{m}         -> _head._{classification,regression}_path
#   head/{classification,centerness,regression} -> _head._classification, ...
# Conv kernels go HWIO -> OIHW; BatchNorm scale/bias/mean/var -> weight/
# bias/running_mean/running_var; GroupNorm scale/bias -> weight/bias. A
# shared head fills every head{k}_* duplicate from the one JAX copy.
# Strict: an unmapped JAX leaf, an unfilled port entry or a shape mismatch
# raises.

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _conv_norm_units(seq, prefix):
    """[(conv key prefix, norm key prefix or None)] of a Sequential whose
    children run [conv, norm?, act?]*."""
    units = []
    for idx, m in seq.named_children():
        if isinstance(m, nn.Conv2d):
            units.append([f"{prefix}.{idx}", None])
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            if not units or units[-1][1] is not None:
                raise ValueError(f"norm layer {prefix}.{idx} does not follow a conv")
            units[-1][1] = f"{prefix}.{idx}"
    return units


class _Reader:
    def __init__(self, variables):
        self.trees = {"params": variables["params"],
                      "batch_stats": variables.get("batch_stats", {})}
        self.used = set()
        self.out = {}

    def _node(self, tree, parts):
        node = self.trees[tree]
        for p in parts:
            if not isinstance(node, dict) or p not in node:
                return None
            node = node[p]
        return node

    def get(self, tree, parts):
        node = self._node(tree, parts)
        if node is None:
            raise KeyError(f"JAX leaf {tree}/{'/'.join(parts)} not found")
        self.used.add((tree,) + tuple(parts))
        return np.asarray(node, np.float32)

    def conv(self, key, jparts, name="Conv_0"):
        k = self.get("params", jparts + (name, "kernel"))
        self.out[key + ".weight"] = np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW
        if self._node("params", jparts + (name, "bias")) is not None:
            self.out[key + ".bias"] = self.get("params", jparts + (name, "bias"))

    def norm(self, key, jparts, module):
        if isinstance(module, nn.BatchNorm2d):
            base = jparts + ("Norm_0", "BatchNorm_0")
            self.out[key + ".weight"] = self.get("params", base + ("scale",))
            self.out[key + ".bias"] = self.get("params", base + ("bias",))
            self.out[key + ".running_mean"] = self.get("batch_stats", base + ("mean",))
            self.out[key + ".running_var"] = self.get("batch_stats", base + ("var",))
        else:
            base = jparts + ("Norm_0", "GroupNorm_0")
            self.out[key + ".weight"] = self.get("params", base + ("scale",))
            self.out[key + ".bias"] = self.get("params", base + ("bias",))

    def conv_norm(self, net, conv_key, norm_key, jparts):
        self.conv(conv_key, jparts)
        if norm_key is not None:
            self.norm(norm_key, jparts, net.get_submodule(norm_key))


def jax_variables_to_state_dict(variables, net):
    """Convert lfdtpu variables into a state_dict for the port's
    DetectionNet `net` (its template: names, shapes, shared-head layout).

    Returns {key: torch.Tensor (float32)} covering every float entry of
    net.state_dict() (BatchNorm's num_batches_tracked keeps the template's
    value); load it with net.load_state_dict(sd, strict=True)."""
    from ..models.heads import FCOSHead, LFDHeadV1
    from ..models.necks import FPN
    from ..models.resnet import ResNet

    r = _Reader(variables)
    bb, neck, head = net._backbone, net._neck, net._head
    (_resnet if isinstance(bb, ResNet) else _lfd_resnet)(r, net, bb)
    (_fpn if isinstance(neck, FPN) else _simple_neck)(r, net, neck)
    {FCOSHead: _fcos_head, LFDHeadV1: _lfd_head_v1}.get(type(head), _lfd_head)(r, net, head)
    if head.with_scale:
        for i in range(head.num_heads):
            r.out[f"_head._scales.{i}._scale"] = r.get(
                "params", ("head", f"scale{i}", "scale")).reshape(())

    unused = [t + "/" + "/".join(p)
              for t in ("params", "batch_stats")
              for p in _leaf_paths(r.trees[t]) if (t,) + p not in r.used]
    if unused:
        raise ValueError(f"unmapped JAX leaves: {unused[:8]} ({len(unused)} total)")
    template = net.state_dict()
    missing = [k for k, v in template.items()
               if v.is_floating_point() and k not in r.out]
    extra = [k for k in r.out if k not in template]
    if missing or extra:
        raise ValueError(f"state_dict mismatch: missing {missing[:8]}, "
                         f"unexpected {extra[:8]}")
    sd = {}
    for k, v in template.items():
        if k not in r.out:
            sd[k] = v.clone()
            continue
        a = r.out[k]
        if tuple(a.shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {a.shape} != port {tuple(v.shape)}")
        sd[k] = torch.from_numpy(np.array(a, np.float32))
    return sd


def _lfd_resnet(r, net, bb):
    for n, (ck, nk) in enumerate(_conv_norm_units(bb._stem, "_backbone._stem")):
        r.conv_norm(net, ck, nk, ("backbone", f"stem{n}"))
    for i, stage in enumerate(bb.stages()):
        for j, block in enumerate(stage):
            tp = f"_backbone.stage{i}.{j}"
            jp = ("backbone", f"stage{i}_block{j}")
            for k in range(1, block._num_convs + 1):
                r.conv_norm(net, f"{tp}._conv{k}",
                            f"{tp}._norm{k}" if hasattr(block, f"_norm{k}") else None,
                            jp + (f"ConvNormAct_{k - 1}",))
            if block.use_downsample:
                (ck, nk), = _conv_norm_units(block._downsample, f"{tp}._downsample")
                r.conv_norm(net, ck, nk, jp + ("_Shortcut_0",))


def _resnet(r, net, bb):
    if bb.deep_stem:
        for n, (ck, nk) in enumerate(_conv_norm_units(bb.stem, "_backbone.stem")):
            r.conv_norm(net, ck, nk, ("backbone", f"stem{n}"))
    else:
        r.conv_norm(net, "_backbone.conv1", "_backbone.bn1", ("backbone", "stem0"))
    for s, stage in enumerate(bb.stages(), start=1):
        for j, block in enumerate(stage):
            tp = f"_backbone.layer{s}.{j}"
            jp = ("backbone", f"stage{s}_block{j}")
            for k in range(1, block.num_convs + 1):
                r.conv_norm(net, f"{tp}.conv{k}", f"{tp}.bn{k}", jp + (f"ConvNormAct_{k - 1}",))
            if block.downsample is not None:
                (ck, nk), = _conv_norm_units(block.downsample, f"{tp}.downsample")
                r.conv_norm(net, ck, nk, jp + (f"ConvNormAct_{block.num_convs}",))


def _simple_neck(r, net, neck):
    for i in range(neck.num_levels):
        (ck, nk), = _conv_norm_units(getattr(neck, f"neck{i}"), f"_neck.neck{i}")
        r.conv_norm(net, ck, nk, ("neck", f"neck{i}"))


def _fpn(r, net, neck):
    for i in range(neck.num_inputs):
        (ck, nk), = _conv_norm_units(getattr(neck, f"lateral{i}"), f"_neck.lateral{i}")
        r.conv_norm(net, ck, nk, ("neck", f"lateral{i}"))
    for i in range(neck.num_outputs):
        if hasattr(neck, f"fpn_out{i}"):
            r.conv(f"_neck.fpn_out{i}", ("neck",), name=f"fpn_out{i}")


def _lfd_head(r, net, head):
    for k in range(head.num_heads):
        name = "shared" if head.share_head_flag else f"head{k}"
        if head.merge_path_flag:
            units = _conv_norm_units(getattr(head, f"head{k}_merge_path"),
                                     f"_head.head{k}_merge_path")
            for m, (ck, nk) in enumerate(units):
                r.conv_norm(net, ck, nk, ("head", f"{name}_merge", f"conv{m}"))
        for branch, fb in (("classification", "cls"), ("regression", "reg")):
            units = _conv_norm_units(getattr(head, f"head{k}_{branch}_path"),
                                     f"_head.head{k}_{branch}_path")
            for m, (ck, nk) in enumerate(units):
                if m == len(units) - 1:
                    r.conv(ck, ("head", f"{name}_{fb}"), name="final")
                else:
                    r.conv_norm(net, ck, nk, ("head", f"{name}_{fb}", f"conv{m}"))


def _head_trunk(r, net, seq, prefix, jname):
    for m, (ck, nk) in enumerate(_conv_norm_units(seq, prefix)):
        r.conv_norm(net, ck, nk, ("head", jname, f"conv{m}"))


def _lfd_head_v1(r, net, head):
    for fb in ("cls", "reg"):
        _head_trunk(r, net, getattr(head, f"{fb}_trunk"), f"_head.{fb}_trunk", f"{fb}_trunk")
        for i in range(head.num_heads):
            r.conv(f"_head.{fb}_final{i}", ("head",), name=f"{fb}_final{i}")


def _fcos_head(r, net, head):
    _head_trunk(r, net, head._classification_path, "_head._classification_path", "cls_tower")
    _head_trunk(r, net, head._regression_path, "_head._regression_path", "reg_tower")
    for final in ("classification", "centerness", "regression"):
        r.conv(f"_head._{final}", ("head",), name=final)


def jax_train_state_to_port(state, train_state):
    """Continue a JAX run in the port: load an lfdtpu TrainState
    (params, batch_stats, opt_state) into the port's TrainState `state`
    (parallel/data_parallel.py) in place.

    params and batch_stats go into state.net as jax_variables_to_state_dict
    maps them; every parameter's SGD momentum buffer is set from
    opt_state.momentum_buf (lfdtpu's SGD / GroupedSGD state), mapped the
    same way. Strict: an unmapped leaf, a missing momentum buffer or an
    opt_state without one raises."""
    net = state.net
    batch_stats = train_state.batch_stats
    net.load_state_dict(jax_variables_to_state_dict(
        {"params": train_state.params, "batch_stats": batch_stats}, net), strict=True)
    bufs = getattr(train_state.opt_state, "momentum_buf", None)
    if bufs is None:
        raise ValueError(f"opt_state {type(train_state.opt_state).__name__} has no "
                         "momentum_buf (only lfdtpu's SGD / GroupedSGD state converts)")
    buf_sd = jax_variables_to_state_dict({"params": bufs, "batch_stats": batch_stats}, net)
    owner = {id(p): name for name, p in net.named_parameters()}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            # empty_like keeps the parameter's memory format (channels_last)
            state.optimizer.state[p]["momentum_buffer"] = torch.empty_like(p).copy_(
                buf_sd[owner[id(p)]])


def jax_amax_to_port(amax, net):
    """lfdtpu's calibrate_module_amax dict -> the port's keys for `net` (an
    LFD DetectionNet), the state bridge of the int8 chain
    (deploy/int8_net.py). lfdtpu's keys, each with `#in` or `#out`:
      backbone/stem{n}                          -> _backbone._stem.{i} (n-th conv)
      backbone/stage{s}_block{j}                -> _backbone.stage{s}.{j}
      backbone/stage{s}_block{j}/ConvNormAct_{k} -> _backbone.stage{s}.{j}._conv{k+1}
      backbone/stage{s}_block{j}/_Shortcut_0    -> _backbone.stage{s}.{j}._downsample.0
      neck/neck{i}                              -> _neck.neck{i}.0
      head/{shared|head{k}}_{merge|cls|reg}/conv{m} -> _head.head{k}_{merge,
                                                   classification,regression}_path (m-th conv)
    plus __input__#out. A key that cannot be placed raises."""
    import re

    out = {}
    bb = net._backbone
    stem = [u[0] for u in _conv_norm_units(bb._stem, "_backbone._stem")]
    paths = {"merge": "merge", "cls": "classification", "reg": "regression"}
    for key, value in amax.items():
        if key == "__input__#out":
            out[key] = value
            continue
        path, _, end = key.rpartition("#")
        if end not in ("in", "out"):
            raise KeyError(f"amax key {key!r}: no #in / #out")
        parts = path.split("/")
        name = None
        if parts[0] == "backbone" and len(parts) == 2 and re.fullmatch(r"stem\d+", parts[1]):
            n = int(parts[1][4:])
            name = stem[n] if n < len(stem) else None
        elif parts[0] == "backbone" and re.fullmatch(r"stage\d+_block\d+", parts[1]):
            s, j = map(int, re.findall(r"\d+", parts[1]))
            block = f"_backbone.stage{s}.{j}"
            if len(parts) == 2:
                name = block
            elif len(parts) == 3 and re.fullmatch(r"ConvNormAct_\d+", parts[2]):
                name = f"{block}._conv{int(parts[2][12:]) + 1}"
            elif len(parts) == 3 and parts[2] == "_Shortcut_0":
                name = f"{block}._downsample.0"
        elif parts[0] == "neck" and len(parts) == 2 and re.fullmatch(r"neck\d+", parts[1]):
            name = f"_neck.{parts[1]}.0"
        elif parts[0] == "head" and len(parts) == 3:
            m = re.fullmatch(r"(shared|head(\d+))_(merge|cls|reg)", parts[1])
            c = re.fullmatch(r"conv(\d+)", parts[2])
            if m and c:
                seq_name = f"head{m.group(2) or 0}_{paths[m.group(3)]}_path"
                seq = getattr(net._head, seq_name, None)
                convs = ([u[0] for u in _conv_norm_units(seq, f"_head.{seq_name}")]
                         if seq is not None else [])
                if int(c.group(1)) < len(convs):
                    name = convs[int(c.group(1))]
        if name is None or (name.count(".") and _module_at(net, name) is None):
            raise KeyError(f"lfdtpu amax key {key!r} has no place in {type(net).__name__}")
        out[f"{name}#{end}"] = value
    return out


def _module_at(net, name):
    m = net
    for part in name.split("."):
        m = getattr(m, part, None)
        if m is None:
            return None
    return m
