# Weight bridge lfdtpu -> lfdtpu_torch: a JAX variables tree
# ({"params", "batch_stats"} with numpy leaves) into the port's state_dict.
# The inverse of `lfdtpu/execution/torch_convert.py::
# convert_reference_state_dict`, which reads a port state_dict because the
# port uses the upstream reference's module names.
#
# Mapping (JAX path -> port module):
#   backbone/stem{n}/...                 -> _backbone._stem.{i} (n-th conv/norm)
#   backbone/stage{i}_block{j}/ConvNormAct_{k}/... -> _backbone.stage{i}.{j}._conv{k+1}/_norm{k+1}
#   backbone/stage{i}_block{j}/_Shortcut_0/...     -> ..._downsample.{0,1}
#   neck/neck{i}/...                     -> _neck.neck{i}.{0,1}
#   head/{shared|head{k}}_merge/conv{m}  -> _head.head{k}_merge_path (m-th conv/norm)
#   head/..._cls|_reg/conv{m}, final     -> _head.head{k}_{classification,regression}_path
#   head/scale{i}/scale                  -> _head._scales.{i}._scale
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
    r = _Reader(variables)
    bb, neck, head = net._backbone, net._neck, net._head

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
    for i in range(neck.num_levels):
        (ck, nk), = _conv_norm_units(getattr(neck, f"neck{i}"), f"_neck.neck{i}")
        r.conv_norm(net, ck, nk, ("neck", f"neck{i}"))

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
