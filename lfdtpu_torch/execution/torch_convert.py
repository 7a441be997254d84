# ImageNet backbone checkpoints into the port: the counterpart of
# `lfdtpu/execution/torch_convert.py::convert_torchvision_resnet`. The port's
# ResNet uses torchvision's module names (`conv1`/`bn1` or mmdet's deep
# `stem.{i}`, `layer{s}.{j}.conv{k}/bn{k}/downsample.{0,1}`), so the
# conversion is a strict check, not a renaming.

from __future__ import annotations

import torch


def convert_torchvision_resnet(state_dict, resnet):
    """A torchvision / mmdet ResNet state_dict (tensors or arrays, optionally
    under a DataParallel 'module.' prefix) -> a state_dict that the port's
    `resnet` (models.ResNet, the template) loads with strict=True.

    The classifier (`fc.*`) is dropped. Every other key must be one of the
    template's with its shape, and every float entry of the template must be
    covered; BatchNorm's num_batches_tracked keeps the template's value where
    the checkpoint has none. Raises ValueError otherwise (a deeper checkpoint
    than the stages the template builds included, as lfdtpu's converter)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: torch.as_tensor(v)
          for k, v in state_dict.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    template = resnet.state_dict()
    unknown = sorted(k for k in sd if k not in template)
    missing = sorted(k for k, v in template.items()
                     if v.is_floating_point() and k not in sd)
    if unknown or missing:
        raise ValueError(f"ResNet state_dict mismatch: unknown {unknown[:8]} "
                         f"({len(unknown)}), missing {missing[:8]} ({len(missing)})")
    out = {}
    for k, ref in template.items():
        if k not in sd:
            out[k] = ref.clone()
            continue
        v = sd[k]
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != ResNet {tuple(ref.shape)}")
        out[k] = v.to(ref.dtype).clone()
    return out
