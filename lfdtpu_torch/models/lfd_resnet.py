# LFD-ResNet backbone (`lfdtpu/models/lfd_resnet.py`, reference
# `lfd/model/backbone/lfd_resnet.py:218-509`), inference surface.
#
# Structure: stem ('fast' /2, 'faster' /4, 'fastest' /4) then stages of
# residual blocks; the first block of every stage is stride-2 with a 1x1
# projection shortcut. Outputs are tapped at (stage, block) `out_indices`.
# Training-only knobs (frozen_stages, norm_eval) come with the training port.

from __future__ import annotations

from torch import nn

from .blocks import BLOCK_TYPES
from .layers import conv_norm_act

MODE_TO_BODY_ARCHITECTURES = {
    "fast": (4, 2, 2, 1, 1),
    "faster": (2, 1, 1, 1, 1),
    "fastest": (2, 1, 1, 1, 1),
}
MODE_TO_BODY_CHANNELS = {
    "fast": (64, 64, 128, 256, 512),
    "faster": (64, 64, 128, 128, 256),
    "fastest": (32, 32, 64, 64, 128),
}


def resolve_body(body_mode, body_architecture, body_channels, out_indices):
    """Resolve the body plan and trim to the deepest tapped stage
    (`lfd_resnet.py:264-292`)."""
    if body_mode is not None:
        arch = list(MODE_TO_BODY_ARCHITECTURES[body_mode])
        chans = (list(body_channels) if body_channels is not None
                 else list(MODE_TO_BODY_CHANNELS[body_mode]))
    else:
        assert body_architecture is not None and body_channels is not None
        arch = list(body_architecture)
        chans = list(body_channels)
    assert len(arch) == len(chans)
    out_indices = tuple(sorted(tuple(o) for o in out_indices))
    for st, bl in out_indices:
        assert 0 <= st < len(arch) and 0 <= bl < arch[st]
    max_stage = max(st for st, _ in out_indices)
    return arch[: max_stage + 1], chans[: max_stage + 1], out_indices


def stem_plan(stem_mode, stem_channels):
    """[(out channels, kernel, stride)] of the stem's ConvNormActs."""
    if stem_mode == "fast":
        return [(stem_channels, 3, 2), (stem_channels, 1, 1)]
    if stem_mode == "faster":
        return [(stem_channels, 3, 2), (stem_channels, 1, 1),
                (stem_channels, 3, 2), (stem_channels, 1, 1)]
    if stem_mode == "fastest":
        return [(stem_channels // 2, 3, 2), (stem_channels, 3, 2)]
    raise ValueError("Unsupported stem_mode!")


class LFDResNet(nn.Module):
    """Backbone; forward(x NCHW) returns a tuple of feature maps at
    out_indices. `fused_stem` is the deploy-time dispatch to K2: when an
    engine sets it, the stem's first ConvNormAct runs as that callable on
    the raw uint8 frame (deploy/kernel_net.py)."""

    def __init__(self, block_mode="fast", stem_mode="fast", body_mode="fast",
                 input_channels=3, stem_channels=64, body_architecture=None,
                 body_channels=None,
                 out_indices=((0, 3), (1, 1), (2, 1), (3, 0), (4, 0)),
                 act_cfg=None, norm_cfg=None):
        super().__init__()
        act_cfg = act_cfg or dict(type="ReLU")
        norm_cfg = norm_cfg if norm_cfg is not None else dict(type="BatchNorm2d")
        arch, chans, out_indices = resolve_body(
            body_mode, body_architecture, body_channels, out_indices)
        self.out_indices = out_indices
        self.stem_stride = 2 if stem_mode == "fast" else 4

        stem_layers = []
        cin = input_channels
        for n, (ch, k, s) in enumerate(stem_plan(stem_mode, stem_channels)):
            unit = conv_norm_act(cin, ch, k, s, norm_cfg, act_cfg)
            if n == 0:
                self._stem0_len = len(unit)
            stem_layers += unit
            cin = ch
        self._stem = nn.Sequential(*stem_layers)

        block_cls = BLOCK_TYPES[block_mode]
        self.num_stages = len(arch)
        for i, (num_blocks, ch) in enumerate(zip(arch, chans)):
            blocks = []
            for j in range(num_blocks):
                blocks.append(block_cls(cin, ch, stride=2 if j == 0 else 1,
                                        use_downsample=j == 0,
                                        act_cfg=act_cfg, norm_cfg=norm_cfg))
                cin = ch
            setattr(self, f"stage{i}", nn.Sequential(*blocks))
        self.num_output_channels_list = [chans[st] for st, _ in out_indices]
        self.num_output_strides_list = [
            self.stem_stride * (2 ** (st + 1)) for st, _ in out_indices]
        self.fused_stem = None

    def stages(self):
        return [getattr(self, f"stage{i}") for i in range(self.num_stages)]

    def stem_forward(self, x):
        if self.fused_stem is not None:
            return self._stem[self._stem0_len:](self.fused_stem(x))
        return self._stem(x)

    def body_forward(self, x):
        outs = []
        for i, stage in enumerate(self.stages()):
            for j, block in enumerate(stage):
                x = block(x)
                if (i, j) in self.out_indices:
                    outs.append(x)
        return tuple(outs)

    def forward(self, x):
        return self.body_forward(self.stem_forward(x))
