# LFD-ResNet backbone (`lfdtpu/models/lfd_resnet.py`, reference
# `lfd/model/backbone/lfd_resnet.py:218-509`).
#
# Structure: stem ('fast' /2, 'faster' /4, 'fastest' /4) then stages of
# residual blocks; the first block of every stage is stride-2 with a 1x1
# projection shortcut. Outputs are tapped at (stage, block) `out_indices`.
#
# frozen_stages / norm_eval (`lfdtpu/models/lfd_resnet.py:142-164`): frozen
# parts (the stem when frozen_stages > 0, stage i when i < frozen_stages) run
# their norms in eval mode and their outputs are detach()ed where lfdtpu
# applies stop_gradient; norm_eval puts every backbone norm in eval mode.
# As in lfdtpu, frozen parameters still exist for the optimizer: they get
# zero gradients (see parallel/data_parallel.py), not requires_grad=False.

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


def lfd_resnet_output_info(
    stem_mode="fast",
    body_mode="fast",
    body_architecture=None,
    body_channels=None,
    out_indices=((0, 3), (1, 1), (2, 1), (3, 0), (4, 0)),
):
    """(num_output_channels_list, num_output_strides_list) of an LFDResNet,
    from its plan alone: no module is built (`lfdtpu/models/lfd_resnet.py:
    50-63`)."""
    _, chans, out_indices = resolve_body(body_mode, body_architecture, body_channels,
                                         out_indices)
    stem_stride = 2 if stem_mode == "fast" else 4
    return ([chans[st] for st, _ in out_indices],
            [stem_stride * 2 ** (st + 1) for st, _ in out_indices])


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
                 frozen_stages=-1, act_cfg=None, norm_cfg=None, norm_eval=False):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        act_cfg = act_cfg or dict(type="ReLU")
        norm_cfg = norm_cfg if norm_cfg is not None else dict(type="BatchNorm2d")
        arch, chans, out_indices = resolve_body(
            body_mode, body_architecture, body_channels, out_indices)
        self.out_indices = out_indices

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
        self.num_output_channels_list, self.num_output_strides_list = lfd_resnet_output_info(
            stem_mode, body_mode, body_architecture, body_channels, out_indices)
        self.fused_stem = None

    def stages(self):
        return [getattr(self, f"stage{i}") for i in range(self.num_stages)]

    def train(self, mode=True):
        """torch's train(), then eval mode for the frozen parts' norms
        (lfdtpu: stem_train = bn_train and frozen_stages <= 0, stage_train =
        bn_train and i >= frozen_stages)."""
        super().train(mode)
        if mode:
            frozen = [self._stem] if self.norm_eval or self.frozen_stages > 0 else []
            frozen += [s for i, s in enumerate(self.stages())
                       if self.norm_eval or i < self.frozen_stages]
            for part in frozen:
                part.eval()
        return self

    def stem_forward(self, x):
        if self.fused_stem is not None:
            x = self._stem[self._stem0_len:](self.fused_stem(x))
        else:
            x = self._stem(x)
        return x.detach() if self.frozen_stages > 0 else x

    def body_forward(self, x):
        outs = []
        for i, stage in enumerate(self.stages()):
            for j, block in enumerate(stage):
                x = block(x)
                if i < self.frozen_stages:
                    # no gradient reaches a frozen stage, even through taps
                    x = x.detach()
                if (i, j) in self.out_indices:
                    outs.append(x)
        return tuple(outs)

    def forward(self, x):
        return self.body_forward(self.stem_forward(x))
