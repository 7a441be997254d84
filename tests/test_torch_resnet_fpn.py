# The port's ResNet, FPN / SimpleFPN, LFDHeadV1, the ResNet converter and the
# weight bridge's FCOS-family parts against lfdtpu on the CPU, from seeded
# numpy inputs and the same weights (lfdtpu's init, norms randomized, through
# execution/jax_convert.py):
#   - ResNet-18/50 shapes and parameter counts (tests/test_models.py:144-164);
#   - the backbone taps, pytorch and caffe styles, deep_stem, in eval mode:
#     max|err|/max|ref| <= 1e-5 (float32 convs summed in another order); in
#     train mode (norm_eval and frozen_stages) with the updated BN running
#     statistics, and the gradients of the taps under frozen_stages (zero
#     for the stem at frozen_stages=0 and for stage 1 at 1): both packages
#     in float64, taps within 1e-9, and the gradients and statistics within
#     1e-6 and 1e-5 (the bridge hands lfdtpu's back in float32), since BatchNorm on batch statistics over 8
#     values a channel (the stride-32 level) amplifies float32 rounding up to
#     ~1e-2 in the early gradients (flax's E[x^2] - E[x]^2: ROADMAP F8);
#   - FPN and SimpleFPN (neighbouring_mode, pooled extras, extra_on_input) at
#     a 200x264 frame, whose ResNet levels 25x33 / 13x17 / 7x9 upsample by
#     non-integer ratios, within 1e-5; and F3's pin: the port's upsample picks
#     jax.image.resize(method="nearest")'s pixels at 7->13, 13->25 and 9->17,
#     where torch's mode="nearest" does not;
#   - LFDHeadV1 on an LFD with SimpleFPN, within 1e-5;
#   - convert_torchvision_resnet on a torchvision-named state_dict built here:
#     it loads strictly, the features equal lfdtpu's converter's on the same
#     dict within 1e-5, and unknown, missing or misshapen keys raise;
#   - the bridge on these nets is strict: an unmapped leaf or a missing
#     entry raises.
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lfdtpu.execution.torch_convert import convert_torchvision_resnet as jax_convert_resnet
from lfdtpu.models import FCOS as JFCOS
from lfdtpu.models import FPN as JFPN
from lfdtpu.models import LFD as JLFD
from lfdtpu.models import FCOSHead as JFCOSHead
from lfdtpu.models import LFDHeadV1 as JLFDHeadV1
from lfdtpu.models import ResNet as JResNet
from lfdtpu.models import SimpleFPN as JSimpleFPN
from lfdtpu.ops import loss_wrappers as JW
from lfdtpu_torch.execution import convert_torchvision_resnet, jax_variables_to_state_dict
from lfdtpu_torch.models import (FCOS, FPN, LFD, FCOSHead, LFDHeadV1, ResNet, SimpleFPN,
                                 nearest_upsample_to)
from lfdtpu_torch.ops import loss_wrappers as TW
from tests.test_torch_bridge import randomize_norms
from tests.test_torch_train_step import max_rel

torch.set_num_threads(1)

TOL = 1e-5
X64_TOL = 1e-9  # float64 runs (see above)
GN = dict(type="GroupNorm", num_groups=8)
TAPS = ((2, 1), (3, 1), (4, 1))  # strides 8, 16, 32


def build_pair(backbone=None, neck="fpn", head="fcos", num_classes=3, seed=0, hw=(64, 64),
               **neck_kw):
    """lfdtpu's and the port's detector on the same parts: a narrow ResNet
    (base 16 channels; `backbone` overrides its arguments), an FPN /
    SimpleFPN of 32 channels and 5 levels, and an FCOSHead (FCOS) or an
    LFDHeadV1 (LFD), GroupNorm(8) in the head. Returns (JAX detector, its
    numpy variables with randomized norms, port detector with them loaded,
    in eval mode)."""
    bkw = dict(depth=18, base_channels=16, out_indices=TAPS, norm_cfg=dict(type="BN"))
    bkw.update(backbone or {})
    jbb, tbb = JResNet(**bkw), ResNet(**bkw)
    strides, chans = tbb.num_output_strides_list, tbb.num_output_channels_list
    nkw = dict(num_output_channels=32, num_outputs=5, relu_before_extra=True)
    nkw.update(neck_kw)
    jn_cls, tn_cls = (JFPN, FPN) if neck == "fpn" else (JSimpleFPN, SimpleFPN)
    jneck = jn_cls(num_input_strides_list=tuple(strides), **nkw)
    tneck = tn_cls(chans, strides, **nkw)
    out_strides = tneck.num_output_strides_list
    ranges = tuple((32 * i, 32 * (i + 1)) for i in range(len(out_strides) - 1)) + ((128, 1e8),)
    args = dict(num_classes=num_classes, regression_ranges=ranges, point_strides=out_strides)
    if head == "fcos":
        jhead = JFCOSHead(num_classes=num_classes, num_heads=len(out_strides),
                          num_head_channels=32, num_layers=2, norm_cfg=GN)
        thead = FCOSHead(num_classes, 32, len(out_strides), 32, 2, GN)
        jdet = JFCOS(jbb, jneck, jhead, classification_loss_func=JW.FocalLoss(),
                     regression_loss_func=JW.IoULoss(), **args)
        tdet = FCOS(tbb, tneck, thead, classification_loss_func=TW.FocalLoss(),
                    regression_loss_func=TW.IoULoss(), **args)
    else:
        hkw = dict(num_classes=num_classes, num_heads=len(out_strides), num_head_channels=32,
                   num_conv_layers=2, norm_cfg=GN)
        jhead, thead = JLFDHeadV1(**hkw), LFDHeadV1(in_channels=32, **hkw)
        jdet = JLFD(jbb, jneck, jhead, classification_loss_func=JW.FocalLoss(),
                    regression_loss_func=JW.IoULoss(), **args)
        tdet = LFD(tbb, tneck, thead, classification_loss_func=TW.FocalLoss(),
                   regression_loss_func=TW.IoULoss(), **args)
    variables = randomize_norms(jdet.init(jax.random.PRNGKey(seed), hw), seed)
    tdet.net.load_state_dict(jax_variables_to_state_dict(variables, tdet.net), strict=True)
    tdet.net.eval()
    return jdet, variables, tdet


def images(seed, hw, B=2):
    return np.random.RandomState(seed).uniform(-1, 1, (B,) + tuple(hw) + (3,)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def part_vars(variables, name):
    return {k: v[name] for k, v in variables.items() if name in v}


# ------------------------------------------------------------------ ResNet

def test_resnet_shapes_and_parameter_counts():
    rn = ResNet(depth=18, out_indices=((1, 1), (2, 1), (3, 1), (4, 1)))
    assert rn.num_output_channels_list == [64, 128, 256, 512]
    assert rn.num_output_strides_list == [4, 8, 16, 32]
    feats = rn.eval()(torch.zeros(1, 3, 64, 64))
    assert [tuple(f.shape) for f in feats] == [(1, 64, 16, 16), (1, 128, 8, 8),
                                               (1, 256, 4, 4), (1, 512, 2, 2)]
    # torchvision's resnet18 / resnet50 bodies without fc
    assert sum(p.numel() for p in rn.parameters()) == 11176512
    assert sum(p.numel() for p in ResNet(depth=50).parameters()) == 23508032
    # stages past the deepest tap are not built
    assert not hasattr(ResNet(depth=18, out_indices=((2, 1),)), "layer3")


@pytest.mark.parametrize("backbone", [
    dict(depth=18),
    dict(depth=50, style="pytorch"),
    dict(depth=50, style="caffe"),
    dict(depth=50, style="caffe", deep_stem=True, frozen_stages=1),
    dict(depth=18, deep_stem=True, norm_cfg=dict(type="GN", num_groups=4)),
], ids=["r18", "r50-pytorch", "r50-caffe", "r50-caffe-deep-frozen", "r18-deep-gn"])
def test_resnet_taps_match_lfdtpu(backbone):
    jdet, variables, tdet = build_pair(backbone)
    x = images(1, (64, 96))
    v = part_vars(variables, "backbone")
    ref = jdet.backbone.apply(v, jnp.asarray(x), train=False)
    got = tdet.net._backbone(nchw(x))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert max_rel(g.detach().permute(0, 2, 3, 1).numpy(), r) <= TOL


def x64_backbone(bkw, seed):
    """(JAX backbone, its variables, the port's backbone with them, input),
    all in float64."""
    jdet, variables, tdet = build_pair(bkw)
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), part_vars(variables, "backbone"))
    return jdet.backbone, v, variables, tdet, images(seed, (64, 64)).astype(np.float64)


@pytest.mark.parametrize("frozen_stages,norm_eval", [(-1, True), (1, False), (-1, False)])
def test_resnet_train_mode_matches_lfdtpu(frozen_stages, norm_eval):
    bkw = dict(depth=50, style="caffe", frozen_stages=frozen_stages, norm_eval=norm_eval)
    jbb, v, variables, tdet, x = x64_backbone(bkw, 2)
    with jax.enable_x64(True):
        ref, upd = jbb.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        ref, upd = jax.device_get((ref, upd))
    bb = tdet.net._backbone.double().train()
    before = {k: t.clone() for k, t in bb.state_dict().items() if "running" in k}
    got = bb(nchw(x))
    for g, r in zip(got, ref):
        assert max_rel(g.detach().permute(0, 2, 3, 1).numpy(), r) <= X64_TOL
    # the running statistics: lfdtpu's updated tree through the bridge
    ref_sd = jax_variables_to_state_dict(
        {"params": variables["params"],
         "batch_stats": dict(variables["batch_stats"], backbone=upd["batch_stats"])},
        tdet.net)
    moved = []
    for k, t in bb.state_dict().items():
        if "running" in k:
            # the bridge hands float32 back: compare at its precision
            assert max_rel(t.float().numpy(), ref_sd["_backbone." + k].numpy()) <= TOL, k
            if not torch.equal(t, before[k]):
                moved.append(k.split(".")[0])
    if norm_eval:
        assert moved == []
    elif frozen_stages == 1:  # the stem and stage 1 keep theirs
        assert moved and not {"bn1", "layer1"} & set(moved)
    else:
        assert "bn1" in moved and "layer1" in moved


@pytest.mark.parametrize("frozen_stages", [0, 1])
def test_frozen_stages_give_zero_gradients_as_lfdtpu(frozen_stages):
    bkw = dict(depth=18, frozen_stages=frozen_stages, norm_eval=False)
    jbb, v, variables, tdet, x = x64_backbone(bkw, 3)

    def loss(params):
        outs, _ = jbb.apply({"params": params, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return sum(jnp.sum(o) for o in outs)

    with jax.enable_x64(True):
        jgrads = jax.device_get(jax.grad(loss)(v["params"]))
    bb = tdet.net._backbone.double().train()
    sum(o.sum() for o in bb(nchw(x))).backward()
    ref = jax_variables_to_state_dict(
        {"params": dict(variables["params"], backbone=jgrads),
         "batch_stats": variables["batch_stats"]}, tdet.net)
    frozen = ["conv1.", "bn1."] + (["layer1."] if frozen_stages >= 1 else [])
    for name, p in bb.named_parameters():
        r = ref["_backbone." + name].numpy()  # the bridge rounds to float32
        if any(name.startswith(f) for f in frozen):
            assert p.grad is None and not r.any(), name
        else:
            assert p.grad is not None and max_rel(p.grad.numpy(), r) <= 1e-6, name
    assert bb.layer2[0].conv1.weight.grad.abs().max() > 0


def test_norm_eval_is_the_default_and_keeps_running_stats():
    bb = ResNet(depth=18, base_channels=8).train()
    assert bb.norm_eval and all(not m.training for m in bb.modules()
                                if isinstance(m, torch.nn.BatchNorm2d))
    before = {k: t.clone() for k, t in bb.state_dict().items()}
    bb(torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0)))
    assert all(torch.equal(t, before[k]) for k, t in bb.state_dict().items())
    assert bb.training  # the module itself reports train mode


# -------------------------------------------------------- FPN, SimpleFPN, F3

@pytest.mark.parametrize("m,n", [(7, 13), (13, 25), (9, 17), (17, 33), (4, 8)])
def test_upsample_picks_lfdtpus_pixels(m, n):
    x = np.random.RandomState(m).randn(1, m, m + 2, 2).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (1, n, n + 3, 2), method="nearest"))
    got = nearest_upsample_to(nchw(x), (n, n + 3)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    if n % m:  # torch's "nearest" samples floor(i * in / out): other pixels
        other = F.interpolate(nchw(x), size=(n, n + 3), mode="nearest")
        assert not np.array_equal(other.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("neck,kw", [
    ("fpn", dict()),
    ("fpn", dict(extra_on_input=True, relu_before_extra=False)),
    ("fpn", dict(extra_type="pool", norm_on_lateral=True, relu_on_lateral=True,
                 norm_cfg=dict(type="BatchNorm2d"))),
    ("simple", dict()),
    ("simple", dict(neighbouring_mode=True, extra_type="pool")),
], ids=["fpn", "fpn-extra-on-input", "fpn-pool-norm-lateral", "simple", "simple-neighbouring"])
def test_necks_match_lfdtpu_at_non_integer_ratios(neck, kw):
    hw = (200, 264)  # ResNet levels 25x33, 13x17, 7x9
    jdet, variables, tdet = build_pair(neck=neck, hw=hw, **kw)
    x = images(4, hw)
    feats = tdet.net._backbone(nchw(x))
    assert [tuple(f.shape[2:]) for f in feats] == [(25, 33), (13, 17), (7, 9)]
    ref = jdet.neck.apply(part_vars(variables, "neck"),
                          tuple(jnp.asarray(f.detach().permute(0, 2, 3, 1).numpy())
                                for f in feats))
    got = tdet.net._neck(feats)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert max_rel(g.detach().permute(0, 2, 3, 1).numpy(), r) <= TOL


@pytest.mark.parametrize("neck", ["fpn", "simple"])
def test_dense_outputs_match_lfdtpu(neck):
    # the whole net: FCOS on FPN, LFD with LFDHeadV1 on SimpleFPN
    head = "fcos" if neck == "fpn" else "v1"
    jdet, variables, tdet = build_pair(neck=neck, head=head, hw=(200, 264))
    x = images(5, (200, 264))
    ref = jdet.net.apply(variables, jnp.asarray(x), train=False)
    got = tdet.net(torch.from_numpy(x))
    assert len(got) == len(ref) == (3 if head == "fcos" else 2)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert max_rel(g.detach().numpy(), r) <= TOL


# ---------------------------------------------------------------- heads

def test_lfd_head_v1_shares_its_trunks():
    head = LFDHeadV1(num_classes=2, num_heads=3, in_channels=32, num_head_channels=32,
                     regression_loss_type="IoULoss", norm_cfg=dict(type="BatchNorm2d"))
    sd = head.state_dict()
    assert "cls_trunk.0.weight" in sd and "cls_final2.weight" in sd and "_scales.2._scale" in sd
    assert not any(k.startswith("cls_trunk1") for k in sd)
    cls, reg = head.eval()([torch.zeros(1, 32, 2 ** (3 - i), 2 ** (3 - i)) for i in range(3)])
    assert cls[0].shape == (1, 2, 8, 8) and reg[2].shape == (1, 4, 2, 2)
    no_scale = LFDHeadV1(2, 3, 32, regression_loss_type="SmoothL1Loss")
    assert not no_scale.with_scale and "_scales.0._scale" not in no_scale.state_dict()


# ------------------------------------------------------------ converter

def torchvision_state_dict(depth, seed, deep_stem=False, prefix="module."):
    """A torchvision-named ResNet state_dict built from torchvision's layout
    (conv1/bn1 or mmdet's deep stem.{0,1,3,4,6,7}, layer{s}.{j}.conv{k}/
    bn{k}/downsample.{0,1}, fc), seeded random values."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = rng.randn(cout, cin, k, k).astype(np.float32) * 0.1

    def bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".bias"] = rng.randn(c).astype(np.float32) * 0.1
        sd[name + ".running_mean"] = rng.randn(c).astype(np.float32) * 0.1
        sd[name + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.array(7)

    basic = depth < 50
    blocks = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}[depth]
    if deep_stem:
        for i, (cin, cout) in enumerate(((3, 32), (32, 32), (32, 64))):
            conv(f"stem.{3 * i}", cout, cin, 3)
            bn(f"stem.{3 * i + 1}", cout)
    else:
        conv("conv1", 64, 3, 7)
        bn("bn1", 64)
    cin = 64
    for s, n in enumerate(blocks, start=1):
        planes = 64 * 2 ** (s - 1)
        out = planes if basic else planes * 4
        for j in range(n):
            p = f"layer{s}.{j}"
            shapes = ([(planes, cin, 3), (planes, planes, 3)] if basic else
                      [(planes, cin, 1), (planes, planes, 3), (out, planes, 1)])
            for k, (co, ci, ks) in enumerate(shapes, start=1):
                conv(f"{p}.conv{k}", co, ci, ks)
                bn(f"{p}.bn{k}", co)
            if j == 0 and (s > 1 or cin != out):
                conv(f"{p}.downsample.0", out, cin, 1)
                bn(f"{p}.downsample.1", out)
            cin = out
    sd["fc.weight"] = rng.randn(1000, cin).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("depth,deep_stem", [(18, False), (50, False), (50, True)])
def test_convert_torchvision_resnet_matches_lfdtpus_converter(depth, deep_stem):
    sd = torchvision_state_dict(depth, depth, deep_stem)
    kw = dict(depth=depth, deep_stem=deep_stem, out_indices=((1, 0), (3, 1), (4, 1)),
              style="caffe")
    rn = ResNet(**kw)
    rn.load_state_dict(convert_torchvision_resnet(sd, rn), strict=True)
    assert torch.equal(rn.layer4[1].conv1.weight,
                       torch.from_numpy(sd["module.layer4.1.conv1.weight"]))
    jrn = JResNet(**kw)
    x = images(6, (64, 64), B=1)
    jv = jrn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # lfdtpu's converter drops `fc.` before it strips `module.`: hand it
    # the unprefixed classifier-free dict
    jv = jax_convert_resnet({k[len("module."):]: v for k, v in sd.items()
                             if not k.startswith("module.fc.")}, jv)
    ref = jrn.apply(jv, jnp.asarray(x))
    got = rn.eval()(nchw(x))
    for g, r in zip(got, ref):
        assert max_rel(g.detach().permute(0, 2, 3, 1).numpy(), r) <= TOL


def test_convert_torchvision_resnet_is_strict():
    sd = torchvision_state_dict(18, 0, prefix="")
    rn = ResNet(depth=18)
    extra = dict(sd, **{"layer1.0.conv9.weight": np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="unknown"):
        convert_torchvision_resnet(extra, rn)
    with pytest.raises(ValueError, match="missing"):
        convert_torchvision_resnet({k: v for k, v in sd.items() if "layer2.1" not in k}, rn)
    bad = dict(sd, **{"layer1.0.conv1.weight": np.zeros((64, 64, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        convert_torchvision_resnet(bad, rn)
    # a checkpoint deeper than the stages the template builds
    with pytest.raises(ValueError, match="unknown"):
        convert_torchvision_resnet(sd, ResNet(depth=18, out_indices=((2, 1),)))


# ---------------------------------------------------------------- bridge

@functools.cache
def bridge_case(head):
    neck = "fpn" if head == "fcos" else "simple"
    return build_pair(neck=neck, head=head)


@pytest.mark.parametrize("head", ["fcos", "v1"])
def test_bridge_is_strict_on_the_new_parts(head):
    _, variables, tdet = bridge_case(head)
    extra = jax.tree.map(lambda a: a, variables)
    extra["params"]["neck"]["fpn_out9"] = {"kernel": np.zeros((3, 3, 32, 32), np.float32)}
    with pytest.raises(ValueError, match="unmapped JAX leaves"):
        jax_variables_to_state_dict(extra, tdet.net)
    short = jax.tree.map(lambda a: a, variables)
    del short["params"]["head"]["scale4"]
    with pytest.raises(KeyError, match="scale4"):
        jax_variables_to_state_dict(short, tdet.net)
    # a port entry that no JAX leaf fills
    net = copy.deepcopy(tdet.net)
    net._head.extra = torch.nn.Conv2d(1, 1, 1)
    with pytest.raises(ValueError, match="missing"):
        jax_variables_to_state_dict(variables, net)
