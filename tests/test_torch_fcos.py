# The port's FCOS family against lfdtpu's on the CPU, on seeded inputs and
# bridged weights (tests/test_torch_resnet_fpn.py::build_pair: a narrow
# ResNet, an FPN and an FCOSHead, norms randomized):
#   - FCOSHead: outputs, the classification prior bias, a positive float32
#     regression (also when the net runs in bf16);
#   - fcos_assign, fcos_v1_assign (multi-label points) and centerness_target
#     against lfdtpu's vmapped versions, tied areas included: labels and
#     masks exact, float targets within rtol and atol 1e-6;
#   - the 'direct' decode with score_factors, with and without the per-level
#     limit: the same count and labels, scores within rtol 1e-6, boxes
#     within 1e-4 px (exp and sigmoid round the last place differently);
#   - FCOS and FCOSv1 get_loss: each term and num_pos within rtol 1e-5, the
#     gradients into the dense outputs within max|err|/max|ref| 1e-5;
#   - get_results and predict_for_single_image rows against lfdtpu's: count
#     and labels equal, scores within rtol 1e-5, boxes within 1e-3 px;
#   - two fp32 train steps with frozen_stages=1 and weight decay against
#     lfdtpu's make_train_step (metrics and every param and statistic within
#     1e-4): the frozen parameters move by weight decay alone (ROADMAP F7);
#   - tests/test_detector_variants.py's FCOS cases on the port, beside
#     lfdtpu's values: the train-mode losses within rtol 1e-4 (BatchNorm on
#     batch statistics), the predict rows as above.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.execution import optim as jax_optim
from lfdtpu.models import FCOSv1 as JFCOSv1
from lfdtpu.ops import assign as jax_assign
from lfdtpu.ops.decode import DecodeSpec as JSpec
from lfdtpu.ops.decode import decode_predictions as jax_decode
from lfdtpu.ops.points import concat_level_info
from lfdtpu.parallel.data_parallel import TrainState as JaxTrainState
from lfdtpu.parallel.data_parallel import make_train_step as jax_make_train_step
from lfdtpu_torch.execution import SGD, jax_variables_to_state_dict
from lfdtpu_torch.models import FCOSv1
from lfdtpu_torch.models.heads import FCOS_PRIOR_BIAS
from lfdtpu_torch.ops import assign
from lfdtpu_torch.ops.decode import DecodeSpec, decode_predictions
from lfdtpu_torch.parallel import create_train_state, make_train_step
from tests.test_torch_boxes_assign import TOL, level_arrays, random_gt
from tests.test_torch_resnet_fpn import build_pair, images
from tests.test_torch_train_step import make_batch, max_rel

torch.set_num_threads(1)

HW = (64, 64)
C = 3


@functools.cache
def pair(v1=False, spiced=False, backbone=()):
    """(JAX detector, numpy variables, port detector): FCOS, or FCOSv1 on the
    same parts; `spiced` scales the classification, regression and
    centerness convs as tests/test_reference_parity_v2.py:287-301 does, so a
    random net gives sparse confident detections."""
    jdet, variables, tdet = build_pair(dict(backbone), num_classes=C)
    if spiced:
        params = jax.tree.map(np.array, variables["params"])
        h = params["head"]
        h["classification"]["kernel"] *= 30.0
        h["classification"]["bias"] -= 2.0
        h["regression"]["kernel"] *= 5.0
        h["centerness"]["kernel"] *= 3.0
        h["centerness"]["bias"] += 3.0
        variables = dict(variables, params=params)
        tdet.net.load_state_dict(jax_variables_to_state_dict(variables, tdet.net))
    if v1:
        args = dict(num_classes=C, regression_ranges=jdet.regression_ranges,
                    point_strides=jdet.point_strides)
        jdet = JFCOSv1(jdet.backbone, jdet.neck, jdet.head,
                       classification_loss_func=jdet.classification_loss_func,
                       regression_loss_func=jdet.regression_loss_func, **args)
        tdet = FCOSv1(tdet.net._backbone, tdet.net._neck, tdet.net._head,
                      classification_loss_func=tdet.classification_loss_func,
                      regression_loss_func=tdet.regression_loss_func, **args)
    return jdet, variables, tdet


# ------------------------------------------------------------------- head

def test_fcos_head_outputs_prior_and_positive_regression():
    _, _, tdet = pair.__wrapped__()  # a fresh pair: this test re-inits it
    tdet.init(torch.Generator().manual_seed(0))
    head = tdet.net._head
    assert torch.allclose(head._classification.bias, torch.tensor(FCOS_PRIOR_BIAS))
    assert abs(FCOS_PRIOR_BIAS + np.log(99.0)) < 1e-12
    assert not head._centerness.bias.any() and not head._regression.bias.any()
    assert all(float(s._scale.detach()) == 1.0 for s in head._scales)
    feats = [torch.zeros(1, 32, 8, 8), torch.zeros(1, 32, 4, 4)] * 2 + [torch.zeros(1, 32, 1, 1)]
    cls, reg, ctr = head(feats)
    assert cls[0].shape == (1, C, 8, 8) and reg[1].shape == (1, 4, 4, 4)
    assert ctr[0].shape == (1, 1, 8, 8)
    assert all((r > 0).all() for r in reg)  # exp inside the head: exp(0) = 1
    # the regression's exp stays float32 when the net runs in bf16
    tdet.net.to(torch.bfloat16)
    cls, reg, ctr = tdet.net(torch.zeros(1, 64, 64, 3, dtype=torch.bfloat16))
    assert cls.dtype == ctr.dtype == torch.bfloat16 and reg.dtype == torch.float32
    # the reference's FCOSHead names (tests/test_reference_parity_v2.py:263-284)
    sd = head.state_dict()
    for k in ("_classification_path.0.weight", "_regression_path.3.weight",
              "_classification.bias", "_centerness.weight", "_regression.weight",
              "_scales.4._scale"):
        assert k in sd, k


# ------------------------------------------------------------------ assign

def run_both(fn, gt, labels, mask):
    info = level_arrays()
    args = (info["points"], info["ranges"])

    def single(b, l, m):
        return getattr(jax_assign, fn)(*args, b, l, m, C)

    ref = jax.vmap(single)(jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(mask))
    got = getattr(assign, fn)(*(torch.from_numpy(a) for a in args), torch.from_numpy(gt),
                              torch.from_numpy(labels), torch.from_numpy(mask), C)
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


def tied_gt():
    gt, labels, mask = random_gt(31)
    # two boxes of one area over the same points, other classes: the first
    # wins FCOS's min-area argmin in both packages; FCOSv1 marks both classes
    gt[0, 1] = [4, 4, 24, 12]
    gt[0, 2] = [6, 2, 12, 24]
    labels[0, 1:3] = [0, 2]
    mask[0, 1:3] = True
    return gt, labels, mask


@pytest.mark.parametrize("seed", [21, 22])
def test_fcos_assign_matches_lfdtpu(seed):
    gt, labels, mask = tied_gt() if seed == 21 else random_gt(seed)
    (tl, tr), (jl, jr) = run_both("fcos_assign", gt, labels, mask)
    assert tl.dtype == np.int32 and tl.shape == jl.shape == (3, 336)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tr, jr, **TOL)
    assert (tl < C).any() and (tl[1] == C).all()  # positives; the empty image
    np.testing.assert_allclose(assign.centerness_target(torch.from_numpy(tr)).numpy(),
                               np.asarray(jax_assign.centerness_target(jr)), **TOL)


def test_fcos_v1_assign_marks_every_class_as_lfdtpu():
    gt, labels, mask = tied_gt()
    (tf, tr), (jf, jr) = run_both("fcos_v1_assign", gt, labels, mask)
    assert tf.dtype == np.bool_ and tf.shape == jf.shape == (3, 336, C)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tr, jr, **TOL)
    assert (tf.sum(-1) > 1).any()  # multi-label points
    labels[0, 0] = 7  # outside [0, C): lfdtpu's one-hot row writes nothing
    (tf, _), (jf, _) = run_both("fcos_v1_assign", gt, labels, mask)
    np.testing.assert_array_equal(tf, jf)


def test_fcos_assign_batch_chunks_agree(monkeypatch):
    gt, labels, mask = random_gt(23, B=5)
    info = level_arrays()
    args = (torch.from_numpy(info["points"]), torch.from_numpy(info["ranges"]),
            torch.from_numpy(gt), torch.from_numpy(labels), torch.from_numpy(mask), C)
    whole = [assign.fcos_assign(*args), assign.fcos_v1_assign(*args)]
    monkeypatch.setattr(assign, "_PAIR_BUDGET", 2 * 336 * 8)  # 2 images per chunk
    for a, b in zip(whole, [assign.fcos_assign(*args), assign.fcos_v1_assign(*args)]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------------ decode

@pytest.mark.parametrize("lim", [0, 6])
def test_direct_decode_with_score_factors_matches_lfdtpu(lim):
    info = concat_level_info([(8, 8), (4, 4), (2, 2)], [8, 16, 32],
                             [(0, 32), (32, 64), (64, 128)])
    level_sizes = (64, 16, 4)
    P = info["points"].shape[0]
    rng = np.random.RandomState(lim + 40)
    kw = dict(num_classes=C, reg_mode="direct", score_thr=0.05, nms_iou=0.5,
              pre_nms_points=P if lim == 0 else 1000, nms_budget=P * C, max_det=P,
              per_level_limit=lim)
    cls = (rng.randn(2, P, C) * 2).astype(np.float32)
    reg = np.exp(rng.randn(2, P, 4) + 2.0).astype(np.float32)  # pixels
    ctr = (rng.randn(2, P) * 2).astype(np.float32)
    factors = 1.0 / (1.0 + np.exp(-ctr))
    vhw = np.asarray([[64, 64], [50, 41]], np.float32)
    pv = ((info["points"][None, :, 0] < vhw[:, 1:2]) & (info["points"][None, :, 1] < vhw[:, 0:1]))
    got = decode_predictions(torch.from_numpy(cls), torch.from_numpy(reg),
                             torch.from_numpy(info["points"]), torch.from_numpy(info["ranges"]),
                             DecodeSpec(**kw), torch.from_numpy(vhw),
                             point_valid=torch.from_numpy(pv),
                             score_factors=torch.from_numpy(factors.astype(np.float32)),
                             level_sizes=level_sizes if lim else None)
    plain = decode_predictions(torch.from_numpy(cls), torch.from_numpy(reg),
                               torch.from_numpy(info["points"]),
                               torch.from_numpy(info["ranges"]), DecodeSpec(**kw),
                               torch.from_numpy(vhw), point_valid=torch.from_numpy(pv),
                               level_sizes=level_sizes if lim else None)
    assert not torch.equal(got["scores"], plain["scores"])  # the factors act
    for b in range(2):
        ref = jax_decode(jnp.asarray(cls[b]), jnp.asarray(reg[b]), jnp.asarray(info["points"]),
                         jnp.asarray(info["ranges"]), JSpec(**kw), (vhw[b, 0], vhw[b, 1]),
                         point_valid=jnp.asarray(pv[b]),
                         score_factors=jnp.asarray(factors[b].astype(np.float32)),
                         level_sizes=level_sizes if lim else None)
        n = int(ref["count"])
        assert int(got["count"][b]) == n and n > 0
        np.testing.assert_array_equal(got["labels"][b].numpy(), np.asarray(ref["labels"]))
        np.testing.assert_allclose(got["scores"][b].numpy(), np.asarray(ref["scores"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["boxes"][b].numpy(), np.asarray(ref["boxes"]),
                                   rtol=0, atol=1e-4)


def test_decode_spec_matches_lfdtpu():
    jdet, _, tdet = pair()
    js, ts = jdet.decode_spec(0.1, 0.6, class_agnostic=True), tdet.decode_spec(0.1, 0.6,
                                                                                class_agnostic=True)
    for k in DecodeSpec.__dataclass_fields__:
        if k != "nms_use_kernel":
            assert getattr(ts, k) == getattr(js, k), k
    assert ts.reg_mode == "direct" and ts.per_level_limit == tdet.pre_nms_bbox_limit == 1000


# -------------------------------------------------------------------- loss

@pytest.mark.parametrize("v1", [False, True], ids=["FCOS", "FCOSv1"])
def test_get_loss_matches_lfdtpu(v1):
    jdet, _, tdet = pair(v1)
    P = jdet.num_points(HW)
    rng = np.random.RandomState(7 + v1)
    cls_o = rng.normal(-1.0, 2.0, (2, P, C)).astype(np.float32)
    reg_o = np.exp(rng.normal(2.0, 1.0, (2, P, 4))).astype(np.float32)
    ctr_o = rng.normal(0.0, 1.0, (2, P, 1)).astype(np.float32)
    _, gt, labels, mask = make_batch(3, num_classes=C)

    def jax_loss(c, r, t):
        ld = jdet.get_loss((c, r, t), jnp.asarray(gt), jnp.asarray(labels),
                           jnp.asarray(mask), HW)
        return ld["loss"], ld["loss_values"]

    (_, jvals), jgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                                    has_aux=True))(cls_o, reg_o, ctr_o)
    outs = [torch.from_numpy(a).requires_grad_() for a in (cls_o, reg_o, ctr_o)]
    ld = tdet.get_loss(tuple(outs), torch.from_numpy(gt), torch.from_numpy(labels),
                       torch.from_numpy(mask), HW)
    ld["loss"].backward()
    assert set(ld["loss_values"]) == set(jvals)
    assert float(jvals["num_pos"]) > 0
    for k, v in ld["loss_values"].items():
        np.testing.assert_allclose(float(v.detach()), float(jvals[k]), rtol=1e-5, err_msg=k)
    for o, g in zip(outs, jgrads):
        assert max_rel(o.grad.numpy(), g) < 1e-5


# ------------------------------------------------------------ predict paths

def check_rows(got, ref):
    assert len(got) == len(ref)
    if not ref:
        return
    g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(g[:, 0], r[:, 0])
    np.testing.assert_allclose(g[:, 1], r[:, 1], rtol=1e-5)
    np.testing.assert_allclose(g[:, 2:], r[:, 2:], rtol=0, atol=1e-3)


def test_get_results_and_predict_match_lfdtpu():
    jdet, variables, tdet = pair(spiced=True)
    x = images(8, (128, 128))
    metas = [{"resized_height": 128, "resized_width": 128, "resize_scale": 1.0},
             {"resized_height": 100, "resized_width": 77, "resize_scale": 0.5}]
    ref = jdet.get_results(variables, jnp.asarray(x), metas)
    got = tdet.get_results(torch.from_numpy(x), metas)
    assert sum(map(len, ref)) >= 3
    for g, r in zip(got, ref):
        check_rows(g, r)
    frame = (np.random.RandomState(9).rand(90, 110, 3) * 255).astype(np.uint8)
    ref = jdet.predict_for_single_image(variables, frame, classification_threshold=0.05)
    got = tdet.predict_for_single_image(frame, classification_threshold=0.05)
    assert len(ref) > 0
    check_rows(got, ref)


# ------------------------------------------------------------- train step

STEP_TOL = 1e-4
LRS = (0.01, 0.02)


def test_two_train_steps_with_frozen_stage_match_lfdtpu():
    # frozen_stages=1: the stem and stage 1 get zero gradients in both
    # packages, and SGD's weight decay (with momentum) still moves them (F7)
    jdet, variables, tdet = pair.__wrapped__(backbone=(("frozen_stages", 1),))
    images_, gt, labels, mask = make_batch(5, num_classes=C, hw=HW)
    opt = jax_optim.SGD(momentum=0.9, weight_decay=1e-3)
    step = jax_make_train_step(jdet, opt, HW, clip_max_norm=10.0, donate=False)
    params, stats = (jax.tree.map(jnp.asarray, variables[k]) for k in ("params", "batch_stats"))
    state = JaxTrainState(params, stats, opt.init(params))
    batch = tuple(map(jnp.asarray, (images_, gt, labels, mask)))
    jmetrics = []
    for lr in LRS:
        state, m = step(state, *batch, jnp.float32(lr), jnp.bool_(True))
        jmetrics.append({k: float(v) for k, v in m.items()})
    state = jax.device_get(state)

    tstate = create_train_state(tdet, SGD(momentum=0.9, weight_decay=1e-3), device="cpu")
    bb = tdet.net._backbone
    frozen = {n: p.detach().clone() for n, p in bb.named_parameters()
              if n.split(".")[0] in ("conv1", "bn1", "layer1")}
    tstep = make_train_step(tdet, tstate.optimizer, HW, clip_max_norm=10.0)
    for lr, ref in zip(LRS, jmetrics):
        got = tstep(images_, gt, labels, mask, lr, True)
        assert set(got) == set(ref) and "centerness_loss" in got
        for k, v in got.items():
            assert max_rel(float(v), ref[k]) <= STEP_TOL, (k, float(v), ref[k])
    ref_sd = jax_variables_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}, tdet.net)
    for k, v in tdet.net.state_dict().items():
        if v.is_floating_point():
            assert max_rel(v.numpy(), ref_sd[k].numpy()) <= STEP_TOL, k
    # weight decay alone: buf = wd p0, p1 = p0 - lr0 buf;
    # buf' = 0.9 buf + wd p1, p2 = p1 - lr1 buf'
    for n, p0 in frozen.items():
        buf = 1e-3 * p0
        p1 = p0 - LRS[0] * buf
        p2 = p1 - LRS[1] * (0.9 * buf + 1e-3 * p1)
        p = dict(bb.named_parameters())[n].detach()
        assert torch.allclose(p, p2, rtol=1e-6, atol=1e-9), n
        assert not torch.equal(p, p0) or not p0.any(), n


# ------------------------------------ tests/test_detector_variants.py's FCOS

def tiny_pair(v1):
    """test_detector_variants.py::_tiny_parts with an FCOSHead (LFDResNet
    'fastest', SimpleNeck, two levels) in both packages, the same weights."""
    from lfdtpu.models import FCOS as JFCOS
    from lfdtpu.models import FCOSHead as JFCOSHead
    from lfdtpu.models import LFDResNet as JLFDResNet
    from lfdtpu.models import SimpleNeck as JSimpleNeck
    from lfdtpu.ops.loss_wrappers import FocalLoss as JFocal
    from lfdtpu.ops.loss_wrappers import IoULoss as JIoU
    from lfdtpu_torch.models import FCOS, FCOSHead, LFDResNet, SimpleNeck
    from lfdtpu_torch.ops.loss_wrappers import FocalLoss, IoULoss

    bkw = dict(block_mode="fastest", stem_mode="fastest", body_mode=None, stem_channels=16,
               body_architecture=(1, 1), body_channels=(16, 32), out_indices=((0, 0), (1, 0)),
               norm_cfg=dict(type="BatchNorm2d"))
    jbb, tbb = JLFDResNet(**bkw), LFDResNet(**bkw)
    strides = tuple(tbb.num_output_strides_list)
    args = dict(num_classes=3, regression_ranges=((0, 32), (32, 1e8)), point_strides=strides)
    jdet = (JFCOSv1 if v1 else JFCOS)(
        jbb, JSimpleNeck(num_neck_channels=32, num_input_strides_list=strides,
                         norm_cfg=dict(type="BatchNorm2d")),
        JFCOSHead(num_classes=3, num_heads=2, num_head_channels=32, num_layers=1, norm_cfg=None),
        classification_loss_func=JFocal(), regression_loss_func=JIoU(), **args)
    tdet = (FCOSv1 if v1 else FCOS)(
        tbb, SimpleNeck(tbb.num_output_channels_list, 32, strides),
        FCOSHead(3, 32, num_heads=2, num_head_channels=32, num_layers=1),
        classification_loss_func=FocalLoss(), regression_loss_func=IoULoss(), **args)
    variables = jax.device_get(jdet.init(jax.random.PRNGKey(0), HW))
    tdet.net.load_state_dict(jax_variables_to_state_dict(variables, tdet.net))
    return jdet, variables, tdet


@pytest.mark.parametrize("v1", [False, True], ids=["fcos_loss_and_predict",
                                                   "fcosv1_multiclass_loss"])
def test_detector_variants_fcos_cases(v1):
    from tests.test_detector import _batch

    jdet, variables, tdet = tiny_pair(v1)
    images_, gt, labels, mask = _batch(np.random.RandomState(3 if v1 else 0))
    labels = labels % 3
    if v1:  # two overlapping boxes of different classes: multi-label points
        gt[0, 1] = [12, 12, 24, 24]
        labels[0, 0], labels[0, 1] = 0, 2
        mask[0, 1] = True
    if not v1:  # before the train-mode forward moves the port's BN statistics
        frame = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
        rows = tdet.predict_for_single_image(frame, classification_threshold=0.01)
        assert isinstance(rows, list) and all(len(r) == 6 for r in rows)
        check_rows(rows, jdet.predict_for_single_image(variables, frame,
                                                       classification_threshold=0.01))
    outs, _ = jdet.forward(variables, jnp.asarray(images_), train=True)
    ref = jdet.get_loss(outs, jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(mask), HW)
    tdet.net.train()
    ld = tdet.get_loss(tdet.net(torch.from_numpy(images_)), torch.from_numpy(gt),
                       torch.from_numpy(labels), torch.from_numpy(mask), HW)
    assert torch.isfinite(ld["loss"]) and "centerness_loss" in ld["loss_values"]
    for k, v in ld["loss_values"].items():
        np.testing.assert_allclose(float(v.detach()), float(ref["loss_values"][k]),
                                   rtol=1e-4, err_msg=k)
