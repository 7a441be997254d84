# The port's LFDv2 family against lfdtpu's on the CPU, on seeded inputs and
# bridged weights:
#   - ops/assign.py::lfdv2_assign against lfdtpu's vmapped lfdv2_assign, every
#     range mode, with and without range normalization: rtol and atol 1e-6
#     (the same float32 ops; XLA may round the last place differently);
#   - the per-level pre-NMS top-k of decode (DecodeSpec.per_level_limit with
#     static level_sizes) against lfdtpu's on the cases of
#     tests/test_decode_parity.py:180-255, and a 45-class softmax head: the
#     same count and labels, scores within rtol 1e-6 and boxes within 1e-4 px
#     (exp and sigmoid round the last place differently in the two packages);
#   - LFDv2 and LFDv2Q get_loss (loss, each term, num_pos) within rtol 1e-5
#     and the gradients into the dense outputs within max|err|/max|ref| 1e-5
#     (tests/test_torch_get_loss.py's check);
#   - the fp32 LFDv2 engine's rows against lfdtpu's engine: count and labels
#     equal, scores within rtol 1e-5, boxes within 1e-3 px;
#   - LFDv2Q on extreme regression logits: a finite loss and finite
#     gradients (the exp clamp at 30), as lfdtpu's
#     tests/test_detector_variants.py::test_extreme_reg_logits_finite_loss_and_grad.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.deploy import compile_inference as jax_compile
from lfdtpu.deploy import make_device_preprocess as jax_preprocess
from lfdtpu.models.lfdv2 import LFDv2 as JLFDv2
from lfdtpu.models.lfdv2 import LFDv2Q as JLFDv2Q
from lfdtpu.ops import assign as jax_assign
from lfdtpu.ops import loss_wrappers as JW
from lfdtpu.ops.decode import DecodeSpec as JSpec
from lfdtpu.ops.decode import decode_predictions as jax_decode
from lfdtpu.ops.points import concat_level_info
from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
from lfdtpu_torch.models import LFDv2, LFDv2Q
from lfdtpu_torch.ops import assign
from lfdtpu_torch.ops import loss_wrappers as TW
from lfdtpu_torch.ops.decode import DecodeSpec, decode_predictions
from tests.test_torch_boxes_assign import MODES, TOL, level_arrays, random_gt
from tests.test_torch_bridge import jax_and_port
from tests.test_torch_get_loss import check_get_loss

torch.set_num_threads(1)


def variant(name, jax_cls, port_cls, cls_loss=None, **kw):
    """lfdtpu's and the port's `jax_cls` / `port_cls` built on the parts of the
    bridged zoo detector `name` (the same weights in both), with its classes,
    ranges, strides and losses unless `cls_loss` (a loss class name) or `kw`
    say otherwise."""
    jdet, variables, tdet = jax_and_port(name)
    out = []
    for det, cls, parts, wrappers in (
            (jdet, jax_cls, (jdet.backbone, jdet.neck, jdet.head), JW),
            (tdet, port_cls, (tdet.net._backbone, tdet.net._neck, tdet.net._head), TW)):
        args = dict(num_classes=det.num_classes, regression_ranges=det.regression_ranges,
                    point_strides=det.point_strides,
                    classification_loss_func=(getattr(wrappers, cls_loss)() if cls_loss
                                              else det.classification_loss_func),
                    regression_loss_func=det.regression_loss_func)
        args.update(kw)
        out.append(cls(*parts, **args))
    out[1].net.eval()
    return out[0], variables, out[1]


# ------------------------------------------------------------------ assign

def run_both(gt, labels, mask, num_classes, mode, normalize):
    info = level_arrays()
    args = (info["points"], info["strides"], info["ranges"], info["gray_ranges"])

    def single(b, l, m):
        return jax_assign.lfdv2_assign(*args, b, l, m, num_classes, range_assign_mode=mode,
                                       normalize_by_range=normalize)

    jc, jr = jax.vmap(single)(jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(mask))
    tc, tr = assign.lfdv2_assign(*(torch.from_numpy(a) for a in args), torch.from_numpy(gt),
                                 torch.from_numpy(labels), torch.from_numpy(mask),
                                 num_classes, range_assign_mode=mode,
                                 normalize_by_range=normalize)
    return (tc.numpy(), tr.numpy()), (np.asarray(jc), np.asarray(jr))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_lfdv2_assign_matches_lfdtpu(mode, normalize):
    gt, labels, mask = random_gt(10 + len(mode))
    (tc, tr), (jc, jr) = run_both(gt, labels, mask, 3, mode, normalize)
    assert tc.shape == jc.shape == (3, 16 * 16 + 8 * 8 + 4 * 4, 3)
    np.testing.assert_allclose(tc, jc, **TOL)
    np.testing.assert_allclose(tr, jr, **TOL)
    assert (tc >= 0).all()  # no hard ignores in v2
    assert (tc == 1.0).any()  # the core zone
    assert ((tc > 0) & (tc < 1)).any()  # centerness and the gray-zone relaxation
    assert (tc[1] == 0).all() and (tr[1] == 0).all()  # the empty image


def test_lfdv2_assign_batch_chunks_agree(monkeypatch):
    gt, labels, mask = random_gt(16, B=5)
    info = {k: torch.from_numpy(v) for k, v in level_arrays().items()}
    args = (info["points"], info["strides"], info["ranges"], info["gray_ranges"],
            torch.from_numpy(gt), torch.from_numpy(labels), torch.from_numpy(mask), 3)
    whole = assign.lfdv2_assign(*args)
    monkeypatch.setattr(assign, "_PAIR_BUDGET", 2 * 336 * 8)  # 2 images per chunk
    for a, b in zip(whole, assign.lfdv2_assign(*args)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ decode

@pytest.mark.parametrize("lim,use_softmax,C", [(6, False, 2), (20, False, 3), (6, True, 45),
                                               (100, False, 2)])
def test_per_level_decode_matches_lfdtpu(lim, use_softmax, C):
    # levels of 64, 16 and 4 points: a limit of 6 truncates two of them, 20
    # one, 100 none (the per-level path without a top-k)
    info = concat_level_info([(8, 8), (4, 4), (2, 2)], [8, 16, 32],
                             [(0, 32), (32, 64), (64, 128)])
    level_sizes = (64, 16, 4)
    P = info["points"].shape[0]
    rng = np.random.RandomState(lim + C)
    Cc = C + 1 if use_softmax else C
    kw = dict(num_classes=C, use_softmax=use_softmax, reg_mode="sigmoid",
              score_thr=0.01 if use_softmax else 0.3, nms_iou=0.5, nms_budget=P * C,
              max_det=P, per_level_limit=lim)
    for trial in range(3):
        cls = (rng.randn(2, P, Cc) * 2 - 1).astype(np.float32)
        reg = rng.randn(2, P, 4).astype(np.float32)
        vhw = np.asarray([[64, 64], [50, 41]], np.float32)
        pv = ((info["points"][None, :, 0] < vhw[:, 1:2])
              & (info["points"][None, :, 1] < vhw[:, 0:1]))
        got = decode_predictions(torch.from_numpy(cls), torch.from_numpy(reg),
                                 torch.from_numpy(info["points"]),
                                 torch.from_numpy(info["ranges"]), DecodeSpec(**kw),
                                 torch.from_numpy(vhw), point_valid=torch.from_numpy(pv),
                                 level_sizes=level_sizes)
        for b in range(2):
            ref = jax_decode(jnp.asarray(cls[b]), jnp.asarray(reg[b]),
                             jnp.asarray(info["points"]), jnp.asarray(info["ranges"]),
                             JSpec(**kw), (vhw[b, 0], vhw[b, 1]), point_valid=jnp.asarray(pv[b]),
                             level_sizes=level_sizes)
            n = int(ref["count"])
            assert int(got["count"][b]) == n and n > 0
            np.testing.assert_array_equal(got["labels"][b].numpy(), np.asarray(ref["labels"]))
            np.testing.assert_allclose(got["scores"][b].numpy(), np.asarray(ref["scores"]),
                                       rtol=1e-6)
            np.testing.assert_allclose(got["boxes"][b].numpy(), np.asarray(ref["boxes"]),
                                       rtol=0, atol=1e-4)


def test_per_level_decode_differs_from_the_global_top_k():
    info = concat_level_info([(8, 8), (4, 4), (2, 2)], [8, 16, 32],
                             [(0, 32), (32, 64), (64, 128)])
    P = info["points"].shape[0]
    rng = np.random.RandomState(3)
    cls = torch.from_numpy((rng.randn(1, P, 1) * 2).astype(np.float32))
    reg = torch.from_numpy(rng.randn(1, P, 4).astype(np.float32))
    args = (torch.from_numpy(info["points"]), torch.from_numpy(info["ranges"]))
    kw = dict(num_classes=1, reg_mode="sigmoid", score_thr=0.05, nms_iou=1.0, max_det=P)
    vhw = torch.tensor([[64.0, 64.0]])
    per_level = decode_predictions(cls, reg, *args, DecodeSpec(per_level_limit=6, **kw), vhw,
                                   level_sizes=(64, 16, 4))
    flat = decode_predictions(cls, reg, *args, DecodeSpec(pre_nms_points=6 * 3, **kw), vhw)
    assert not torch.equal(per_level["scores"], flat["scores"])
    with pytest.raises(AssertionError, match="level_sizes"):
        decode_predictions(cls, reg, *args, DecodeSpec(per_level_limit=6, **kw), vhw)


def test_lfdv2_defaults_and_decode_spec():
    jv2, _, tv2 = variant("WIDERFACE-S", JLFDv2, LFDv2, pre_nms_bbox_limit=123)
    for det in (jv2, tv2):
        assert det.range_assign_mode == "longer" and det.nms_threshold == 0.5
        assert det.decode_spec().per_level_limit == 123
        assert det.decode_spec().nms_budget == 123
    assert tv2.decode_spec() == DecodeSpec(**{
        k: getattr(jv2.decode_spec(), k) for k in DecodeSpec.__dataclass_fields__
        if k != "nms_use_kernel"})


# -------------------------------------------------------------------- loss

@pytest.mark.parametrize("name,kw", [
    ("WIDERFACE-S", dict(distance_to_bbox_mode="sigmoid")),
    ("TT100K-S", dict(distance_to_bbox_mode="sigmoid")),  # 45-class softmax CE
    ("TL-S", dict()),  # QFL + IoU, exp decode
])
def test_lfdv2_get_loss_matches_lfdtpu(name, kw):
    jv2, _, tv2 = variant(name, JLFDv2, LFDv2, **kw)
    check_get_loss(jv2, tv2, seed=len(name) + 20)


@pytest.mark.parametrize("coupling", [True, False])
@pytest.mark.parametrize("name", ["TL-S", "WIDERFACE-S"])
def test_lfdv2q_get_loss_matches_lfdtpu(name, coupling):
    jq, _, tq = variant(name, JLFDv2Q, LFDv2Q, cls_loss="QualityFocalLoss",
                        enable_iou_score_coupling=coupling)
    assert tq.distance_to_bbox_mode == "exp"
    check_get_loss(jq, tq, seed=len(name) + coupling)


def test_lfdv2q_requires_qfl():
    with pytest.raises(AssertionError, match="QualityFocalLoss"):
        variant("WIDERFACE-S", JLFDv2, LFDv2Q)


def test_lfdv2q_extreme_regression_logits_stay_finite():
    # outputs at negative points carry zero weight in both terms, so training
    # can drive them anywhere: +200 overflows exp in float32 without the
    # clamp, and NaN * 0 would poison the loss (lfdtpu's
    # test_extreme_reg_logits_finite_loss_and_grad, the LFDv2Q part)
    from tests.test_torch_train_step import HW, make_batch

    jq, _, tq = variant("TL-S", JLFDv2Q, LFDv2Q)
    _, gt, labels, mask = make_batch(4, num_classes=1)
    P = tq.num_points(HW)
    cls = torch.full((2, P, 1), -5.0, requires_grad=True)
    reg = torch.full((2, P, 4), 200.0, requires_grad=True)
    ld = tq.get_loss((cls, reg), torch.from_numpy(gt), torch.from_numpy(labels),
                     torch.from_numpy(mask), HW)
    ld["loss"].backward()
    assert torch.isfinite(ld["loss"]) and float(ld["loss_values"]["num_pos"]) > 0
    assert torch.isfinite(cls.grad).all() and torch.isfinite(reg.grad).all()
    ref = jq.get_loss((jnp.full((2, P, 1), -5.0), jnp.full((2, P, 4), 200.0)),
                      jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(mask), HW)
    for k, v in ld["loss_values"].items():
        np.testing.assert_allclose(float(v.detach()), float(ref["loss_values"][k]),
                                   rtol=1e-5, err_msg=k)


# ------------------------------------------------------------------ engine

def test_lfdv2_engine_rows_match_lfdtpu():
    hw, mean, std = (128, 128), (0.45, 0.5, 0.55), (0.25, 0.25, 0.3)
    # a limit of 100 truncates the 32x32 and 16x16 levels of a 128x128 input
    jv2, variables, tv2 = variant("WIDERFACE-S", JLFDv2, LFDv2, pre_nms_bbox_limit=100,
                                  distance_to_bbox_mode="sigmoid")
    assert max(tv2.level_sizes(hw)) > 100
    kw = dict(classification_threshold=0.01, batch_size=2)
    je = jax_compile(jv2, variables, hw, "fp32", preprocess=jax_preprocess(mean, std), **kw)
    te = compile_inference(tv2, hw, "fp32", preprocess=make_device_preprocess(mean, std),
                           device="cpu", **kw)
    assert te.spec.per_level_limit == 100
    imgs = np.random.RandomState(5).randint(0, 255, (2,) + hw + (3,)).astype(np.uint8)
    vhw = np.asarray([[128, 128], [100, 77]], np.float32)
    ref = {k: np.asarray(v) for k, v in je(jnp.asarray(imgs), jnp.asarray(vhw)).items()}
    got = {k: v.numpy() for k, v in te(imgs, vhw).items()}
    assert (got["count"] > 0).all()
    np.testing.assert_array_equal(got["count"], ref["count"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=1e-5, atol=1e-3)
