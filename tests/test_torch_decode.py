# The port's decode (top-k -> distance decode -> class-offset NMS -> top
# max_det) against lfdtpu's decode_predictions on identical logits: the
# same rows (count, labels, scores bit for bit) in the same order, including
# exact score ties (lax.top_k breaks ties by ascending index; the port uses
# a stable descending sort). Box corners may differ by a few float32 ulps:
# XLA's and PyTorch's exp/sigmoid round differently (about one value in ten
# for exp), so boxes are held to atol 1e-4 px. For the same reason the
# softmax head is tested without ties: an ulp of exp breaks a tie there.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.ops.decode import DecodeSpec as JSpec
from lfdtpu.ops.decode import decode_predictions as jax_decode
from lfdtpu.ops.decode import detections_to_lists as jax_lists
from lfdtpu.ops.points import concat_level_info, feature_map_sizes_for_input
from lfdtpu_torch.ops.decode import DecodeSpec, decode_predictions, detections_to_lists

torch.set_num_threads(1)

STRIDES = (8, 16, 32)
RANGES = ((0, 32), (32, 64), (64, 128))


def _setup(seed, hw, C, softmax, ties):
    info = concat_level_info(feature_map_sizes_for_input(hw, STRIDES), STRIDES, RANGES)
    P = info["points"].shape[0]
    rng = np.random.RandomState(seed)
    Cc = C + 1 if softmax else C
    if ties:
        # few distinct logit values: many exactly tied scores at every stage
        cls = rng.randint(-3, 3, (2, P, Cc)).astype(np.float32)
    else:
        cls = (rng.randn(2, P, Cc) * 2).astype(np.float32)
    reg = rng.randn(2, P, 4).astype(np.float32)
    valid_hw = np.asarray([[hw[0], hw[1]], [hw[0] - 20, hw[1] - 37]], np.float32)
    return info, cls, reg, valid_hw


def _both(info, cls, reg, valid_hw, **spec_kw):
    jspec = JSpec(**spec_kw)
    tspec = DecodeSpec(**spec_kw)
    pts, rngs = info["points"], info["ranges"]
    pv = (pts[None, :, 0] < valid_hw[:, 1:2]) & (pts[None, :, 1] < valid_hw[:, 0:1])
    ref = [jax_decode(jnp.asarray(cls[b]), jnp.asarray(reg[b]), jnp.asarray(pts),
                      jnp.asarray(rngs), jspec, (valid_hw[b, 0], valid_hw[b, 1]),
                      point_valid=jnp.asarray(pv[b]))
           for b in range(cls.shape[0])]
    got = decode_predictions(torch.from_numpy(cls), torch.from_numpy(reg),
                             torch.from_numpy(pts), torch.from_numpy(rngs), tspec,
                             torch.from_numpy(valid_hw),
                             point_valid=torch.from_numpy(pv))
    return ref, got


@pytest.mark.parametrize("case,ties", [
    (dict(C=1, softmax=False, reg_mode="sigmoid"), False),
    (dict(C=1, softmax=False, reg_mode="sigmoid"), True),
    (dict(C=3, softmax=False, reg_mode="exp"), False),
    (dict(C=3, softmax=False, reg_mode="exp"), True),
    (dict(C=4, softmax=True, reg_mode="sigmoid"), False),
])
def test_decode_rows_match_lfdtpu(case, ties):
    info, cls, reg, valid_hw = _setup(7, (96, 128), case["C"], case["softmax"], ties)
    ref, got = _both(info, cls, reg, valid_hw, num_classes=case["C"],
                     use_softmax=case["softmax"], reg_mode=case["reg_mode"],
                     score_thr=0.05, nms_iou=0.4, pre_nms_points=120,
                     nms_budget=150, max_det=60)
    for b, r in enumerate(ref):
        n = int(r["count"])
        assert int(got["count"][b]) == n and n > 0
        np.testing.assert_array_equal(got["labels"][b].numpy(), np.asarray(r["labels"]))
        np.testing.assert_array_equal(got["scores"][b].numpy(), np.asarray(r["scores"]))
        np.testing.assert_allclose(got["boxes"][b].numpy(), np.asarray(r["boxes"]),
                                   rtol=0, atol=1e-4)
        rows = detections_to_lists({k: v[b] for k, v in got.items()})
        np.testing.assert_allclose(np.asarray(rows), np.asarray(jax_lists(r)),
                                   rtol=0, atol=1e-4)


def test_decode_pads_when_budget_is_below_max_det():
    info, cls, reg, valid_hw = _setup(3, (64, 64), 1, False, False)
    ref, got = _both(info, cls, reg, valid_hw, num_classes=1, reg_mode="sigmoid",
                     pre_nms_points=20, nms_budget=20, max_det=50)
    assert got["boxes"].shape == (2, 50, 4)
    for b, r in enumerate(ref):
        assert int(got["count"][b]) == int(r["count"])
        np.testing.assert_array_equal(got["scores"][b].numpy(), np.asarray(r["scores"]))


@pytest.mark.parametrize("near", [0.0, 1e-3])
def test_softmax_45_classes_with_tied_and_near_tied_rows(near):
    # TT100K's head: 45 classes + background. Whole rows repeated (exact ties
    # in each package, broken by ascending index in both) or repeated with a
    # small shift of the winning logit (near ties). The softmax sums 46 exps
    # in another order than XLA: scores within rtol 1e-6, the order and the
    # labels the same.
    info, cls, reg, valid_hw = _setup(11, (96, 128), 45, True, False)
    cls[:, 1::3] = cls[:, 0::3][:, :cls[:, 1::3].shape[1]]
    cls[:, 1::3, 7] += near
    jspec = dict(num_classes=45, use_softmax=True, reg_mode="sigmoid", score_thr=0.02,
                 nms_iou=0.5, pre_nms_points=200, nms_budget=300, max_det=100)
    ref, got = _both(info, cls, reg, valid_hw, **jspec)
    for b, r in enumerate(ref):
        n = int(r["count"])
        assert int(got["count"][b]) == n and n > 0
        np.testing.assert_array_equal(got["labels"][b].numpy(), np.asarray(r["labels"]))
        np.testing.assert_allclose(got["scores"][b].numpy(), np.asarray(r["scores"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["boxes"][b].numpy(), np.asarray(r["boxes"]),
                                   rtol=0, atol=1e-4)
