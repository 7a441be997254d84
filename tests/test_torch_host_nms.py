# The port's host NMS API (lfdtpu_torch/ops/nms.py: nms, soft_nms, nms_match)
# and multiclass_nms against lfdtpu's (lfdtpu/ops/nms.py) on the CPU: seeded
# dets with tied scores, empty input and a zero-area box; the two reference
# doctests of tests/test_nms.py; multiclass_nms against multiclass_nms_jax
# (keep, the order over the survivors, count) with invalid rows, boxes offset
# by class and max_num clipping. The host API is exact; multiclass_nms's keep
# and count are exact and its order over the survivors too (the same tie
# order, F2).
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lfdtpu.ops.nms  # noqa: F401  (the package attribute `nms` is a function)
import lfdtpu_torch.ops as tops
from lfdtpu_torch.ops.nms import multiclass_nms, nms, nms_match, soft_nms

torch.set_num_threads(1)

JN = sys.modules["lfdtpu.ops.nms"]

REF_DETS = np.array(  # the reference doctest vectors (lfd/model/utils/nms.py:25-34)
    [[49.1, 32.4, 51.0, 35.9, 0.9], [49.3, 32.9, 51.0, 35.3, 0.9],
     [49.2, 31.8, 51.0, 35.4, 0.5], [35.1, 11.5, 39.1, 15.7, 0.5],
     [35.6, 11.8, 39.3, 14.2, 0.5], [35.3, 11.5, 39.9, 14.5, 0.4],
     [35.2, 11.7, 39.7, 15.7, 0.3]], dtype=np.float32)
SOFT_DETS = np.array(  # tests/test_nms.py:85's soft-NMS doctest
    [[4.0, 3.0, 5.0, 3.0, 0.9], [4.0, 3.0, 5.0, 4.0, 0.9], [3.0, 1.0, 3.0, 1.0, 0.5],
     [3.0, 1.0, 3.0, 1.0, 0.5], [3.0, 1.0, 3.0, 1.0, 0.4], [3.0, 1.0, 3.0, 1.0, 0.0]],
    dtype=np.float32)


def seeded_dets(seed, k=60):
    """Clustered boxes (so that IoUs cross the thresholds) with scores tied
    in fifths, one zero-area box and one exact duplicate."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(6, 2) * 80
    xy = centers[rng.randint(0, 6, k)] + rng.randn(k, 2) * 4
    wh = rng.rand(k, 2) * 20 + 4
    dets = np.concatenate([xy, xy + wh, rng.randint(1, 6, (k, 1)) / 5.0], 1).astype(np.float32)
    dets[3, 2:4] = dets[3, 0:2]  # zero area
    dets[7] = dets[5]  # a duplicate, tied score
    return dets


CASES = {
    "seeded 0": seeded_dets(0),
    "seeded 1": seeded_dets(1),
    "reference doctest": REF_DETS,
    "soft doctest": SOFT_DETS,
    "empty": np.zeros((0, 5), np.float32),
}


@pytest.mark.parametrize("iou_thr", [0.3, 0.6])
@pytest.mark.parametrize("case", CASES)
def test_nms_matches_lfdtpu(case, iou_thr):
    kept, inds = nms(CASES[case], iou_thr)
    jkept, jinds = JN.nms(CASES[case], iou_thr)
    assert inds.dtype == np.int64 and kept.shape == jkept.shape
    np.testing.assert_array_equal(inds, jinds)
    np.testing.assert_array_equal(kept, jkept)


@pytest.mark.parametrize("method,sigma", [("linear", 0.5), ("gaussian", 0.5), ("gaussian", 0.1)])
@pytest.mark.parametrize("case", CASES)
def test_soft_nms_matches_lfdtpu(case, method, sigma):
    dets, inds = soft_nms(CASES[case], 0.3, method=method, sigma=sigma, min_score=1e-3)
    jdets, jinds = JN.soft_nms(CASES[case], 0.3, method=method, sigma=sigma, min_score=1e-3)
    np.testing.assert_array_equal(inds, jinds)
    assert dets.shape == jdets.shape and dets.dtype == jdets.dtype
    np.testing.assert_array_equal(dets, jdets)


def test_soft_nms_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="linear"):
        soft_nms(REF_DETS, 0.3, method="hard")


@pytest.mark.parametrize("iou_thr", [0.3, 0.6])
@pytest.mark.parametrize("case", CASES)
def test_nms_match_matches_lfdtpu(case, iou_thr):
    groups = nms_match(CASES[case], iou_thr)
    assert groups == JN.nms_match(CASES[case], iou_thr)
    # every row in exactly one group, each group led by an nms survivor
    assert sorted(i for g in groups for i in g) == list(range(len(CASES[case])))
    assert sorted(g[0] for g in groups) == sorted(nms(CASES[case], iou_thr)[1].tolist())


def test_reference_doctests():
    """tests/test_nms.py:26 and :85 as cases of the port."""
    kept, inds = nms(REF_DETS, 0.6)
    assert len(inds) == len(kept) == 3
    new_dets, inds = soft_nms(SOFT_DETS, 0.6, sigma=0.5)
    assert len(inds) == len(new_dets) == 5


def test_the_package_exports_lfdtpus_names():
    assert (tops.nms, tops.soft_nms, tops.nms_match, tops.multiclass_nms) == \
        (nms, soft_nms, nms_match, multiclass_nms)


def candidates(seed, k=80, classes=3):
    """Seeded candidates offset by class (as batched_nms does), with scores
    tied in tenths, invalid rows and scores under the threshold."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(k, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(k, 2) * 30 + 2], 1).astype(np.float32)
    labels = rng.randint(0, classes, k)
    boxes += (labels * (boxes.max() + 1.0))[:, None].astype(np.float32)
    scores = (rng.randint(0, 11, k) / 10.0).astype(np.float32)
    valid = rng.rand(k) > 0.15
    return boxes, scores, valid


@pytest.mark.parametrize("max_num", [5, 20, 100])
@pytest.mark.parametrize("seed,iou_thr,with_valid", [(0, 0.5, True), (1, 0.3, True),
                                                     (2, 0.5, False)])
def test_multiclass_nms_matches_lfdtpu(seed, iou_thr, with_valid, max_num):
    boxes, scores, valid = candidates(seed)
    jkeep, jorder, jcount = JN.multiclass_nms_jax(
        jnp.asarray(boxes), jnp.asarray(scores), score_thr=0.05, iou_thr=iou_thr,
        max_num=max_num, valid=jnp.asarray(valid) if with_valid else None)
    keep, order, count = multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.05, iou_thr, max_num=max_num,
        valid=torch.from_numpy(valid) if with_valid else None)
    jkeep, jorder, jcount = np.asarray(jkeep), np.asarray(jorder), int(jcount)
    assert keep.dtype == torch.bool and count.dtype == torch.int32
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert int(count) == jcount
    survivors = int(np.asarray(JN.nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), iou_thr,
        valid=jnp.asarray((valid if with_valid else True) & (scores > 0.05)))).sum())
    np.testing.assert_array_equal(order.numpy()[:survivors], jorder[:survivors])
    assert jcount == min(survivors, max_num)
    if max_num < survivors:  # the clip dropped ranks from keep
        assert keep.sum() == max_num


def test_multiclass_nms_batched_and_the_plain_path_agree():
    """A (B, K) batch gives each image's single-image result, through K1's
    op and through its plain version (use_kernel=False)."""
    cands = [candidates(s) for s in (3, 4)]
    boxes, scores, valid = (torch.from_numpy(np.stack(a)) for a in zip(*cands))
    for use_kernel in (True, False):
        keep, order, count = multiclass_nms(boxes, scores, 0.05, 0.5, max_num=20, valid=valid,
                                            use_kernel=use_kernel)
        for b in range(2):
            k1, o1, c1 = multiclass_nms(boxes[b], scores[b], 0.05, 0.5, max_num=20,
                                        valid=valid[b])
            assert torch.equal(keep[b], k1) and torch.equal(order[b], o1)
            assert int(count[b]) == int(c1)
