# Box geometry and LFD target assignment of the port against lfdtpu on the
# CPU, from seeded numpy inputs. Tolerance: exact for masks, labels and
# selections; 1e-6 absolute and relative for float targets (the same float32
# ops, which XLA may round in the last place differently).
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.ops import assign as jax_assign
from lfdtpu.ops import boxes as jax_boxes
from lfdtpu.ops import points as jax_points
from lfdtpu_torch.ops import assign, boxes

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
MODES = ("longer", "shorter", "sqrt", "dist")


def rand_xyxy(rng, shape, span=100.0):
    xy = rng.uniform(0, span, shape + (2,))
    wh = rng.uniform(0.5, span / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_conversions_match():
    rng = np.random.RandomState(0)
    b = rand_xyxy(rng, (3, 7))
    pts = rng.uniform(0, 100, (3, 7, 2)).astype(np.float32)
    dist = rng.uniform(0, 40, (3, 7, 4)).astype(np.float32)
    t = torch.from_numpy
    for inclusive in (True, False):
        np.testing.assert_array_equal(boxes.xywh_to_xyxy(t(b), inclusive).numpy(),
                                      np.asarray(jax_boxes.xywh_to_xyxy(b, inclusive)))
        np.testing.assert_array_equal(boxes.xyxy_to_xywh(t(b), inclusive).numpy(),
                                      np.asarray(jax_boxes.xyxy_to_xywh(b, inclusive)))
    # inclusive extents: a 1-pixel box spans x..x
    one = np.array([[5.0, 6.0, 1.0, 1.0]], np.float32)
    np.testing.assert_array_equal(boxes.xywh_to_xyxy(t(one)).numpy(), [[5, 6, 5, 6]])
    for max_shape in (None, (64, 80)):
        np.testing.assert_array_equal(
            boxes.distance2bbox(t(pts), t(dist), max_shape).numpy(),
            np.asarray(jax_boxes.distance2bbox(pts, dist, max_shape)))
    np.testing.assert_array_equal(boxes.bbox2distance(t(pts), t(b)).numpy(),
                                  np.asarray(jax_boxes.bbox2distance(pts, b)))


@pytest.mark.parametrize("mode", ["iou", "iof"])
@pytest.mark.parametrize("aligned", [True, False])
def test_bbox_overlaps_match(mode, aligned):
    rng = np.random.RandomState(1)
    b1 = rand_xyxy(rng, (2, 6))
    b2 = rand_xyxy(rng, (2, 6 if aligned else 5))
    b2[0, 0] = b1[0, 0]  # identical pair
    b2[1, 1] = [500, 500, 500, 500]  # zero-area box: union clamped at eps
    got = boxes.bbox_overlaps(torch.from_numpy(b1), torch.from_numpy(b2), mode, aligned)
    ref = jax_boxes.bbox_overlaps(b1, b2, mode, aligned)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------------------ assign

STRIDES = (4, 8, 16)
RANGES = ((0, 16), (16, 32), (32, 64))
HW = (64, 64)


def level_arrays():
    sizes = jax_points.feature_map_sizes_for_input(HW, STRIDES)
    gray = jax_points.compute_gray_ranges(RANGES, (0.9, 1.1))
    return jax_points.concat_level_info(sizes, STRIDES, RANGES, gray)


def run_both(gt, labels, mask, num_classes, mode, normalize):
    info = level_arrays()
    args = (info["points"], info["strides"], info["ranges"], info["gray_ranges"])

    def single(b, l, m):
        return jax_assign.lfd_assign(*args, b, l, m, num_classes,
                                     range_assign_mode=mode, normalize_by_range=normalize)

    jc, jr = jax.vmap(single)(jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(mask))
    tc, tr = assign.lfd_assign(*(torch.from_numpy(a) for a in args), torch.from_numpy(gt),
                               torch.from_numpy(labels), torch.from_numpy(mask),
                               num_classes, range_assign_mode=mode,
                               normalize_by_range=normalize)
    return (tc.numpy(), tr.numpy()), (np.asarray(jc), np.asarray(jr))


def random_gt(seed, B=3, N=8, C=3):
    rng = np.random.RandomState(seed)
    w, h = rng.uniform(2, 60, (2, B, N))
    x, y = rng.uniform(-4, 60, (2, B, N))
    gt = np.stack([x, y, w, h], -1).astype(np.float32)
    gt[0, 0] = [10, 12, 14, 17]  # integer box: points on its inclusive edges
    labels = rng.randint(0, C, (B, N)).astype(np.int32)
    mask = rng.rand(B, N) > 0.25
    mask[1] = False  # an empty image
    return gt, labels, mask


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_lfd_assign_matches_lfdtpu(mode, normalize):
    gt, labels, mask = random_gt(len(mode))
    (tc, tr), (jc, jr) = run_both(gt, labels, mask, 3, mode, normalize)
    assert tc.shape == jc.shape == (3, 16 * 16 + 8 * 8 + 4 * 4, 3)
    np.testing.assert_array_equal(tc < 0, jc < 0)  # gray entries
    np.testing.assert_allclose(tc, jc, **TOL)
    np.testing.assert_allclose(tr, jr, **TOL)
    assert (tc[1] == 0).all() and (tr[1] == 0).all()  # the empty image
    assert (tc > 0).any() and (tc < 0).any()


def test_assign_inclusive_extent_and_gray_override():
    # box (8, 8, 9, 9): inclusive right/bottom edge 16. The stride-4 point
    # (16, 16) lies on it and is a hit; a 8-wide box would end at 15.
    gt = np.zeros((1, 3, 4), np.float32)
    gt[0, 0] = [8, 8, 9, 9]
    labels = np.zeros((1, 3), np.int32)
    mask = np.array([[True, False, False]])
    (tc, tr), (jc, jr) = run_both(gt, labels, mask, 1, "longer", False)
    p = 4 * 16 + 4  # stride-4 level, row 4, col 4 -> point (16, 16)
    assert tc[0, p, 0] > 0 and jc[0, p, 0] > 0
    np.testing.assert_array_equal(tr[0, p], [8, 8, 0, 0])
    gt[0, 0] = [8, 8, 8, 8]
    (tc, _), _ = run_both(gt, labels, mask, 1, "longer", False)
    assert tc[0, p, 0] == 0
    # same class, one green (size 10 at level 0's (0, 16)) and one gray
    # (size 17 in level 0's gray band (16, 17]) over the same point: -1
    gt[0, 0] = [10, 10, 10, 10]
    gt[0, 1] = [8, 8, 17, 17]
    mask[0, 1] = True
    (tc, _), (jc, _) = run_both(gt, labels, mask, 1, "longer", False)
    p = 4 * 16 + 4
    assert tc[0, p, 0] == -1 and jc[0, p, 0] == -1


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_assign_tied_scores_take_the_first_gt(order):
    # two boxes with one center (20.5, 20.5), both of level 1's sqrt range
    # (16, 32): every point scores them the same, so the regression target
    # is the first one's, in both packages
    pair = np.array([[12, 12, 17, 17], [8, 8, 25, 25]], np.float32)
    gt = np.zeros((1, 2, 4), np.float32)
    gt[0] = pair[list(order)]
    labels = np.zeros((1, 2), np.int32)
    mask = np.ones((1, 2), bool)
    (tc, tr), (jc, jr) = run_both(gt, labels, mask, 1, "sqrt", False)
    np.testing.assert_allclose(tr, jr, **TOL)
    p = 16 * 16 + 2 * 8 + 2  # stride-8 point (16, 16)
    x, y, w, h = pair[order[0]]
    np.testing.assert_array_equal(tr[0, p], [16 - x, 16 - y, x + w - 1 - 16, y + h - 1 - 16])
    assert tc[0, p, 0] > 0


def test_assign_label_out_of_range_writes_no_class():
    gt, labels, mask = random_gt(5, C=2)
    labels[0, :] = 7  # outside [0, C): lfdtpu's one-hot row is all zeros
    (tc, tr), (jc, jr) = run_both(gt, labels, mask, 2, "dist", False)
    np.testing.assert_allclose(tc, jc, **TOL)
    np.testing.assert_allclose(tr, jr, **TOL)
    assert (tc[0] == 0).all()


def test_assign_batch_chunks_agree(monkeypatch):
    gt, labels, mask = random_gt(6, B=5)
    info = {k: torch.from_numpy(v) for k, v in level_arrays().items()}
    args = (info["points"], info["strides"], info["ranges"], info["gray_ranges"],
            torch.from_numpy(gt), torch.from_numpy(labels), torch.from_numpy(mask), 3)
    whole = assign.lfd_assign(*args)
    monkeypatch.setattr(assign, "_PAIR_BUDGET", 2 * 336 * 8)  # 2 images per chunk
    chunked = assign.lfd_assign(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


# ------------------------------------------------- lfd::lfd_assign and K6's walk

def level_tensors():
    info = level_arrays()
    return tuple(torch.from_numpy(info[k]) for k in ("points", "strides", "ranges", "gray_ranges"))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_assign_op_on_cpu_is_the_plain_version(mode, normalize):
    gt, labels, mask = random_gt(10 + len(mode))
    args = (*level_tensors(), *map(torch.from_numpy, (gt, labels, mask)), 3, mode, normalize)
    got = torch.ops.lfd.lfd_assign(*args)
    want = assign.lfd_assign_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.library.opcheck(torch.ops.lfd.lfd_assign.default, args)


def k6_walk(points, strides, rr, gr, gt, labels, mask, C, mode, normalize):
    """csrc/assign.cu's order in numpy float32, a point at a time: the real
    rows in index order; per class a running max of green scores from 0 that
    a gray hit sets to -1 for good; the regression row replaced only by a
    strictly greater green score. Its square root is torch's on the CPU,
    as the plain version's (MKL's there, which can land one ulp off the
    correctly rounded root that numpy, the card's ATen and K6 give)."""
    f = np.float32

    def sqrt(v):
        return torch.sqrt(torch.tensor([v])).numpy()[0]

    B, N = mask.shape
    cls = np.zeros((B, len(points), C), f)
    reg = np.zeros((B, len(points), 4), f)
    for b in range(B):
        rows = [n for n in range(N) if mask[b, n]]
        for p, (px, py) in enumerate(points):
            half, (lo, up), (glo, gup) = strides[p] / f(2), rr[p], gr[p]
            best, sel = f(0), None
            for n in rows:
                x, y, w, h = gt[b, n]
                d = (px - x, py - y, (x + w - f(1)) - px, (y + h - f(1)) - py)
                if min(d) < 0:
                    continue
                m = {"longer": max(w, h), "shorter": min(w, h), "sqrt": sqrt(w * h),
                     "dist": max(d)}[mode]
                label = labels[b, n] if 0 <= labels[b, n] < C else None
                if lo <= m <= up:
                    ax = max(abs(px - (x + w / f(2))) / half, f(1))
                    ay = max(abs(py - (y + h / f(2))) / half, f(1))
                    score = sqrt(f(1) / ax) * sqrt(f(1) / ay)
                    if label is not None and cls[b, p, label] >= 0:
                        cls[b, p, label] = max(cls[b, p, label], score)
                    if score > best:
                        best, sel = score, d
                elif glo <= m < lo or up < m <= gup:
                    if label is not None:
                        cls[b, p, label] = -1
            if sel is not None:
                reg[b, p] = sel
            if normalize:
                reg[b, p] /= up
    return cls, reg


def overlapping_gt(seed, C=3):
    """random_gt's boxes with ties and gray overlaps: row 8 repeats row 0
    (equal scores: the first row must win), rows 9 and 10 are row 2 widened
    by 5% and 15% around its centre, and labels outside [0, C)."""
    gt, labels, mask = random_gt(seed, N=11, C=C)
    gt[:, 8] = gt[:, 0]
    for k, s in ((9, 1.05), (10, 1.15)):
        gt[:, k, 2:] = gt[:, 2, 2:] * s
        gt[:, k, :2] = gt[:, 2, :2] - (gt[:, k, 2:] - gt[:, 2, 2:]) / 2
    labels[:, 8:] = labels[:, [0, 2, 2]]
    labels[2, 3], labels[2, 4] = C + 3, -1
    mask[:, 8:] = mask[:, [0, 2, 2]]
    return gt, labels, mask


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_k6_walk_equals_the_plain_version(mode, normalize):
    gt, labels, mask = overlapping_gt(20 + len(mode))
    info = level_arrays()
    levels = tuple(info[k] for k in ("points", "strides", "ranges", "gray_ranges"))
    want = assign.lfd_assign_plain(*map(torch.from_numpy, (*levels, gt, labels, mask)), 3,
                                   range_assign_mode=mode, normalize_by_range=normalize)
    got = k6_walk(*levels, gt, labels, mask, 3, mode, normalize)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert (got[0] < 0).any() and (got[0] > 0).any()
