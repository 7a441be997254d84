# Device-side augmentation of the port (lfdtpu_torch/data/device_aug.py)
# against lfdtpu's (lfdtpu/data/device_aug.py) on the same seeded samples:
#   - host half (DeviceAugRegionSampler): the same boxes, labels, scale,
#     translation, flip and buffer EXACTLY, pre-shrunk windows included (the
#     port resizes them with data/resize.py where lfdtpu calls cv2; exact
#     but for a window shrunk exactly 2x, which these draws do not hit);
#   - the pre-shrink placement that raises in lfdtpu (ROADMAP F10);
#   - device half (DeviceAugment) against lfdtpu.data.make_device_augment on
#     the same batch within 1e-3 in pixel units (0-255), borders included
#     (ROADMAP F3), with flip and gray; the bf16 compute_dtype within one
#     uint8 step of float32.
# lfdtpu's device half runs eagerly here: under jax.jit XLA contracts its
# sample-coordinate arithmetic into FMAs, which moves its own output by up
# to ~0.02 at 960-pixel buffers (ROADMAP F3); eagerly it evaluates
# `jax/_src/image/scale.py:54-85` op by op, as the port does.
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lfdtpu.data as jdata
import lfdtpu_torch.data as tdata
from lfdtpu_torch.deploy import make_device_preprocess

torch.set_num_threads(1)

PIXEL_TOL = 1e-3  # device half, pixel units: float32 sums in another order
LSB = 1           # uint8 steps: bf16 compute against float32


def _scene(h, w, seed, gray=False):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w) if gray else (h, w, 3)).astype(np.uint8)
    return img


def _sample(img, boxes):
    return dict(image=img.copy(), bboxes=[list(b) for b in boxes],
                bbox_labels=list(range(len(boxes))))


def _host_pair(make, sample, seed, flip_p, buffer_size=None):
    random.seed(seed)
    a = jdata.DeviceAugRegionSampler(make(jdata), buffer_size=buffer_size,
                                     flip_p=flip_p)(dict(sample))
    random.seed(seed)
    b = tdata.DeviceAugRegionSampler(make(tdata), buffer_size=buffer_size,
                                     flip_p=flip_p)(dict(sample))
    return a, b


def _check_host(a, b):
    for k in ("aug_scale", "aug_translation", "aug_flip"):
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        assert np.array_equal(a[k], b[k]), k
    assert a.get("bboxes") == b.get("bboxes") and a.get("bbox_labels") == b.get("bbox_labels")
    assert a["image"].shape == b["image"].shape and b["image"].dtype == np.uint8
    assert np.array_equal(a["image"], b["image"])


@pytest.mark.parametrize("seed", range(6))
def test_host_half_matches_lfdtpu(seed):
    img = _scene(300, 420, seed, gray=seed % 3 == 2)
    boxes = [[30, 40, 60, 50], [200, 100, 80, 90], [350, 220, 40, 30]]
    make = lambda m: m.RandomBBoxCropRegionSampler(crop_size=160, resize_range=(0.6, 1.5))
    a, b = _host_pair(make, _sample(img, boxes), seed, flip_p=0.5)
    _check_host(a, b)


def _host_pairs_where_lfdtpu_runs(make, sample, seeds, flip_p=0.5):
    """(lfdtpu, port) host outputs for each seed, None for lfdtpu where its
    pre-shrink placement raises (F10)."""
    for seed in seeds:
        random.seed(seed)
        try:
            a = jdata.DeviceAugRegionSampler(make(jdata), flip_p=flip_p)(dict(sample))
        except ValueError:
            a = None
        random.seed(seed)
        yield a, tdata.DeviceAugRegionSampler(make(tdata), flip_p=flip_p)(dict(sample))


def test_host_half_matches_lfdtpu_on_pre_shrunk_windows():
    """tests/test_device_aug.py:95's case: a big box forced into a small
    range, so scale << 1 and the source window exceeds the buffer and is
    pre-shrunk before it is placed."""
    img = _scene(500, 500, 7)
    sample = _sample(img, [[50, 60, 380, 350]])
    make = lambda m: m.RandomBBoxCropWithRangeSelectionRegionSampler(
        crop_size=160, detection_ranges=((4, 16), (16, 64)), range_mode="longer")
    compared = 0
    for seed in range(12):
        random.seed(seed)
        pre_shrunk = 160 / make(tdata).draw(dict(sample))["scale"] + 10 > 320
        (a, b), = _host_pairs_where_lfdtpu_runs(make, sample, [seed])
        if a is not None and pre_shrunk:
            _check_host(a, b)
            compared += 1
    assert compared >= 4


def test_pre_shrink_placement_that_raises_in_lfdtpu():
    """ROADMAP F10: lfdtpu takes the pre-shrunk window's factor from its
    rounded placed size; for a small clipped patch the window's far end
    then lands past the buffer and its copy raises. The port drops those
    pixels and agrees with lfdtpu wherever lfdtpu runs."""
    make = lambda m: m.RandomBBoxCropRegionSampler(crop_size=48, resize_range=(0.5, 1.5),
                                                   resize_prob=0.7)
    sample = _sample(_scene(102, 110, 3), [[16, 30, 8, 18]])
    raised = 0
    for a, b in _host_pairs_where_lfdtpu_runs(make, sample, range(60)):
        assert b["image"].shape == (96, 96, 3)
        assert np.isfinite(b["aug_scale"]).all() and np.isfinite(b["aug_translation"]).all()
        if a is None:
            raised += 1
        else:
            _check_host(a, b)
    assert raised >= 1


def _batch(seed, B=6, S=64):
    rng = np.random.RandomState(seed)
    return dict(
        buffer=rng.randint(0, 256, (B, S, S, 3)).astype(np.uint8),
        # scales 0.4-2.5 and translations that put output pixels beyond both
        # borders: outside, within half a pixel of, and inside the buffer
        scale=rng.uniform(0.4, 2.5, (B, 2)).astype(np.float32),
        translation=rng.uniform(-1.5 * S, 0.5 * S, (B, 2)).astype(np.float32),
        flip=(np.arange(B) % 2).astype(np.float32))


def _jax(batch, crop, **kw):
    aug = jdata.make_device_augment(crop, **kw)
    return np.asarray(aug({k: jnp.asarray(v) for k, v in batch.items()}), np.float32)


def _port(batch, crop, **kw):
    aug = tdata.make_device_augment(crop, **kw)
    return aug({k: torch.as_tensor(v) for k, v in batch.items()}).float().numpy()


@pytest.mark.parametrize("seed", range(3))
def test_device_half_matches_lfdtpu_borders_included(seed):
    batch = _batch(seed)
    ref, got = _jax(batch, 40), _port(batch, 40)
    assert got.shape == ref.shape == (6, 40, 40, 3)
    assert np.abs(got - ref).max() <= PIXEL_TOL
    # the border rule is exercised: zeros outside, replicated edges inside
    zero = (ref == 0).all(-1)
    assert zero.any() and (~zero).any()
    assert np.array_equal(zero, (got == 0).all(-1))


def test_device_half_gray_flip_and_normalize():
    img = _scene(80, 80, 5, gray=True)
    random.seed(3)
    s = tdata.DeviceAugRegionSampler(
        tdata.RandomBBoxCropRegionSampler(crop_size=32, resize_range=(0.7, 1.3)), flip_p=1.0)
    out = s(_sample(img, [[20, 25, 20, 20]]))
    assert out["aug_flip"] == 1.0 and (out["image"][..., 0] == out["image"][..., 2]).all()
    batch = {"buffer": out["image"][None], "scale": out["aug_scale"][None],
             "translation": out["aug_translation"][None], "flip": out["aug_flip"][None]}
    from lfdtpu.deploy import make_device_preprocess as jax_preprocess

    ref = _jax(batch, 32, normalize=jax_preprocess((0.5,) * 3, (0.5,) * 3))
    got = _port(batch, 32, normalize=make_device_preprocess((0.5,) * 3, (0.5,) * 3))
    assert np.abs(got - ref).max() <= PIXEL_TOL / 127.5
    unflipped = _port(dict(batch, flip=np.zeros(1, np.float32)), 32)
    assert np.abs(_port(batch, 32) - unflipped[:, :, ::-1]).max() == 0


def test_bf16_compute_dtype_within_one_step_of_fp32():
    batch = _batch(4, S=96)
    f32 = _port(batch, 64)
    bf16 = _port(batch, 64, compute_dtype=torch.bfloat16)
    assert np.abs(bf16 - f32).max() <= LSB
    out = tdata.make_device_augment(64, compute_dtype=torch.bfloat16, out_dtype=torch.bfloat16)(
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert out.dtype == torch.bfloat16
