# The port's numpy bilinear resize (lfdtpu_torch/data/resize.py) against
# OpenCV's cv2.resize(INTER_LINEAR), which lfdtpu's region samplers call:
# the same output size (cvRound, half to even, for a scale factor; the given
# size otherwise), and every pixel within 1 uint8 step, over up- and
# down-scales, gray and 3-channel images. Bit-exact except at an exact 2x
# downscale, where OpenCV takes its INTER_AREA path (see resize.py).
import cv2
import numpy as np
import pytest
import torch

from lfdtpu_torch.data.resize import resize_linear, scaled_size

torch.set_num_threads(1)

LSB_TOL = 1


def _image(rng, h, w, channels):
    shape = (h, w) if channels == 0 else (h, w, channels)
    return rng.randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("scale", [0.23, 0.5, 0.61, 0.75, 0.999, 1.0, 1.07, 1.25, 1.5, 2.0, 2.37])
def test_scale_matches_cv2(scale, channels):
    rng = np.random.RandomState(int(scale * 1000) + channels)
    for h, w in ((37, 53), (120, 97), (255, 300)):
        img = _image(rng, h, w, channels)
        ref = cv2.resize(img, (0, 0), fx=scale, fy=scale)
        got = resize_linear(img, scale)
        assert got.shape == ref.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= LSB_TOL, (h, w, scale, diff.max())
        if scale != 0.5:
            assert diff.max() == 0, (h, w, scale)


def test_sizes_ending_in_half_round_to_even():
    """dim * s = k + 0.5 exactly: cvRound rounds to the even neighbour
    (11 * 0.5 = 5.5 -> 6, 13 * 0.5 = 6.5 -> 6, 5 * 1.5 = 7.5 -> 8)."""
    rng = np.random.RandomState(1)
    for (h, w), s in (((11, 13), 0.5), ((5, 9), 1.5), ((21, 7), 0.5), ((9, 3), 2.5)):
        img = _image(rng, h, w, 3)
        ref = cv2.resize(img, (0, 0), fx=s, fy=s)
        got = resize_linear(img, s)
        assert got.shape == ref.shape == (scaled_size(h, s), scaled_size(w, s), 3)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= LSB_TOL
    assert (scaled_size(11, 0.5), scaled_size(13, 0.5), scaled_size(5, 1.5)) == (6, 6, 8)


@pytest.mark.parametrize("channels", [0, 3])
def test_explicit_size_matches_cv2(channels):
    rng = np.random.RandomState(2)
    for (h, w), (ow, oh) in (((40, 60), (17, 23)), ((64, 64), (200, 150)),
                             ((99, 31), (31, 99)), ((10, 10), (1, 1))):
        img = _image(rng, h, w, channels)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        got = resize_linear(img, size=(ow, oh))
        assert got.shape == ref.shape
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= LSB_TOL


def test_rejects_what_it_cannot_resize():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError):
        resize_linear(img, 0.01)  # empty output
    with pytest.raises(ValueError):
        resize_linear(img)  # neither scale nor size
    with pytest.raises(TypeError):
        resize_linear(img.astype(np.float32), 0.5)
