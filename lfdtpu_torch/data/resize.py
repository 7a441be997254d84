# Bilinear resize of uint8 images in numpy, in place of OpenCV's
# `cv2.resize(..., interpolation=cv2.INTER_LINEAR)`, which lfdtpu's region
# samplers (`lfdtpu/data/region_samplers.py:118,173,256`) and device-aug
# window pre-shrink (`lfdtpu/data/device_aug.py:154`) call.
#
# OpenCV's rules, reproduced here:
#   - with a scale factor s the output size is cvRound(dim * s) (round half
#     to even) and the sampling ratio is 1/s, not recomputed from the rounded
#     size; with an explicit size the ratio is 1 / (out / in);
#   - half-pixel centres: source coordinate f = (d + 0.5) * ratio - 0.5, in
#     float32, split into floor(f) and the fraction;
#   - the same output size as the input: a copy, whatever the ratio;
#   - edge replication: f < 0 takes pixel 0, f >= size - 1 the last pixel;
#   - 11-bit fixed-point weights (rint(w * 2048)), an exact integer
#     horizontal pass, and the vectorized vertical pass's rounding:
#     ((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16), then (v + 2) >> 2.
#     This matches OpenCV 5.0 bit for bit, except at an exact 2x downscale,
#     where OpenCV switches to INTER_AREA: its odd-size edge rows and
#     columns (and any column its SIMD loop leaves to scalar code) round
#     half to even there, so they may differ by 1.
#
# numpy only: the shared-memory loader forks its workers, and a torch CPU op
# in a forked child can hang on an OpenMP pool its parent started.

from __future__ import annotations

import numpy as np

__all__ = ["resize_linear", "scaled_size"]

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def scaled_size(dim, scale):
    """cvRound(dim * scale): the output size of a resize by `scale`."""
    return int(round(dim * scale))


def _taps(n_out, n_in, ratio, clamp_weights):
    """Per output index: the two source indices and their fixed-point
    weights, as OpenCV's INTER_LINEAR tables. Horizontally OpenCV moves a
    tap beyond the edge onto the edge pixel with weight 0
    (clamp_weights=True); vertically it keeps the weights and clips the two
    row indices, so an edge row is blended with itself."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * ratio - 0.5).astype(np.float32)
    i0 = np.floor(f)
    frac = f - i0
    i0 = i0.astype(np.int64)
    if clamp_weights:
        low = i0 < 0
        high = i0 >= n_in - 1
        frac[low | high] = 0.0
        i0[low] = 0
        i0[high] = n_in - 1
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    i0 = np.clip(i0, 0, n_in - 1)
    w0 = np.rint((np.float32(1.0) - frac) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(frac * np.float32(_COEF_SCALE)).astype(np.int32)
    return i0, i1, w0, w1


def resize_linear(image, scale=None, size=None):
    """Resize a uint8 (H, W) or (H, W, C) image bilinearly.

    scale: one factor for both axes (cv2.resize(image, (0, 0), fx=scale,
      fy=scale)); or size: the output (width, height), as cv2's dsize.
    Returns a new uint8 array."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8 images, got {image.dtype}")
    h, w = image.shape[:2]
    if (scale is None) == (size is None):
        raise ValueError("give exactly one of scale and size")
    if size is not None:
        ow, oh = int(size[0]), int(size[1])
        ratio_x, ratio_y = 1.0 / (ow / w), 1.0 / (oh / h)
    else:
        ow, oh = scaled_size(w, scale), scaled_size(h, scale)
        ratio_x = ratio_y = 1.0 / scale
    if ow <= 0 or oh <= 0:
        raise ValueError(f"resize of a {h}x{w} image to {oh}x{ow} is empty")
    if (ow, oh) == (w, h):  # OpenCV copies whatever the ratio
        return image.copy()
    x0, x1, a0, a1 = _taps(ow, w, ratio_x, clamp_weights=True)
    y0, y1, b0, b1 = _taps(oh, h, ratio_y, clamp_weights=False)
    # horizontal pass over the source rows the output needs, exact in int32
    rows = np.unique(np.concatenate([y0, y1]))
    src = image[rows].astype(np.int32)
    shape = (1, ow) + (1,) * (image.ndim - 2)
    hor = src[:, x0] * a0.reshape(shape) + src[:, x1] * a1.reshape(shape)
    hor >>= 4
    r0 = hor[np.searchsorted(rows, y0)]
    r1 = hor[np.searchsorted(rows, y1)]
    shape = (oh,) + (1,) * (image.ndim - 1)
    v = ((r0 * b0.reshape(shape)) >> 16) + ((r1 * b1.reshape(shape)) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
