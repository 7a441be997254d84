# Device-side training augmentation, the port of `lfdtpu/data/device_aug.py`:
# the reference's random crop/resize augmentation (`lfd/data_pipeline/
# data_loader/data_loader.py:48-85` + `sampler/region_sampler.py:75-144`)
# split so that the host only draws and windows, and the device resamples.
#
#   host   : decode, DRAW the exact reference augmentation parameters (scale,
#            crop offsets, flip) via the region samplers' draw() methods,
#            clip the boxes with the SAME _clip_boxes code path, and copy
#            the raw uint8 SOURCE WINDOW of the crop into a fixed-size
#            buffer. No resize of the full image, no float conversion, no
#            image flip. (A copy of lfdtpu's host half, with data/resize.py
#            for the window pre-shrink.)
#   device : DeviceAugment, an nn.Module the train step runs as its
#            `preprocess`: the bilinear resample of
#            `jax.image.scale_and_translate(method="linear",
#            antialias=False)`, the flip under the drawn flag, the clip to
#            [0, 255] and the normalize.
#
# Contract between the two halves: the device output pixel o equals the
# buffer sampled at  b = (o + 0.5 - translation) / scale - 0.5  (half-pixel
# centers, bilinear, no antialiasing). The host picks (scale, translation)
# so that this reproduces "resize(image, fx=s) then crop at (crop_x,
# crop_y)":
#     resized coord r = crop_x + o ; source coord  c = (r + 0.5)/s - 0.5
# and the buffer holds source pixels starting at src_x0, optionally
# pre-shrunk by f (<=1) when the source window exceeds the buffer:
#     b = (c - src_x0 + 0.5) * f - 0.5
# which is linear in o:  b = o * (f/s) + k  ->  scale = s/f,
# translation = 0.5 - (k + 0.5) * s/f  (computed per axis below).
#
# The box math is bit-identical to the host path by construction (same
# draw() random stream, same _clip_boxes); only the image resampling differs
# from the host path's fixed-point resize, by about one uint8 step.

from __future__ import annotations

import math
import random

import numpy as np
import torch
from torch import nn

from .region_samplers import _clip_boxes
from .resize import resize_linear

__all__ = ["DeviceAugRegionSampler", "DeviceAugment", "make_device_augment", "AUG_KEYS"]

# batch keys the loader ships alongside the image buffer
AUG_KEYS = ("aug_scale", "aug_translation", "aug_flip")


class DeviceAugRegionSampler:
    """Host half: wraps a crop region sampler that exposes draw()
    (RandomBBoxCropRegionSampler / RandomBBoxCropWithRangeSelection...)
    and emits, per sample:

      image            (buffer_size, buffer_size, 3) uint8 — raw source
                       window of the crop (zero outside the image)
      aug_scale        (2,) f32 — device scale_and_translate scale (y, x)
      aug_translation  (2,) f32 — device translation (y, x)
      aug_flip         f32 — 1.0 if the device should mirror the crop
      bboxes/bbox_labels — already in OUTPUT-crop coords, flip applied
                       (exact reference math; boxes are cheap on host)

    buffer_size: source-window capacity. A window of crop_size/s + margin
    fits raw for s >= ~crop_size/buffer_size; smaller scales (the
    range-selection sampler shrinking large boxes) pre-shrink the window
    (data/resize.py) ON THE WINDOW ONLY — still far less host work than the
    reference's full-image resize.
    """

    def __init__(self, region_sampler, buffer_size=None, flip_p=0.5, margin=4):
        draw = getattr(region_sampler, "draw", None)
        if draw is None:
            raise TypeError(
                f"{type(region_sampler).__name__} does not expose draw(); "
                "DeviceAugRegionSampler needs a RandomBBoxCrop-style sampler"
            )
        self._inner = region_sampler
        self._crop = int(region_sampler._crop_size)
        self._buffer = int(buffer_size or 2 * self._crop)
        assert self._buffer >= self._crop, (self._buffer, self._crop)
        self._flip_p = flip_p
        self._margin = int(margin)

    @property
    def crop_size(self):
        return self._crop

    @property
    def buffer_size(self):
        return self._buffer

    def _window(self, image, scale, crop_lo, axis):
        """One axis: choose the source window [src0, src1), fill factor f,
        and the device (scale, translation) reproducing resize+crop."""
        size = image.shape[axis]
        crop = self._crop
        # source coords touched by output pixels 0..crop-1 (bilinear taps
        # reach +-1 source px around the half-pixel-center map)
        c_lo = (crop_lo + 0.5) / scale - 0.5
        c_hi = (crop_lo + crop - 1 + 0.5) / scale - 0.5
        src0 = math.floor(c_lo) - self._margin
        src1 = math.ceil(c_hi) + self._margin + 1
        span = src1 - src0
        if span <= self._buffer:
            f = 1.0
        else:
            f = self._buffer / span
        return src0, src1, f

    def __call__(self, sample):
        assert "image" in sample
        image = sample["image"]
        if image.ndim == 2:  # gray -> 3ch before windowing (loader does
            image = np.repeat(image[..., None], 3, axis=-1)  # this later,
            # but the buffer copy needs the channel dim now)
        p = self._inner.draw(sample)
        crop = self._crop
        flip = random.random() < self._flip_p if self._flip_p > 0 else False

        # a resize by s keeps the GIVEN s as the sampling ratio (it only
        # rounds the output SIZE, without recomputing the ratio from it —
        # unlike a resize to an explicit size), so the device maps with
        # the drawn scale directly
        s_y = s_x = p["scale"]

        buf = np.zeros((self._buffer, self._buffer, 3), np.uint8)
        scale_yx = np.empty((2,), np.float32)
        trans_yx = np.empty((2,), np.float32)
        wins = []
        for axis, crop_lo, s in ((0, p["crop_y"], s_y), (1, p["crop_x"], s_x)):
            src0, src1, f = self._window(image, s, crop_lo, axis)
            wins.append((src0, src1, f))
        (sy0, sy1, fy), (sx0, sx1, fx) = wins
        # clip the window to the image; remember the in-buffer offset of
        # the clipped data so zero padding lands where the reference's
        # crop_from_image zero pad does
        iy0, iy1 = max(0, sy0), min(image.shape[0], sy1)
        ix0, ix1 = max(0, sx0), min(image.shape[1], sx1)
        patch = image[iy0:iy1, ix0:ix1]
        if patch.size:
            if fy < 1.0 or fx < 1.0:
                # pre-shrink ONLY the window (never the whole image);
                # rounding the placed size keeps the effective f exact
                ph = max(1, int(round(patch.shape[0] * fy)))
                pw = max(1, int(round(patch.shape[1] * fx)))
                fy2 = ph / patch.shape[0] if patch.shape[0] else 1.0
                fx2 = pw / patch.shape[1] if patch.shape[1] else 1.0
                patch = resize_linear(patch, size=(pw, ph))
                oy = int(round((iy0 - sy0) * fy2))
                ox = int(round((ix0 - sx0) * fx2))
                fy, fx = fy2, fx2
                # the placed size is rounded, and its ratio sets the whole
                # window's factor: for a small clipped patch that can carry
                # the window's far end a few pixels past the buffer, where
                # lfdtpu raises (ROADMAP F10). Those pixels are dropped; an
                # output pixel that samples there reads the rule's zero.
                patch = patch[:self._buffer - oy, :self._buffer - ox]
            else:
                oy, ox = iy0 - sy0, ix0 - sx0
            buf[oy:oy + patch.shape[0], ox:ox + patch.shape[1]] = patch
        for i, (crop_lo, s, src0, f) in enumerate(
                ((p["crop_y"], s_y, sy0, fy), (p["crop_x"], s_x, sx0, fx))):
            # target buffer coord per output pixel o:
            #   b(o) = ((crop_lo + o + 0.5)/s - 0.5 - src0 + 0.5)*f - 0.5
            #        = o*(f/s) + k
            # scale_and_translate samples b = (o + 0.5 - t)/scale - 0.5,
            # so scale = s/f and t = 0.5 - (k + 0.5)*(s/f)
            k = ((crop_lo + 0.5) / s - src0) * f - 0.5
            scale_yx[i] = s / f
            trans_yx[i] = 0.5 - (k + 0.5) * (s / f)

        boxes, labels = _clip_boxes(
            p["scaled_bboxes"], p["labels"], p["crop_x"], p["crop_y"], crop
        )
        if flip and boxes:
            boxes = [[crop - b[0] - b[2], b[1], b[2], b[3]] for b in boxes]
        sample["image"] = buf
        sample["aug_scale"] = scale_yx
        sample["aug_translation"] = trans_yx
        sample["aug_flip"] = np.float32(1.0 if flip else 0.0)
        if boxes:
            sample["bboxes"] = boxes
            sample["bbox_labels"] = labels
        else:
            sample.pop("bboxes", None)
            sample.pop("bbox_labels", None)
        return sample


def _taps(size_in, n_out, scale, translation):
    """The two source taps and weights per output index of
    jax.image.scale_and_translate's linear weights
    (`jax/_src/image/scale.py:54-85`), for a batch of (scale, translation)
    of shape (B,) each, float32. JAX's dense (size_in, n_out) weight matrix
    has at most two nonzero entries per output, at floor(f) and floor(f)+1:
    the triangle kernel, normalized by its sum where that exceeds
    1000 * eps (so within half a pixel of the border the edge pixel is
    replicated), and zero where f lies outside [-0.5, size_in - 0.5].
    Returns (i0, i1) int64 in range and (w0, w1) float32, each (B, n_out)."""
    inv = 1.0 / scale[:, None]
    o = torch.arange(n_out, device=scale.device, dtype=torch.float32)
    f = (o + 0.5) * inv - translation[:, None] * inv - 0.5
    i0 = torch.floor(f)
    w1 = f - i0
    w0 = 1.0 - w1
    i0 = i0.long()
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < size_in), w0, 0.0)
    w1 = torch.where((i1 >= 0) & (i1 < size_in), w1, 0.0)
    total = w0 + w1
    keep = ((total.abs() > 1000.0 * torch.finfo(torch.float32).eps)
            & (f >= -0.5) & (f <= size_in - 0.5))
    total = torch.where(keep, total, 1.0)
    w0 = torch.where(keep, w0 / total, 0.0)
    w1 = torch.where(keep, w1 / total, 0.0)
    return i0.clamp(0, size_in - 1), i1.clamp(0, size_in - 1), w0, w1


class DeviceAugment(nn.Module):
    """Device half: the `preprocess` of make_train_step for device-aug
    batches.

    Takes the loader batch's images as a dict
      {"buffer": (B, S, S, 3) uint8, "scale": (B, 2) f32,
       "translation": (B, 2) f32, "flip": (B,) f32}
    ((y, x) order) and returns the augmented (B, crop, crop, 3) batch:
    resample (two separable 2-tap passes, rows then columns), mirror where
    flip > 0.5, clip to [0, 255], then `normalize` (a module such as
    deploy.make_device_preprocess, or None) and the cast to `out_dtype`.

    compute_dtype: the pixel dtype of the resample (default float32).
    bfloat16 halves its memory traffic: the buffer converts exactly (uint8
    fits in bf16's 8-bit significand), each pass accumulates in float32 and
    rounds once to bf16, so the result stays within one uint8 step of
    float32. The sampling coordinates and weights stay float32 in either
    case: bf16 coordinates would cost whole pixels of phase error at 480 px.
    """

    def __init__(self, crop_size, normalize=None, out_dtype=None, compute_dtype=None):
        super().__init__()
        self.crop = int(crop_size)
        self.normalize = normalize
        self.out_dtype = out_dtype
        self.compute_dtype = compute_dtype or torch.float32

    def forward(self, batch):
        buf = batch["buffer"]
        scale = batch["scale"].float()
        trans = batch["translation"].float()
        B, S_h, S_w, C = buf.shape
        crop = self.crop
        y0, y1, wy0, wy1 = _taps(S_h, crop, scale[:, 0], trans[:, 0])
        x0, x1, wx0, wx1 = _taps(S_w, crop, scale[:, 1], trans[:, 1])
        x = buf.to(self.compute_dtype)
        rows = lambda i: torch.gather(x, 1, i[:, :, None, None].expand(B, crop, S_w, C))
        x = (rows(y0) * wy0[:, :, None, None]
             + rows(y1) * wy1[:, :, None, None]).to(self.compute_dtype)
        cols = lambda i: torch.gather(x, 2, i[:, None, :, None].expand(B, crop, crop, C))
        out = (cols(x0) * wx0[:, None, :, None]
               + cols(x1) * wx1[:, None, :, None]).to(self.compute_dtype)
        flip = batch["flip"].reshape(-1, 1, 1, 1) > 0.5
        out = torch.where(flip, out.flip(2), out)
        out = out.clamp(0.0, 255.0)
        if self.normalize is not None:
            out = self.normalize(out)
        if self.out_dtype is not None:
            out = out.to(self.out_dtype)
        return out


def make_device_augment(crop_size, normalize=None, out_dtype=None, compute_dtype=None):
    """lfdtpu's factory name for DeviceAugment."""
    return DeviceAugment(crop_size, normalize, out_dtype, compute_dtype)
