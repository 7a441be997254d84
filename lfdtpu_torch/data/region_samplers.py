# Region samplers, a copy of `lfdtpu/data/region_samplers.py` (reference
# `lfd/data_pipeline/sampler/region_sampler.py`) with `data/resize.py` in
# place of cv2.resize: the same `random` draws in the same order and the same
# box math, so a seed gives lfdtpu's boxes exactly and its images within one
# uint8 step.
#
# These run on the host loader workers and produce the fixed-size crops of
# every reference training config (480/512/640).

from __future__ import annotations

import math
import random

import numpy as np

from .resize import resize_linear, scaled_size

__all__ = [
    "BaseRegionSampler",
    "TypicalCOCOTrainingRegionSampler",
    "RandomBBoxCropRegionSampler",
    "RandomBBoxCropWithRangeSelectionRegionSampler",
    "IdleRegionSampler",
    "crop_from_image",
]


def crop_from_image(image, crop_region):
    """Zero-padded crop; region (x, y, w, h) may exceed the image
    (`region_sampler.py:280-300`).

    Divergence from the reference: a region lying ENTIRELY right of /
    below the image makes the destination stop negative, which Python
    slicing wraps around — the reference raises ValueError there
    (`region_sampler.py:297-298`; unreachable from its own samplers,
    whose crops always overlap a target box). We clamp and return the
    all-zeros crop instead (tests/test_data_reference_parity.py pins
    both behaviors)."""
    im_h, im_w = image.shape[:2]
    cx, cy, cw, ch = crop_region
    if image.ndim == 3:
        out = np.zeros((ch, cw, image.shape[2]), dtype=image.dtype)
    else:
        out = np.zeros((ch, cw), dtype=image.dtype)
    out[max(0, -cy) : max(0, min(ch, im_h - cy)),
        max(0, -cx) : max(0, min(cw, im_w - cx))] = image[
        max(0, cy) : max(0, min(im_h, ch + cy)),
        max(0, cx) : max(0, min(im_w, cw + cx))
    ]
    return out


def _rescale_bboxes(bboxes, scale):
    """int-floor x/y, ceil w/h — the reference's exact rounding
    (`region_sampler.py:106-112`)."""
    out = []
    for b in bboxes:
        out.append(
            [int(b[0] * scale), int(b[1] * scale), math.ceil(b[2] * scale), math.ceil(b[3] * scale)]
        )
    return out


def _clip_boxes(scaled_bboxes, labels, crop_x, crop_y, crop_size):
    """Bbox re-clipping into crop coords (`region_sampler.py:124-144`) —
    the box half of _crop_and_clip, shared with the device-aug sampler so
    its box math is THE SAME code path as the host sampler's."""
    new_bboxes, new_labels = [], []
    for i, b in enumerate(scaled_bboxes):
        nx = max(0, b[0] - crop_x)
        ny = max(0, b[1] - crop_y)
        nw = min(crop_size, b[0] + b[2] - crop_x) - nx - 1
        nh = min(crop_size, b[1] + b[3] - crop_y) - ny - 1
        if nw <= 1 or nx >= crop_size or nh <= 1 or ny >= crop_size:
            continue
        new_bboxes.append([nx, ny, nw, nh])
        new_labels.append(labels[i])
    return new_bboxes, new_labels


def _crop_and_clip(sample, image, scaled_bboxes, labels, crop_x, crop_y, crop_size):
    """Shared crop + bbox re-clipping (`region_sampler.py:124-144`)."""
    new_bboxes, new_labels = _clip_boxes(
        scaled_bboxes, labels, crop_x, crop_y, crop_size
    )
    sample["image"] = crop_from_image(image, (crop_x, crop_y, crop_size, crop_size))
    if new_bboxes:
        sample["bboxes"] = new_bboxes
        sample["bbox_labels"] = new_labels
    else:
        sample.pop("bboxes", None)
        sample.pop("bbox_labels", None)
    return sample


class BaseRegionSampler:
    def __call__(self, sample):
        raise NotImplementedError


class TypicalCOCOTrainingRegionSampler(BaseRegionSampler):
    """Shorter-edge resize with longer-edge limit, pad to divisor
    (`region_sampler.py:29-72`). Sets resize_scale / resized_height /
    resized_width meta used by decode and evaluators."""

    def __init__(self, resize_shorter_range=(800,), resize_longer_limit=1333, pad_divisor=32):
        assert isinstance(resize_shorter_range, tuple)
        assert max(resize_shorter_range) <= resize_longer_limit
        assert pad_divisor > 0
        self._shorter_min = min(resize_shorter_range)
        self._shorter_max = max(resize_shorter_range)
        self._longer_limit = resize_longer_limit
        self._pad_divisor = pad_divisor

    def __call__(self, sample):
        assert "image" in sample
        im = sample["image"]
        h, w = im.shape[:2]
        shorter = random.randint(self._shorter_min, self._shorter_max)
        scale = min(self._longer_limit / max(h, w), shorter / min(h, w))
        im_resized = resize_linear(im, scale)
        if "bboxes" in sample:
            sample["bboxes"] = [
                [int(b[0] * scale), int(b[1] * scale),
                 max(int(b[2] * scale), 1), max(int(b[3] * scale), 1)]
                for b in sample["bboxes"]
            ]
        th = math.ceil(im_resized.shape[0] / self._pad_divisor) * self._pad_divisor
        tw = math.ceil(im_resized.shape[1] / self._pad_divisor) * self._pad_divisor
        sample["image"] = crop_from_image(im_resized, (0, 0, tw, th))
        sample["resize_scale"] = scale
        sample["resized_height"] = int(h * scale)
        sample["resized_width"] = int(w * scale)
        return sample


class RandomBBoxCropRegionSampler(BaseRegionSampler):
    """Random global resize then a fixed square crop containing one random
    GT box (`region_sampler.py:75-144`)."""

    def __init__(self, crop_size, resize_range=(0.5, 1.5), resize_prob=1.0):
        assert isinstance(crop_size, int)
        assert 0 <= resize_prob <= 1.0
        self._crop_size = crop_size
        self._resize_range = resize_range
        self._resize_prob = resize_prob

    def draw(self, sample):
        """Draw (scale, crop offsets, scaled boxes) WITHOUT resizing the
        image — the same random stream as __call__ (the resize consumes no
        randomness), so the device-aug sampler reuses this verbatim."""
        assert "image" in sample
        h, w = sample["image"].shape[:2]
        if random.random() < self._resize_prob:
            lo, hi = self._resize_range
            scale = random.random() * (hi - lo) + lo
        else:
            scale = 1.0
        bboxes = sample.get("bboxes", [])
        labels = sample.get("bbox_labels", [])
        scaled = _rescale_bboxes(bboxes, scale)
        # the resized size, cvRound(dim*s), matters only without boxes
        target = (random.choice(scaled) if scaled
                  else [0, 0, scaled_size(w, scale), scaled_size(h, scale)])
        wr = self._crop_size - target[2]
        hr = self._crop_size - target[3]
        crop_x = target[0] - random.randint(min(0, wr), max(0, wr))
        crop_y = target[1] - random.randint(min(0, hr), max(0, hr))
        return dict(scale=scale, crop_x=crop_x, crop_y=crop_y,
                    scaled_bboxes=scaled, labels=labels,
                    crop_size=self._crop_size)

    def __call__(self, sample):
        p = self.draw(sample)
        image = resize_linear(sample["image"], p["scale"])
        return _crop_and_clip(sample, image, p["scaled_bboxes"], p["labels"],
                              p["crop_x"], p["crop_y"], self._crop_size)


class RandomBBoxCropWithRangeSelectionRegionSampler(BaseRegionSampler):
    """Scale-aware crop: pick a GT box, pick a detection range (with probs),
    resize so the box's measure lands in that range, crop around it
    (`region_sampler.py:147-258`). This is how LFD trains all scale branches.

    lock_threshold: boxes smaller than it only shrink toward the range lower
    bound; boxes beyond the upper bound escape oversized with p=0.1."""

    def __init__(self, crop_size, detection_ranges, range_mode="longer",
                 neg_resize_range=(0.5, 3), range_selection_probs=None,
                 lock_threshold=None):
        assert isinstance(crop_size, int)
        assert range_mode in ("shorter", "longer", "sqrt")
        assert len(neg_resize_range) == 2
        if range_selection_probs is not None:
            assert len(detection_ranges) == len(range_selection_probs)
        self._crop_size = crop_size
        self._ranges = [tuple(r) for r in detection_ranges]
        self._range_mode = range_mode
        self._lower = self._ranges[0][0]
        self._upper = self._ranges[-1][1]
        self._neg_resize_range = neg_resize_range
        if range_selection_probs is None:
            self._probs = [1.0 / len(self._ranges)] * len(self._ranges)
        else:
            s = sum(range_selection_probs)
            self._probs = [p / s for p in range_selection_probs]
        self._lock_threshold = lock_threshold

    def _measure(self, bbox):
        w, h = bbox[2], bbox[3]
        if self._range_mode == "shorter":
            return min(w, h)
        if self._range_mode == "longer":
            return max(w, h)
        return (w * h) ** 0.5

    def draw(self, sample):
        """Parameter draws without the image resize (same random stream as
        __call__; see RandomBBoxCropRegionSampler.draw)."""
        assert "image" in sample
        h, w = sample["image"].shape[:2]
        bboxes = sample.get("bboxes", [])
        labels = sample.get("bbox_labels", [])
        target_idx = -1
        if bboxes:
            target_idx = random.randint(0, len(bboxes) - 1)
            side = self._measure(bboxes[target_idx])
            if side <= self._lower:
                scale = 1.0
            elif self._lock_threshold and side <= self._lock_threshold:
                scale = random.randint(self._lower, int(side)) / side
            elif side >= self._upper and random.random() > 0.9:
                scale = (self._upper + random.randint(0, int(self._upper * 0.5))) / side
            else:
                rng_sel = random.choices(self._ranges, self._probs)[0]
                # clamp to >=1: a range with lower bound 0 (e.g. the
                # TrafficLight scales) can otherwise draw target length 0
                # -> a resize by 0 (the reference has the same
                # hazard, `region_sampler.py:212-214`, but its configs never
                # pair range-selection with a 0 lower bound)
                scale = max(random.randint(rng_sel[0], rng_sel[1]), 1) / side
        else:
            lo, hi = self._neg_resize_range
            scale = random.random() * (hi - lo) + lo
        scaled = _rescale_bboxes(bboxes, scale)
        target = (scaled[target_idx] if scaled
                  else [0, 0, scaled_size(w, scale), scaled_size(h, scale)])
        wr = self._crop_size - target[2]
        hr = self._crop_size - target[3]
        crop_x = target[0] - random.randint(min(0, wr), max(0, wr))
        crop_y = target[1] - random.randint(min(0, hr), max(0, hr))
        return dict(scale=scale, crop_x=crop_x, crop_y=crop_y,
                    scaled_bboxes=scaled, labels=labels,
                    crop_size=self._crop_size)

    def __call__(self, sample):
        p = self.draw(sample)
        image = resize_linear(sample["image"], p["scale"])
        return _crop_and_clip(sample, image, p["scaled_bboxes"], p["labels"],
                              p["crop_x"], p["crop_y"], self._crop_size)


class IdleRegionSampler(BaseRegionSampler):
    """Identity; sets eval meta (`region_sampler.py:261-277`)."""

    def __call__(self, sample):
        assert "image" in sample
        sample["resize_scale"] = 1.0
        sample["resized_height"] = sample["image"].shape[0]
        sample["resized_width"] = sample["image"].shape[1]
        return sample
