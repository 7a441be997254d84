# Resolution-bucketed engine routing (`lfdtpu/deploy/buckets.py`): the
# answer to the reference's arbitrary-size predict flow.
#
# The reference pads each image to a stride multiple and runs the net at
# that exact size (`lfd/model/lfd.py:544-655`). A captured engine holds one
# CUDA graph at one fixed resolution (as lfdtpu's jitted program is one XLA
# compilation per shape), so a BucketedEngineSet quantizes incoming sizes onto
# a small ladder of resolution buckets, builds ONE engine per bucket lazily
# (or ahead of serving with prewarm), and routes each image to the smallest
# bucket that covers it: a bounded number of captures, static shapes, none
# in steady state. This replaces TensorRT's optimization profiles
# (`build_engine.py:74-152` builds one engine per fixed input shape).

from __future__ import annotations

import numpy as np

from .compile import compile_inference

DEFAULT_BUCKETS = ((480, 640), (720, 1280), (1080, 1920), (2160, 3840))


class BucketedEngineSet:
    """Lazily built engines over a resolution ladder, with routing.

    detector (with its weights), precision, device and engine_kwargs go to
    compile_inference; buckets is a list of (h, w) engine resolutions, each
    rounded up to the detector's largest stride. predict(image) routes to the
    smallest bucket covering the image and returns reference result rows."""

    def __init__(self, detector, buckets=DEFAULT_BUCKETS, precision="bf16", device=None,
                 **engine_kwargs):
        divisor = max(detector.point_strides)
        rounded = [(-(-int(h) // divisor) * divisor, -(-int(w) // divisor) * divisor)
                   for h, w in sorted(tuple(b) for b in buckets)]
        self.buckets = tuple(dict.fromkeys(rounded))  # dedupe, keep order
        self.detector = detector
        self._precision = precision
        self._device = device
        self._engine_kwargs = engine_kwargs
        self._engines = {}

    def bucket_for(self, h, w):
        """Smallest bucket covering (h, w); None when nothing covers it."""
        for bh, bw in self.buckets:
            if h <= bh and w <= bw:
                return (bh, bw)
        return None

    def engine_for(self, h, w):
        """The (lazily built) engine whose bucket covers (h, w)."""
        b = self.bucket_for(h, w)
        if b is None:
            raise ValueError(f"image {h}x{w} exceeds the largest bucket {self.buckets[-1]}")
        if b not in self._engines:
            self._engines[b] = compile_inference(self.detector, b, precision=self._precision,
                                                 device=self._device, **self._engine_kwargs)
        return self._engines[b]

    def prewarm(self, image_hw_or_none=None):
        """Build (and call once) engines ahead of serving: every bucket, or
        just the one covering image_hw_or_none."""
        targets = ([self.bucket_for(*image_hw_or_none)]
                   if image_hw_or_none is not None else list(self.buckets))
        for b in targets:
            if b is None:
                continue
            engine = self.engine_for(*b)
            bs = int(self._engine_kwargs.get("batch_size", 1))
            engine(np.zeros((bs,) + b + (3,), np.uint8), np.asarray(b, np.float32))
        return self

    def predict(self, image, aug_pipeline=None):
        """Route one image (path or HWC array) to its bucket's engine and
        return [[class_label, score, x1, y1, w, h], ...]."""
        if isinstance(image, str):
            import cv2

            image = cv2.imread(image, cv2.IMREAD_UNCHANGED)
            if image is None:
                raise FileNotFoundError("could not read the image")
        h, w = np.asarray(image).shape[:2]
        engine = self.engine_for(h, w)
        return self.detector.predict_for_single_image_with_engine(engine, image,
                                                                  aug_pipeline=aug_pipeline)
