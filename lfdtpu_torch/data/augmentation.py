# Augmentation pipelines, a copy of `lfdtpu/data/augmentation.py` (reference
# `lfd/data_pipeline/augmentation/`).
#
# The reference composes albumentations transforms; here the same transforms
# are implemented directly (albumentations is not a dependency). Semantics:
#   - HorizontalFlip(p): flips image + coco-format bboxes (x -> W - x - w)
#   - Normalize(mean, std, max_pixel_value): (x - mean*mpv) / (std*mpv)
#   - BGR2RGB: channel swap (`new_augmentations.py:11-31`)
# The three canonical normalizers (`augmentation_pipeline.py:14-36`) and the
# per-workload pipelines are provided with the same names.
#
# Normalization can instead run on the device inside the train step
# (deploy.make_device_preprocess, or data/device_aug.py).

from __future__ import annotations

import random

import numpy as np

__all__ = [
    "Compose", "HorizontalFlip", "Normalize", "BGR2RGB",
    "caffe_imagenet_normalize", "standard_normalize", "simple_normalize",
    "simple_widerface_train_pipeline", "simple_widerface_val_pipeline",
    "typical_coco_train_pipeline", "typical_coco_val_pipeline",
]


class Transform:
    def __call__(self, sample):
        raise NotImplementedError


class HorizontalFlip(Transform):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, sample):
        if random.random() >= self.p:
            return sample
        image = sample["image"]
        sample["image"] = np.ascontiguousarray(image[:, ::-1])
        if "bboxes" in sample:
            w_img = image.shape[1]
            sample["bboxes"] = [
                [w_img - b[0] - b[2], b[1], b[2], b[3]] for b in sample["bboxes"]
            ]
        return sample


class Normalize(Transform):
    def __init__(self, mean, std, max_pixel_value=255.0, p=1.0):
        self.mean = np.asarray(mean, np.float32) * max_pixel_value
        self.std = np.asarray(std, np.float32) * max_pixel_value
        self.p = p

    def __call__(self, sample):
        img = sample["image"].astype(np.float32)
        sample["image"] = (img - self.mean) / self.std
        return sample


class BGR2RGB(Transform):
    def __call__(self, sample):
        sample["image"] = np.ascontiguousarray(sample["image"][..., ::-1])
        return sample


class Compose(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


# canonical normalizers (`augmentation_pipeline.py:14-36`)
caffe_imagenet_normalize = Normalize(
    mean=(102.9801, 115.9465, 122.7717), std=(1.0, 1.0, 1.0), max_pixel_value=1.0
)
standard_normalize = Normalize(
    mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), max_pixel_value=255.0
)
simple_normalize = Normalize(
    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), max_pixel_value=255.0
)

_flip = HorizontalFlip(0.5)

simple_widerface_train_pipeline = Compose([_flip, simple_normalize])
simple_widerface_val_pipeline = Compose([simple_normalize])
typical_coco_train_pipeline = Compose([_flip, caffe_imagenet_normalize])
typical_coco_val_pipeline = Compose([caffe_imagenet_normalize])
