# -*- coding: utf-8 -*-
# TrafficLight augmentation of the PyTorch port (reference
# `TrafficLight_train/TL_augmentation_pipeline.py`, mirroring
# `workloads/TrafficLight_train/TL_augmentation_pipeline.py`): a horizontal
# flip, BGR -> RGB, then the standard imagenet normalization (models
# pretrained on RGB).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch.data import BGR2RGB, Compose, HorizontalFlip, standard_normalize  # noqa: E402

# The flip probability of TL training, on the host and on the device
# (_common.py's DeviceAugRegionSampler). lfdtpu flips with 0.5 and the port
# mirrors it; the upstream pipeline may forbid flips for traffic lights
# (ROADMAP F4).
TL_FLIP_P = 0.5

tl_train_pipeline = Compose([HorizontalFlip(TL_FLIP_P), BGR2RGB(), standard_normalize])
tl_val_pipeline = Compose([BGR2RGB(), standard_normalize])
