# -*- coding: utf-8 -*-
# TT100K augmentation of the PyTorch port (reference
# `TT100K_train/TT100K_augmentation_pipeline.py`, mirroring
# `workloads/TT100K_train/TT100K_augmentation_pipeline.py`): NO horizontal
# flip, since traffic signs are not left-right symmetric; only the simple
# (0.5, 0.5) normalization.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch.data import Compose, simple_normalize  # noqa: E402

tt100k_train_pipeline = Compose([simple_normalize])
tt100k_val_pipeline = Compose([simple_normalize])
