# -*- coding: utf-8 -*-
# TrafficLight LFD-S training entry point of the PyTorch port (config-as-code,
# reference `TrafficLight_train/TL_LFD_S.py`, mirroring
# `workloads/TrafficLight_train/TL_LFD_S.py`): QualityFocalLoss(w=2) +
# IoULoss, 'dist' range mode, crop 640, COCO-format data via pack_TL.py.
# Running this script trains the model on the device LFD_DEVICE (default
# cuda). Edit literals via _common.py / lfdtpu_torch.zoo.
from _common import (
    prepare_common_settings,
    prepare_model,
    prepare_data_pipeline,
    prepare_optimizer,
    run,
)

config_dict = dict()


if __name__ == "__main__":
    prepare_common_settings(config_dict, __file__)
    prepare_model(config_dict, "S")
    prepare_data_pipeline(config_dict)
    prepare_optimizer(config_dict)
    run(config_dict)
