# -*- coding: utf-8 -*-
# TT100K LFD-L training entry point of the PyTorch port (config-as-code,
# reference `TT100K_train/TT100K_LFD_L.py`, mirroring
# `workloads/TT100K_train/TT100K_LFD_L.py`): running this script trains the
# model on the device LFD_DEVICE (default cuda). Edit literals via _common.py
# / lfdtpu_torch.zoo.
from _common import (
    prepare_common_settings,
    prepare_model,
    prepare_data_pipeline,
    prepare_optimizer,
    run,
)

memo = (
    "TT100K L: 45-class traffic signs, CrossEntropyLoss(+bg) + IoULoss, "
    "'longer' range mode, sigmoid distance-to-bbox, no flip aug"
)

config_dict = dict()


if __name__ == "__main__":
    prepare_common_settings(config_dict, __file__)
    prepare_model(config_dict, "L")
    prepare_data_pipeline(config_dict)
    prepare_optimizer(config_dict)
    run(config_dict)
