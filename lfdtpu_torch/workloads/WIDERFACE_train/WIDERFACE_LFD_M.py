# -*- coding: utf-8 -*-
# WIDERFACE LFD-M training entry point of the PyTorch port (config-as-code,
# reference `WIDERFACE_train/WIDERFACE_LFD_M.py`, mirroring
# `workloads/WIDERFACE_train/WIDERFACE_LFD_M.py`): running this script
# trains the model on the device LFD_DEVICE (default cuda). Edit literals via
# _common.py / lfdtpu_torch.zoo.
from _common import (
    prepare_common_settings,
    prepare_model,
    prepare_data_pipeline,
    prepare_optimizer,
    run,
)

memo = (
    "WIDERFACE M: shared merged head with GN, FocalLoss classification, "
    "IoULoss regression, sigmoid distance-to-bbox"
)

config_dict = dict()


if __name__ == "__main__":
    prepare_common_settings(config_dict, __file__)
    prepare_model(config_dict, "M")
    prepare_data_pipeline(config_dict)
    prepare_optimizer(config_dict)
    run(config_dict)
