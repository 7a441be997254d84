# Shared config-as-code for the port's WIDERFACE training scripts, mirroring
# `workloads/WIDERFACE_train/_common.py` (reference
# `WIDERFACE_train/WIDERFACE_LFD_{XS,S,M,L}.py`: the four scripts differ only
# in the backbone plan; the hyperparameters are `WIDERFACE_LFD_S.py:31-244`).
#
# Environment overrides, for runs without editing the script: LFD_EPOCHS,
# LFD_BATCH_SIZE, LFD_NUM_WORKERS, LFD_DATASET_PATH, LFD_DEVICE_AUG (1: the
# augmentation runs on the device, data/device_aug.py) and LFD_DEVICE (the
# torch device, default cuda; without a CUDA device the run raises).

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.data import (  # noqa: E402
    DataLoader,
    Dataset,
    RandomBBoxCropRegionSampler,
    RandomWithNegDatasetSampler,
    simple_widerface_train_pipeline,
)
from lfdtpu_torch.execution import (  # noqa: E402
    SGD,
    MultiStepLRSchedule,
    WarmupSetting,
    customize_exception_hook,
    set_random_seed,
)
from lfdtpu_torch.parallel import initialize_distributed  # noqa: E402


def _env_int(name, default):
    return int(os.environ.get(name, default))


def prepare_common_settings(config_dict, script_path):
    # under `torchrun --nproc_per_node N`: one process per card joins the
    # process group, and the Executor trains data parallel (alone: a no-op)
    initialize_distributed()
    config_dict["timestamp"] = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    base = os.path.basename(script_path).split(".")[0]
    config_dict["work_dir"] = "./" + base + "_work_dir_" + config_dict["timestamp"]
    os.makedirs(config_dict["work_dir"], exist_ok=True)
    # copy config for reproducibility (`WIDERFACE_LFD_S.py:37-39`)
    import shutil

    shutil.copyfile(script_path, os.path.join(config_dict["work_dir"], os.path.basename(script_path)))
    config_dict["log_path"] = os.path.join(
        config_dict["work_dir"], "log_" + config_dict["timestamp"] + ".log"
    )
    sys.excepthook = customize_exception_hook(
        os.path.join(config_dict["work_dir"], "exception_log_" + config_dict["timestamp"] + ".log")
    )
    config_dict["device"] = os.environ.get("LFD_DEVICE", "cuda")
    config_dict["training_epochs"] = _env_int("LFD_EPOCHS", 1000)
    config_dict["seed"] = 666
    if config_dict["seed"] is not None:
        set_random_seed(config_dict["seed"])
    config_dict["display_interval"] = 100
    config_dict["save_interval"] = 100
    config_dict["val_interval"] = 0


def prepare_model(config_dict, size):
    config_dict["num_input_channels"] = 3
    config_dict["num_classes"] = 1
    config_dict["detection_scales"] = zoo.WIDERFACE_SCALES
    config_dict["model"] = zoo.widerface_lfd(size)
    config_dict["weight_path"] = None
    config_dict["resume_path"] = None
    config_dict["evaluator"] = None


def prepare_data_pipeline(config_dict):
    config_dict["batch_size"] = _env_int("LFD_BATCH_SIZE", 64)
    config_dict["num_train_workers"] = _env_int("LFD_NUM_WORKERS", 12)
    config_dict["num_val_workers"] = 0
    config_dict["train_dataset_path"] = os.environ.get(
        "LFD_DATASET_PATH", "./WIDERFACE_pack/widerface_train.pkl"
    )
    config_dict["input_hw"] = (480, 480)  # crop_size 480

    train_dataset = Dataset(load_path=config_dict["train_dataset_path"])
    train_dataset_sampler = RandomWithNegDatasetSampler(
        train_dataset,
        batch_size=config_dict["batch_size"],
        neg_ratio=0.2,
        shuffle=True,
        ignore_last=False,
    )
    train_region_sampler = RandomBBoxCropRegionSampler(
        crop_size=480, resize_range=(0.5, 1.5), resize_prob=0.5
    )
    # LFD_DEVICE_AUG=1: resample/flip/normalize move into the train step
    # (data/device_aug.py); the host only windows raw uint8 crops. Box math
    # and the random streams are identical to the host path (the same
    # draw()/_clip_boxes code).
    if _env_int("LFD_DEVICE_AUG", 0):
        import numpy as np

        from lfdtpu_torch.data import DeviceAugRegionSampler, make_device_augment
        from lfdtpu_torch.deploy import make_device_preprocess

        config_dict["device_augment"] = make_device_augment(
            480,
            normalize=make_device_preprocess((0.5,) * 3, (0.5,) * 3),
        )
        config_dict["train_data_loader"] = DataLoader(
            dataset=train_dataset,
            dataset_sampler=train_dataset_sampler,
            region_sampler=DeviceAugRegionSampler(
                train_region_sampler, flip_p=0.5
            ),
            augmentation_pipeline=None,
            num_workers=config_dict["num_train_workers"],
            max_boxes_per_image=200,
            image_dtype=np.uint8,
        )
        return
    config_dict["train_data_loader"] = DataLoader(
        dataset=train_dataset,
        dataset_sampler=train_dataset_sampler,
        region_sampler=train_region_sampler,
        augmentation_pipeline=simple_widerface_train_pipeline,
        num_workers=config_dict["num_train_workers"],
        max_boxes_per_image=200,
    )


def prepare_optimizer(config_dict):
    config_dict["learning_rate"] = 0.1
    config_dict["momentum"] = 0.9
    config_dict["weight_decay"] = 0.0001
    config_dict["optimizer"] = SGD(
        momentum=config_dict["momentum"], weight_decay=config_dict["weight_decay"]
    )
    config_dict["optimizer_grad_clip_cfg"] = dict(max_norm=10, norm_type=2, duration=5)
    config_dict["milestones"] = [
        m for m in (500, 700, 900) if m < config_dict["training_epochs"]
    ]
    config_dict["gamma"] = 0.1
    config_dict["warmup_setting"] = dict(
        by_epoch=False, warmup_mode="linear", warmup_loops=200, warmup_ratio=0.1
    )
    config_dict["lr_schedule"] = MultiStepLRSchedule(
        base_lr=config_dict["learning_rate"],
        milestones=tuple(config_dict["milestones"]),
        gamma=config_dict["gamma"],
        warmup=WarmupSetting(**config_dict["warmup_setting"]),
    )


def run(config_dict):
    from lfdtpu_torch.execution import Executor

    Executor(config_dict).run()
