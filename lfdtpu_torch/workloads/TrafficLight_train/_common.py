# Shared config-as-code for the port's TrafficLight training scripts. lfdtpu
# has two standalone scripts, `workloads/TrafficLight_train/TL_LFD_{S,L}.py`
# (reference `TrafficLight_train/TL_LFD_{S,L}.py`), that differ only in the
# model size: QualityFocalLoss(w=2) + IoULoss, 'dist' range mode, batch 4,
# crop 640, COCO-format data packed by pack_TL.py.
#
# Environment overrides, for runs without editing the script: LFD_EPOCHS,
# LFD_BATCH_SIZE, LFD_NUM_WORKERS, LFD_DATASET_PATH, LFD_CROP_SIZE,
# LFD_DEVICE_AUG (1: the augmentation runs on the device, data/device_aug.py)
# and LFD_DEVICE (the torch device, default cuda; without a CUDA device the
# run raises).

import os
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.data import (  # noqa: E402
    DataLoader,
    Dataset,
    RandomBBoxCropRegionSampler,
    RandomWithNegDatasetSampler,
)
from lfdtpu_torch.execution import (  # noqa: E402
    SGD,
    MultiStepLRSchedule,
    WarmupSetting,
    customize_exception_hook,
    set_random_seed,
)
from lfdtpu_torch.parallel import initialize_distributed  # noqa: E402
from lfdtpu_torch.workloads.TrafficLight_train.TL_augmentation_pipeline import (  # noqa: E402
    TL_FLIP_P,
    tl_train_pipeline,
)


def prepare_common_settings(config_dict, script_path):
    # under `torchrun --nproc_per_node N`: one process per card joins the
    # process group, and the Executor trains data parallel (alone: a no-op)
    initialize_distributed()
    config_dict["timestamp"] = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    base = os.path.basename(script_path).split(".")[0]
    config_dict["work_dir"] = "./" + base + "_work_dir_" + config_dict["timestamp"]
    os.makedirs(config_dict["work_dir"], exist_ok=True)
    shutil.copyfile(script_path, os.path.join(config_dict["work_dir"], os.path.basename(script_path)))
    config_dict["log_path"] = os.path.join(
        config_dict["work_dir"], "log_" + config_dict["timestamp"] + ".log"
    )
    sys.excepthook = customize_exception_hook(
        os.path.join(config_dict["work_dir"], "exception_log_" + config_dict["timestamp"] + ".log")
    )
    config_dict["device"] = os.environ.get("LFD_DEVICE", "cuda")
    config_dict["training_epochs"] = int(os.environ.get("LFD_EPOCHS", 500))
    config_dict["seed"] = 666
    set_random_seed(config_dict["seed"])
    config_dict["display_interval"] = 100
    config_dict["save_interval"] = 50
    config_dict["val_interval"] = 0


def prepare_model(config_dict, size):
    config_dict["num_classes"] = 1
    config_dict["detection_scales"] = zoo.TL_SCALES
    config_dict["model"] = zoo.trafficlight_lfd(size)
    config_dict["weight_path"] = None
    config_dict["resume_path"] = None
    config_dict["evaluator"] = None


def prepare_data_pipeline(config_dict):
    config_dict["batch_size"] = int(os.environ.get("LFD_BATCH_SIZE", 4))
    config_dict["num_train_workers"] = int(os.environ.get("LFD_NUM_WORKERS", 4))
    config_dict["train_dataset_path"] = os.environ.get(
        "LFD_DATASET_PATH", "./TL_pack/tl_train.pkl")
    crop = int(os.environ.get("LFD_CROP_SIZE", 640))
    config_dict["input_hw"] = (crop, crop)
    train_dataset = Dataset(load_path=config_dict["train_dataset_path"])
    sampler = RandomWithNegDatasetSampler(
        train_dataset, batch_size=config_dict["batch_size"], neg_ratio=0.2,
        shuffle=True, ignore_last=False,
    )
    region = RandomBBoxCropRegionSampler(crop_size=crop, resize_range=(0.5, 1.5), resize_prob=0.5)
    # LFD_DEVICE_AUG=1: resample, flip, BGR -> RGB and the imagenet normalize
    # move into the train step (data/device_aug.py). The flip keeps the host
    # pipeline's TL_FLIP_P; the channel swap and the standard normalize fold
    # into make_device_preprocess(bgr2rgb=True).
    if int(os.environ.get("LFD_DEVICE_AUG", 0)):
        import numpy as np

        from lfdtpu_torch.data import DeviceAugRegionSampler, make_device_augment
        from lfdtpu_torch.deploy import make_device_preprocess

        config_dict["device_augment"] = make_device_augment(
            crop,
            normalize=make_device_preprocess(
                (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), bgr2rgb=True
            ),
        )
        config_dict["train_data_loader"] = DataLoader(
            dataset=train_dataset, dataset_sampler=sampler,
            region_sampler=DeviceAugRegionSampler(region, flip_p=TL_FLIP_P),
            augmentation_pipeline=None,
            num_workers=config_dict["num_train_workers"],
            max_boxes_per_image=100,
            image_dtype=np.uint8,
        )
        return
    config_dict["train_data_loader"] = DataLoader(
        dataset=train_dataset, dataset_sampler=sampler, region_sampler=region,
        augmentation_pipeline=tl_train_pipeline,
        num_workers=config_dict["num_train_workers"],
        max_boxes_per_image=100,
    )


def prepare_optimizer(config_dict):
    config_dict["learning_rate"] = 0.1
    config_dict["optimizer"] = SGD(momentum=0.9, weight_decay=0.0001)
    config_dict["optimizer_grad_clip_cfg"] = dict(max_norm=10, duration=5)
    config_dict["milestones"] = [200, 300, 400]
    config_dict["lr_schedule"] = MultiStepLRSchedule(
        base_lr=0.1, milestones=(200, 300, 400), gamma=0.1,
        warmup=WarmupSetting(by_epoch=False, warmup_mode="linear",
                             warmup_loops=200, warmup_ratio=0.1),
    )


def run(config_dict):
    from lfdtpu_torch.execution import Executor

    Executor(config_dict).run()
