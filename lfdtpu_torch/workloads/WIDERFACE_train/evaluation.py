# -*- coding: utf-8 -*-
# WIDERFACE SIO offline evaluation of the PyTorch port (reference
# `WIDERFACE_train/evaluation.py`, mirroring
# `workloads/WIDERFACE_train/evaluation.py`): per val image, class-agnostic
# predict at thr 0.01 / NMS 0.4 on the device LFD_DEVICE (default cuda),
# write per-event txt files for the matlab SIO tooling.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.device import resolve_device  # noqa: E402
from lfdtpu_torch.evaluation import SIO_evaluation  # noqa: E402
from lfdtpu_torch.execution import load_checkpoint  # noqa: E402


def run_SIO_evaluation(
    model_size="XS",
    param_file_path="./WIDERFACE_LFD_XS_work_dir/epoch_1000.pth",
    val_image_root="./WIDER_val/images",
    results_save_root="./WIDERFACE_evaluation/LFD_XS",
    classification_threshold=0.01,
    nms_threshold=0.4,
):
    model = zoo.widerface_lfd(model_size)
    model.net.load_state_dict(load_checkpoint(param_file_path)["state_dict"], strict=True)
    # default cuda; without a CUDA device that raises
    model.net.to(resolve_device(os.environ.get("LFD_DEVICE", "cuda"), "LFD_DEVICE")).eval()
    return SIO_evaluation(
        model=model,
        val_image_root=val_image_root,
        results_save_root=results_save_root,
        classification_threshold=classification_threshold,
        nms_threshold=nms_threshold,
    )


if __name__ == "__main__":
    run_SIO_evaluation()
