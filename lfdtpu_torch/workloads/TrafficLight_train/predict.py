# -*- coding: utf-8 -*-
# Single-image and folder prediction demo of the PyTorch port (reference
# `TrafficLight_train/predict.py`, mirroring `workloads/TrafficLight_train/
# predict.py`): load a trained .pth checkpoint, predict class-agnostic on the
# device LFD_DEVICE (default cuda) on a file or on every jpg / png of a
# folder, draw the boxes.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.device import resolve_device  # noqa: E402
from lfdtpu_torch.execution import load_checkpoint  # noqa: E402
from lfdtpu_torch.workloads.TrafficLight_train.TL_augmentation_pipeline import (  # noqa: E402
    tl_val_pipeline,
)


def _predict_one(model, image_path, classification_threshold, nms_threshold,
                 out_dir=None):
    import cv2

    image = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
    results = model.predict_for_single_image(
        image, aug_pipeline=tl_val_pipeline,
        classification_threshold=classification_threshold,
        nms_threshold=nms_threshold,
        class_agnostic=True,
    )
    for bbox in results:
        print(bbox)
        cv2.rectangle(
            image, (int(bbox[2]), int(bbox[3])),
            (int(bbox[2] + bbox[4]), int(bbox[3] + bbox[5])), (0, 255, 0), 2,
        )
    print("%d lights are detected!" % len(results))
    out_dir = out_dir or "."
    base = os.path.basename(image_path)
    out_path = os.path.join(out_dir, base.rsplit(".", 1)[0] + "_result.jpg")
    cv2.imwrite(out_path, image)
    print(f"wrote {out_path}")
    return results


def predict(model_size, param_file_path, image_path,
            classification_threshold=0.5, nms_threshold=0.3, out_dir=None):
    model = zoo.trafficlight_lfd(model_size)
    model.net.load_state_dict(load_checkpoint(param_file_path)["state_dict"], strict=True)
    # default cuda; without a CUDA device that raises
    model.net.to(resolve_device(os.environ.get("LFD_DEVICE", "cuda"), "LFD_DEVICE")).eval()

    if os.path.isfile(image_path):
        return _predict_one(model, image_path, classification_threshold, nms_threshold,
                            out_dir)
    # folder mode, like the reference's `./test-imgs` branch
    paths = [
        os.path.join(image_path, f)
        for f in sorted(os.listdir(image_path))
        if f.endswith(("jpg", "png"))
    ]
    return [
        _predict_one(model, p, classification_threshold, nms_threshold, out_dir)
        for p in paths
    ]


if __name__ == "__main__":
    predict(
        model_size="L",
        param_file_path="./TL_LFD_L_work_dir/epoch_100.pth",
        image_path="./test-imgs",
    )
