# -*- coding: utf-8 -*-
# Single-image prediction demo of the PyTorch port (reference
# `TT100K_train/predict.py`, mirroring `workloads/TT100K_train/predict.py`):
# load a trained .pth checkpoint, predict on a test image on the device
# LFD_DEVICE (default cuda), print each sign's TT100K_TYPE45 name, draw the
# boxes.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.data import TT100K_TYPE45  # noqa: E402
from lfdtpu_torch.device import resolve_device  # noqa: E402
from lfdtpu_torch.execution import load_checkpoint  # noqa: E402
from lfdtpu_torch.workloads.TT100K_train.TT100K_augmentation_pipeline import (  # noqa: E402
    tt100k_val_pipeline,
)


def predict(model_size, param_file_path, image_path,
            classification_threshold=0.4, nms_threshold=0.5, out_path=None):
    import cv2

    model = zoo.tt100k_lfd(model_size)
    model.net.load_state_dict(load_checkpoint(param_file_path)["state_dict"], strict=True)
    # default cuda; without a CUDA device that raises
    model.net.to(resolve_device(os.environ.get("LFD_DEVICE", "cuda"), "LFD_DEVICE")).eval()

    image = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
    results = model.predict_for_single_image(
        image, aug_pipeline=tt100k_val_pipeline,
        classification_threshold=classification_threshold,
        nms_threshold=nms_threshold,
    )
    for bbox in results:
        name = TT100K_TYPE45[int(bbox[0])]
        print(name, bbox)
        cv2.rectangle(image, (int(bbox[2]), int(bbox[3])),
                      (int(bbox[2] + bbox[4]), int(bbox[3] + bbox[5])), (0, 255, 0), 2)
        cv2.putText(image, name, (int(bbox[2]), int(bbox[3]) - 3),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
    print("%d signs are detected!" % len(results))
    out_path = out_path or "./tt100k_predict.jpg"
    cv2.imwrite(out_path, image)
    return results


if __name__ == "__main__":
    predict(
        model_size="L",
        param_file_path="./TT100K_LFD_L_work_dir/epoch_500.pth",
        image_path="./test_images/1.jpg",
    )
