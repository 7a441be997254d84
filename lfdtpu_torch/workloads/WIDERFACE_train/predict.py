# -*- coding: utf-8 -*-
# Single-image prediction demo of the PyTorch port (reference
# `WIDERFACE_train/predict.py`, mirroring
# `workloads/WIDERFACE_train/predict.py`): load a trained .pth checkpoint,
# predict on a test image on the device LFD_DEVICE (default cuda), draw the
# boxes.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.data import simple_widerface_val_pipeline  # noqa: E402
from lfdtpu_torch.device import resolve_device  # noqa: E402
from lfdtpu_torch.execution import load_checkpoint  # noqa: E402


def predict(model_size, param_file_path, image_path,
            classification_threshold=0.5, nms_threshold=0.3, out_path=None):
    import cv2

    model = zoo.widerface_lfd(model_size)
    model.net.load_state_dict(load_checkpoint(param_file_path)["state_dict"], strict=True)
    # default cuda; without a CUDA device that raises
    model.net.to(resolve_device(os.environ.get("LFD_DEVICE", "cuda"), "LFD_DEVICE")).eval()
    image = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
    results = model.predict_for_single_image(
        image,
        aug_pipeline=simple_widerface_val_pipeline,
        classification_threshold=classification_threshold,
        nms_threshold=nms_threshold,
    )
    for bbox in results:
        print(bbox)
        cv2.rectangle(
            image,
            (int(bbox[2]), int(bbox[3])),
            (int(bbox[2] + bbox[4]), int(bbox[3] + bbox[5])),
            (0, 255, 0), 1,
        )
    print("%d faces are detected!" % len(results))
    out_path = out_path or "./widerface_predict.jpg"
    cv2.imwrite(out_path, image)
    print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    predict(
        model_size="M",
        param_file_path="./WIDERFACE_LFD_M_work_dir/epoch_1000.pth",
        image_path="./test_images/image1.jpg",
    )
