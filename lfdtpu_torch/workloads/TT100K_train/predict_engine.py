# -*- coding: utf-8 -*-
# Prediction through a compiled deployment engine of the PyTorch port
# (reference `TT100K_train/predict_tensorrt.py`, ONNX -> TRT engine;
# mirroring `workloads/TT100K_train/predict_engine.py`): one end-to-end
# engine (softmax decode and class-offset NMS included) at the image's
# resolution bucket, in fp32 or bf16, on the device LFD_DEVICE (default
# cuda, where the engine is one captured CUDA graph).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

import numpy as np  # noqa: E402

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.data import TT100K_TYPE45  # noqa: E402
from lfdtpu_torch.deploy import compile_inference, make_device_preprocess  # noqa: E402
from lfdtpu_torch.execution import load_checkpoint  # noqa: E402
from lfdtpu_torch.models import pad_to_multiple  # noqa: E402
from lfdtpu_torch.ops.decode import detections_to_lists  # noqa: E402


def predict_with_engine(
    model_size,
    param_file_path,
    image_path,
    precision="bf16",
    classification_threshold=0.4,
    nms_threshold=0.5,
    out_path=None,
    engine_file=None,
):
    """engine_file (lfdtpu: serialize the built engine on first use, load it
    on later runs) and precision="int8" are not ported yet."""
    if engine_file is not None:
        raise NotImplementedError("engine files (deploy/engine_io.py) are not ported yet "
                                  "(ROADMAP queue 1, item 7)")
    if precision == "int8":
        raise NotImplementedError("int8 engines are not ported yet (ROADMAP queue 1, item 6)")
    import cv2

    image = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
    h, w = image.shape[:2]

    det = zoo.tt100k_lfd(model_size)
    det.net.load_state_dict(load_checkpoint(param_file_path)["state_dict"], strict=True)
    padded = pad_to_multiple(image, max(det.point_strides))
    # TT100K uses the simple normalize and no flip (TT100K_augmentation_pipeline.py)
    preprocess = make_device_preprocess((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    engine = compile_inference(
        det, padded.shape[:2], precision=precision, preprocess=preprocess,
        classification_threshold=classification_threshold,
        nms_threshold=nms_threshold,
        device=os.environ.get("LFD_DEVICE", "cuda"),  # without a CUDA device cuda raises
    )
    decoded = engine(padded[None], np.asarray([h, w], np.float32))
    results = detections_to_lists({k: v[0] for k, v in decoded.items()})

    for bbox in results:
        name = TT100K_TYPE45[int(bbox[0])]
        print(name, bbox)
        cv2.rectangle(
            image, (int(bbox[2]), int(bbox[3])),
            (int(bbox[2] + bbox[4]), int(bbox[3] + bbox[5])), (0, 255, 0), 2,
        )
        cv2.putText(image, name, (int(bbox[2]), int(bbox[3]) - 3),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
    print("%d signs are detected!" % len(results))
    out_path = out_path or "./tt100k_predict_engine.jpg"
    cv2.imwrite(out_path, image)
    return results


if __name__ == "__main__":
    predict_with_engine(
        model_size="L",
        param_file_path="./TT100K_LFD_L_work_dir/epoch_500.pth",
        image_path="./test_images/1.jpg",
    )
