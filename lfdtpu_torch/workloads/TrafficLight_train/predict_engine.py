# -*- coding: utf-8 -*-
# Prediction through a compiled deployment engine of the PyTorch port
# (reference `TrafficLight_train/predict_tensorrt.py`, ONNX -> TRT engine;
# mirroring `workloads/TrafficLight_train/predict_engine.py`): one
# end-to-end engine (BGR -> RGB and the imagenet normalize on the device,
# class-agnostic decode and NMS included) at the image's resolution bucket,
# in fp32, bf16 or int8, on the device LFD_DEVICE (default cuda, where the engine
# is one captured CUDA graph).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

import numpy as np  # noqa: E402

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.deploy import (compile_inference, make_device_preprocess,  # noqa: E402
                                 quantize_net_int8)
from lfdtpu_torch.execution import load_checkpoint  # noqa: E402
from lfdtpu_torch.models import pad_to_multiple  # noqa: E402
from lfdtpu_torch.ops.decode import detections_to_lists  # noqa: E402


def predict_with_engine(
    model_size,
    param_file_path,
    image_path,
    precision="bf16",
    classification_threshold=0.5,
    nms_threshold=0.3,
    out_path=None,
    engine_file=None,
):
    """precision "fp32", "bf16" or "int8" (the calibrated fused int8 chain on
    fake-quantized weights, as lfdtpu's script builds it). engine_file: when
    set, the built engine is saved there on first use and loaded from it,
    with no model built, on later runs (deploy/engine_io.py; the reference's
    `predict_tensorrt.py` deserializes its `*.trt` file the same way)."""
    import cv2

    image = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
    h, w = image.shape[:2]
    device = os.environ.get("LFD_DEVICE", "cuda")  # without a CUDA device cuda raises

    if engine_file is not None and os.path.exists(engine_file):
        from lfdtpu_torch.deploy.engine_io import load_engine, predict_padded

        decoded = predict_padded(load_engine(engine_file, device=device), image)
    else:
        det = zoo.trafficlight_lfd(model_size)
        det.net.load_state_dict(load_checkpoint(param_file_path)["state_dict"], strict=True)
        if precision == "int8":
            det.net = quantize_net_int8(det.net)
        padded = pad_to_multiple(image, max(det.point_strides))
        preprocess = make_device_preprocess(
            (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), bgr2rgb=True
        )
        engine = compile_inference(
            det, padded.shape[:2], precision=precision, preprocess=preprocess,
            classification_threshold=classification_threshold,
            nms_threshold=nms_threshold,
            class_agnostic=True,
            device=device,
        )
        if engine_file is not None:
            from lfdtpu_torch.deploy.engine_io import save_engine

            save_engine(engine, engine_file)
        decoded = engine(padded[None], np.asarray([h, w], np.float32))
    results = detections_to_lists({k: v[0] for k, v in decoded.items()})

    for bbox in results:
        print(bbox)
        cv2.rectangle(
            image, (int(bbox[2]), int(bbox[3])),
            (int(bbox[2] + bbox[4]), int(bbox[3] + bbox[5])), (0, 255, 0), 2,
        )
    print("%d lights are detected!" % len(results))
    out_path = out_path or "./tl_predict_engine.jpg"
    cv2.imwrite(out_path, image)
    return results


if __name__ == "__main__":
    predict_with_engine(
        model_size="L",
        param_file_path="./TL_LFD_L_work_dir/epoch_100.pth",
        image_path="./test-imgs/1.jpg",
    )
