# -*- coding: utf-8 -*-
# Inference latency benchmark of the PyTorch port for the TrafficLight models
# (reference `TrafficLight_train/timing_inference_latency.py` -> TensorRT
# engines at 1280x720, mirroring `workloads/TrafficLight_train/
# timing_inference_latency.py`): end-to-end engines (BGR -> RGB + standard
# normalize + net + decode + NMS on the device, where the TRT numbers exclude
# decode and NMS) on the device LFD_DEVICE (default cuda, where each engine
# is one captured CUDA graph). Seeded random weights: the time does not
# depend on them.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

import torch  # noqa: E402

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.deploy import inference_latency_evaluation, make_device_preprocess  # noqa: E402

model_size = "S"
precision_mode = "fp32"  # 'fp32' | 'bf16' (int8: ROADMAP queue 1, item 6)
resolutions = ((720, 1280),)
timing_loops = 1000

if __name__ == "__main__":
    if precision_mode == "int8":
        raise NotImplementedError("int8 engines are not ported yet (ROADMAP queue 1, item 6)")
    det = zoo.trafficlight_lfd(model_size)
    det.init(torch.Generator().manual_seed(0))
    preprocess = make_device_preprocess(
        (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), bgr2rgb=True
    )
    inference_latency_evaluation(
        det,
        resolutions=resolutions,
        precisions=(precision_mode,),
        preprocess=preprocess,
        timing_loops=timing_loops,
        device=os.environ.get("LFD_DEVICE", "cuda"),
    )
