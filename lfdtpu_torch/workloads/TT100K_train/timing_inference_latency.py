# -*- coding: utf-8 -*-
# Inference latency benchmark of the PyTorch port for the TT100K models
# (reference `WIDERFACE_train/timing_inference_latency.py` -> TensorRT
# engines, mirroring `workloads/TT100K_train/timing_inference_latency.py`):
# sweep resolutions x precisions with end-to-end engines (device preprocess
# + net + softmax decode + NMS, which the TRT numbers exclude) on the device
# LFD_DEVICE (default cuda, where each engine is one captured CUDA graph).
# Seeded random weights: the time does not depend on them.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

import torch  # noqa: E402

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.deploy import inference_latency_evaluation, make_device_preprocess  # noqa: E402

model_size = "S"
precision_mode = "bf16"  # 'fp32' | 'bf16' (int8: ROADMAP queue 1, item 6)
resolutions = ((480, 640), (720, 1280), (1080, 1920), (2160, 3840))
timing_loops = 50

if __name__ == "__main__":
    if precision_mode == "int8":
        raise NotImplementedError("int8 engines are not ported yet (ROADMAP queue 1, item 6)")
    det = zoo.tt100k_lfd(model_size)
    det.init(torch.Generator().manual_seed(0))
    preprocess = make_device_preprocess((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    inference_latency_evaluation(
        det,
        resolutions=resolutions,
        precisions=(precision_mode,),
        preprocess=preprocess,
        timing_loops=timing_loops,
        device=os.environ.get("LFD_DEVICE", "cuda"),
    )
