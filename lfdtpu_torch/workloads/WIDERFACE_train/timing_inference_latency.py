# -*- coding: utf-8 -*-
# Inference latency benchmark of the PyTorch port (reference
# `WIDERFACE_train/timing_inference_latency.py` -> TensorRT engines,
# mirroring `workloads/WIDERFACE_train/timing_inference_latency.py`): sweep
# resolutions x precisions with end-to-end engines (device preprocess + net
# + decode + NMS, which the TRT numbers exclude) on the device LFD_DEVICE
# (default cuda, where each engine is one captured CUDA graph). Seeded
# random weights: the time does not depend on them.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.deploy import (Int8Calibrator, inference_latency_evaluation,  # noqa: E402
                                 make_device_preprocess, quantize_net_int8)

model_size = "XS"
precision_mode = "bf16"  # 'fp32' | 'bf16' | 'int8'
resolutions = ((480, 640), (720, 1280), (1080, 1920), (2160, 3840))
timing_loops = 50


def run(precision=None, sweep=None, loops=None):
    """The sweep with the settings above, or the ones given; returns
    inference_latency_evaluation's {(precision, (h, w)): timings}."""
    precision = precision or precision_mode
    det = zoo.widerface_lfd(model_size)
    det.init(torch.Generator().manual_seed(0))
    if precision == "int8":
        # int8 calibration (the reference builds an INT8Calibrator over real
        # crops; a random batch mirrors its fake-batch example), then
        # fake-quantized weights, as lfdtpu's script builds them
        calib = Int8Calibrator()
        calib.update(np.random.rand(8, 512, 512, 3).astype(np.float32))
        det.net = quantize_net_int8(det.net)
    preprocess = make_device_preprocess((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    return inference_latency_evaluation(
        det,
        resolutions=sweep or resolutions,
        precisions=(precision,),
        preprocess=preprocess,
        timing_loops=loops or timing_loops,
        device=os.environ.get("LFD_DEVICE", "cuda"),
    )


if __name__ == "__main__":
    run()
