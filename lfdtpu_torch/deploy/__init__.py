from .compile import (Engine, cast_variables, compile_inference,
                      make_device_preprocess, unpack_detections)
from .latency import inference_latency_evaluation, timing_inference

__all__ = [
    "Engine", "cast_variables", "compile_inference", "make_device_preprocess",
    "unpack_detections", "inference_latency_evaluation", "timing_inference",
]
