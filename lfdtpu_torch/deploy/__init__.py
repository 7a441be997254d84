from .compile import (Engine, cast_variables, compile_inference,
                      make_device_preprocess, unpack_detections)
from .int8_net import Int8Chain, calibrate_module_amax, int8_fused_apply
from .latency import inference_latency_evaluation, timing_inference
from .quantize import Int8Calibrator, quantize_net_int8

__all__ = [
    "Engine", "cast_variables", "compile_inference", "make_device_preprocess",
    "unpack_detections", "inference_latency_evaluation", "timing_inference",
    "Int8Chain", "Int8Calibrator", "calibrate_module_amax", "int8_fused_apply",
    "quantize_net_int8",
]
