from .compile import (Engine, cast_variables, compile_inference,
                      make_device_preprocess, unpack_detections)

__all__ = [
    "Engine", "cast_variables", "compile_inference", "make_device_preprocess",
    "unpack_detections",
]
