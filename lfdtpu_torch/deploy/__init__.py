# The deployment layer: compiled engines, the int8 chain, engine files,
# streaming and resolution buckets. Names load lazily (PEP 562), so that
# importing one module, deploy.engine_io in a process that serves an engine
# file, does not import the others and the model code they need.

import importlib

_EXPORTS = {
    "compile": ("Engine", "cast_variables", "compile_inference", "make_device_preprocess",
                "unpack_detections"),
    "int8_net": ("Int8Chain", "calibrate_module_amax", "int8_fused_apply"),
    "latency": ("inference_latency_evaluation", "timing_inference"),
    "quantize": ("Int8Calibrator", "quantize_net_int8"),
    "engine_io": ("save_engine", "load_engine", "predict_padded"),
    "buckets": ("BucketedEngineSet",),
    "serving": ("run_stream", "StreamingServer"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_MODULE_OF[name]}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
