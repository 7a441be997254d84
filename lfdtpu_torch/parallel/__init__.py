# Training and evaluation steps, over one device or a mesh of one process
# per device (`lfdtpu/parallel/__init__.py`, less its GSPMD shardings: see
# mesh.py), and the image height split over a mesh's spatial axis
# (spatial.py). Names load lazily (PEP 562): the models import
# distributed.py's sums, and data_parallel.py imports the models.

import importlib

_EXPORTS = {
    "data_parallel": ("TrainState", "create_train_state", "make_train_step",
                      "make_eval_step", "sync_batchnorm"),
    "distributed": ("initialize_distributed", "process_info", "local_batch_slice",
                    "global_batch_from_local", "global_sum", "all_reduce_sum"),
    "mesh": ("Mesh", "make_mesh", "shard_batch", "spatial_image_rows"),
    "prefetch": ("BATCH_KEYS", "prefetch_to_device"),
    "spatial": ("SpatialNet", "spatial_parallel", "owned_rows", "out_height", "needed_rows",
                "kernel_window", "upsample_rows"),
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
