"""Reference FLOPs of the served frames over the summed predict wall time, % of bf16 peak."""

from benchmark.core import readers


def read(run):
    return readers.mfu_predict(run)
