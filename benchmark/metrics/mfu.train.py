"""Reference forward+backward FLOPs of the steps over the window's wall time, % of bf16 peak."""

from benchmark.core import readers


def read(run):
    return readers.mfu_window(run, "step_ends")
