"""Reference FLOPs of the streamed frames over the window's wall time, % of bf16 peak."""

from benchmark.core import readers


def read(run):
    return readers.mfu_window(run, "done")
