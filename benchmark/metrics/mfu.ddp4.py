"""Reference forward+backward FLOPs of one card's share of each step over the
window's wall time, % of one card's bf16 peak."""

from benchmark.core import readers


def read(run):
    return readers.mfu_window(run, "step_ends")
