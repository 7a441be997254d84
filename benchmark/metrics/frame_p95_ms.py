"""95th percentile of frame latency from the due time, all frames of the window."""

from benchmark.core import readers


def read(run):
    return readers.p95_ms(run)
