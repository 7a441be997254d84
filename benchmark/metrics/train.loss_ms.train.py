"""Median stream ms of the train step's loss but its assignment: CUDA events
around it on the step's stream, less the assignment's (span train.loss, its
stream self time). Stream time, not device-busy time: where the host falls
behind the device inside the span, the device's idle time is in it."""

from benchmark.core import spans


def read(run):
    return spans.span("train.loss", "stream_self_ms")
