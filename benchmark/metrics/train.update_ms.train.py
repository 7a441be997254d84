"""Median stream ms of the train step's frozen grads, clip, lr and SGD: CUDA
events around them on the step's stream (span train.update). Stream time, not
device-busy time: where the host falls behind the device inside the span, the
device's idle time is in it."""

from benchmark.core import spans


def read(run):
    return spans.span("train.update", "stream_ms")
