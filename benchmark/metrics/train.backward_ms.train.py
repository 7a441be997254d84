"""Median stream ms of the train step's backward: CUDA events around it on the
step's stream (span train.backward). Stream time, not device-busy time: where
the host falls behind the device inside the span, the device's idle time is
in it."""

from benchmark.core import spans


def read(run):
    return spans.span("train.backward", "stream_ms")
