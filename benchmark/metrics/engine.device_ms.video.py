"""Device-busy ms per streamed frame, profiled segment."""

from benchmark.core import readers


def read(run):
    return readers.device_ms(run)
