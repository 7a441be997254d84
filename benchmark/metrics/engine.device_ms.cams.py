"""Device-busy ms per served frame, profiled segment."""

from benchmark.core import readers


def read(run):
    return readers.device_ms(run)
