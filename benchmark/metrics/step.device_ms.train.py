"""Device-busy ms per train step, profiled segment."""

from benchmark.core import readers


def read(run):
    return readers.device_ms(run)
