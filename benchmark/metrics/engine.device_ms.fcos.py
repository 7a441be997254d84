"""Device-busy ms per served FCOS-R50-FPN frame, profiled segment."""

from benchmark.core import readers


def read(run):
    return readers.device_ms(run)
