"""Device-busy ms per served Deformable DETR frame, profiled segment."""

from benchmark.core import readers


def read(run):
    return readers.device_ms(run)
