"""K1-K3's bounds over their profiled time, in %."""

from benchmark.core import readers


def read(run):
    return readers.kernels_roofline(run)
