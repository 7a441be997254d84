"""% of the profiled window with the device idle."""

from benchmark.core import readers


def read(run):
    return readers.idle_share(run)
