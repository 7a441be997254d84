"""K5's bound (the map read twice, written once) over its profiled time, in %."""

from benchmark.core import k5_roofline


def read(run):
    return k5_roofline.share(run)
