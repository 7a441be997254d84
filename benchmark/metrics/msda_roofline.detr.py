"""MSDA's bound (value map read once, 12 bytes a sample, output written once)
over engine.msda_ms, in %."""

from benchmark.core import msda_roofline


def read(run):
    return msda_roofline.share(run)
