"""Median host ms of the engine's staging: slot, pinned copy, H2D enqueue (span engine.stage)."""

from benchmark.core import spans


def read(run):
    return spans.span("engine.stage", "host_ms")
