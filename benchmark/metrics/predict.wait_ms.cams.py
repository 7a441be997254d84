"""Median host ms of the predict call's copies to the host, a wait on the device (span predict.fetch)."""

from benchmark.core import spans


def read(run):
    return spans.span("predict.fetch", "host_ms")
