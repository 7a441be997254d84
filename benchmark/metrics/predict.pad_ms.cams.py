"""Median host ms of the predict API's padded batch: read, zero-fill, copy (span predict.pad)."""

from benchmark.core import spans


def read(run):
    return spans.span("predict.pad", "host_ms")
