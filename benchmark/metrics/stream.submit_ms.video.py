"""Median host ms of a stream submit: the engine call and the copies' start (span stream.submit)."""

from benchmark.core import spans


def read(run):
    return spans.span("stream.submit", "host_ms")
