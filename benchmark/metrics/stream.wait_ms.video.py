"""Median host ms of a stream fetch: waiting for the result, then numpy (span stream.fetch)."""

from benchmark.core import spans


def read(run):
    return spans.span("stream.fetch", "host_ms")
