"""Median host ms of the predict API's rows from the decoded outputs (span predict.rows)."""

from benchmark.core import spans


def read(run):
    return spans.span("predict.rows", "host_ms")
