"""Rows the predict API returned per traced call (counter predict.rows over spans predict)."""

from benchmark.core import spans


def read(run):
    return spans.per_call("predict.rows", "predict")
