"""K5 launches per traced predict call (counter engine.gn_kernel over spans predict)."""

from benchmark.core import spans


def read(run):
    return spans.per_call("engine.gn_kernel", "predict")
