"""Bytes the host wrote into the engine's pinned slot per traced predict call, the frame's and the stale pad zeroed (counter engine.stage_bytes over spans predict)."""

from benchmark.core import spans


def read(run):
    return spans.per_call("engine.stage_bytes", "predict")
