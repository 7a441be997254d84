"""Deformable-attention samples per traced predict call (counter
engine.msda_samples over spans predict); None on a program without it."""

from benchmark.core import spans


def read(run):
    return spans.per_call("engine.msda_samples", "predict")
