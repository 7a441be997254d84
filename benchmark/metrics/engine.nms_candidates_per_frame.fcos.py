"""Valid candidates that entered the engine's NMS (K1) per traced predict call
(counter engine.nms_candidates over spans predict); None on a program
without the counter."""

from benchmark.core import spans


def read(run):
    return spans.per_call("engine.nms_candidates", "predict")
