"""K6 launches per traced train step (counter train.assign_kernel over spans
train.step): 1 where the step's LFD assignment runs the hand-written kernel."""

from benchmark.core import spans


def read(run):
    return spans.per_call("train.assign_kernel", "train.step")
