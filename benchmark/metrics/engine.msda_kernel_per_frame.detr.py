"""K7 launches per traced predict call (counter engine.msda_kernel over
spans predict): 12 a Deformable DETR frame where ms_deform_attn runs the
hand-written kernel; None on a program without the counter."""

from benchmark.core import spans


def read(run):
    return spans.per_call("engine.msda_kernel", "predict")
