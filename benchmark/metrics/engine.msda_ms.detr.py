"""Median ms of one frame's 12 ms_deform_attn calls replayed alone as one
CUDA graph, on that frame's own inputs, after the window (CUDA events)."""


def read(run):
    return run.get("msda_ms")
