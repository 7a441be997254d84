"""Median stream ms of a served frame's graph replay: CUDA events around it on
the engine's stream (span engine.replay). One host call enqueues the whole
graph, so no host stall falls between the events."""

from benchmark.core import spans


def read(run):
    return spans.span("engine.replay", "stream_ms")
