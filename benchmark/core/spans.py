"""The program's own spans and counters (lfdtpu_torch/tracing.py), read
after a traced run: with system.py the second module of the harness that
imports the program, and for them only.

The program records them exactly while the profiler of a --trace 1 run
records (benchmark/core/trace.py's Segment), in the calls the benchmark
makes into it; each value is the median, over the calls traced, of a
span's time in one call (tracing.summary()). A program without the module,
or a run that traced no such span, gives None.
"""

from __future__ import annotations

import importlib


def summary():
    """lfdtpu_torch.tracing.summary(), or None where the program has no
    tracing module."""
    try:
        tracing = importlib.import_module("lfdtpu_torch.tracing")
    except ModuleNotFoundError as e:
        if e.name != "lfdtpu_torch.tracing":  # the module is there, and fails
            raise
        return None
    return tracing.summary()


def span(name, key):
    """Span `name`'s median `key` (host_ms, self_ms, stream_ms or
    stream_self_ms) over the traced calls, or None."""
    entry = ((summary() or {}).get("spans") or {}).get(name)
    return entry.get(key) if entry else None


def per_call(counter, name):
    """Counter `counter` over the number of spans `name`, or None."""
    s = summary() or {}
    calls = ((s.get("spans") or {}).get(name) or {}).get("calls")
    total = (s.get("counters") or {}).get(counter)
    return total / calls if calls and total is not None else None
