"""What the metric readers under benchmark/metrics/ share. Each returns
None where the run holds nothing for it to read."""

from __future__ import annotations

import math

from .roofline import KERNEL_NAMES

BF16_PEAK = 989e12  # NVIDIA H100 SXM, dense bf16 on the tensor cores


def p95_ms(run):
    """95th percentile (nearest rank) of every frame's latency from its due
    time, over all frames due in the window; a failed frame reads inf."""
    calls = run.get("calls")
    if not calls:
        return None
    lat = sorted((c[2] - c[0]) if c[3] else math.inf for c in calls)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]


def predict_ms(run):
    """Mean host time of a predict call, over the window's frames that the
    profiler did not slow."""
    calls = [c for c in (run.get("calls") or [])[run.get("unprofiled_from", 0):] if c[3]]
    return 1e3 * sum(c[2] - c[1] for c in calls) / len(calls) if calls else None


def device_ms(run):
    """Device-busy ms per call (frame or step) in the profiled segment."""
    seg = run.get("segment")
    return 1e3 * seg["busy_s"] / seg["calls"] if seg and seg["calls"] else None


def idle_share(run):
    """% of the profiled window with nothing running on the device."""
    seg = run.get("segment")
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"]) if seg else None


def kernels_roofline(run):
    """% of roofline of K1-K3 together: their bounds for the calls in the
    segment over their profiled time."""
    seg, bounds = run.get("segment"), run.get("kernel_bound_s")
    if not seg or not bounds or not seg["calls"]:
        return None
    spent = bound = 0.0
    for name, keys in KERNEL_NAMES.items():
        t = sum(v for k, v in seg["ops"].items() if any(key in k for key in keys))
        if name in bounds and t > 0:
            spent += t
            bound += bounds[name] * seg["calls"]
    return 100.0 * bound / spent if spent > 0 else None


def mfu_predict(run):
    """% of the bf16 peak: the reference's FLOPs of the frames served over
    the summed predict-call wall time."""
    calls = [c for c in run.get("calls") or [] if c[3]]
    if not calls:
        return None
    busy = sum(c[2] - c[1] for c in calls)
    return 100.0 * run["flops_per_call"] * len(calls) / busy / BF16_PEAK


def mfu_window(run, done_key):
    """% of the bf16 peak: the reference's FLOPs of the calls done over
    the wall time they took, after the profiled segment where a run has one
    (the profiler slows the host)."""
    done = run.get(done_key)
    i0 = run.get("unprofiled_from", 0)
    if not done or len(done) <= i0 + 1:
        return None
    calls, seconds = (len(done) - i0, done[-1] - done[i0 - 1]) if i0 else (len(done), done[-1])
    return 100.0 * run["flops_per_call"] * calls / seconds / BF16_PEAK
