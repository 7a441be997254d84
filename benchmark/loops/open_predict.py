"""Open loop over the predict API: cameras that send frames on their own
clocks, whatever the server does.

Traffic keys: streams, rate_per_s (the total), frame_hw, pool (distinct
frames), jitter (each frame's due time moves by up to this share of its
stream's period), clock_skew (each stream's clock runs fast or slow by one of
these shares, assigned to the streams in a seeded order, so that the streams'
phases slide through every alignment in a window whatever the seed), sample
(served frames checked against the reference), trace_frames (frames in the
profiled segment of a --trace 1 run), frames (the frames' look:
benchmark/core/weights.py frames).

Each frame is due at its stream's phase (drawn from the seed) plus k
periods plus its jitter. One host thread serves the frames in order of due
time: it waits for a frame that is not yet due, and starts one that is at
once. A frame's latency runs from its due time to its rows on the host, so
it counts the wait behind earlier frames. A frame whose call fails misses.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import harness, system
from ..core.roofline import frame_bound_s
from ..core.trace import Segment

LIMITS = "serve"  # the configuration's limits this loop's check is held to


def schedule(traffic, seed_rng, seconds):
    """[(due seconds, stream, pool index)] of the frames due in the window,
    by due time."""
    n = traffic["streams"]
    skew = np.asarray(traffic["clock_skew"], float)
    order = seed_rng.permutation(n) % len(skew)
    rows = []
    for i in range(n):
        period = n / traffic["rate_per_s"] / (1.0 + skew[order[i]])
        jit = traffic["jitter"] * period
        phase = seed_rng.uniform(jit, period + jit)
        k = np.arange(int((seconds - phase) / period) + 2)
        due = phase + k * period + seed_rng.uniform(-jit, jit, len(k))
        first = seed_rng.integers(traffic["pool"])
        for kk, d in zip(k, due):
            if d < seconds:
                rows.append((float(d), i, int((first + kk) % traffic["pool"])))
    rows.sort()
    return rows


def setup(ctx):
    t, cfg = ctx.traffic, ctx.cfg
    hw = tuple(t["frame_hw"])
    pad = harness.padded_hw(cfg, hw)
    w = harness.draw_weights(ctx)
    ctx.mark("weights")
    det = harness.build_detector(ctx, w)
    eng = system.engine(det, cfg, pad, ctx.device)
    ctx.mark("engine")
    frames = harness.frame_pool(ctx, t["pool"], hw)
    for i in range(3):  # the predict API's own first calls (pinned staging)
        system.predict(det, eng, frames[i % len(frames)])
    ctx.mark("frames_and_warm")
    ctx.sync()
    ctx.state.update(weights=w, det=det, engine=eng, frames=frames, hw=hw, pad=pad)
    ctx.record["flops_per_call"] = harness.flops(cfg, (1, *pad, 3))
    ctx.record["kernel_bound_s"] = frame_bound_s(cfg, pad)


def _wait_until(t):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 0.002:
            time.sleep(left - 0.001)


def window(ctx):
    t = ctx.traffic
    sched = schedule(t, ctx.rng(1), ctx.seconds)
    det, eng, frames = ctx.state["det"], ctx.state["engine"], ctx.state["frames"]
    seg = None
    if ctx.trace and ctx.device != "cpu":
        mid = len(sched) // 2
        seg = Segment(max(3, mid - t["trace_frames"] // 2),
                      min(len(sched), mid + t["trace_frames"] // 2))
        seg.open()
    calls, results = [], {}
    keep = set(harness.sample(ctx, list(range(len(sched))), t["sample"]))
    t0 = time.perf_counter() + 0.01
    ctx.setup_end = t0
    prev_end = 0.0
    for i, (due, stream, fi) in enumerate(sched):
        if seg:
            seg.before(i)
        with harness.span("wait_for_frame_due", seg):
            _wait_until(t0 + due)
        start = time.perf_counter() - t0
        try:
            with harness.span("predict_call", seg):
                rows = system.predict(det, eng, frames[fi])
            ok = True
            if i in keep:  # only the checked frames' rows stay alive
                results[i] = rows
        except Exception as e:  # a failed frame misses
            ok = False
            ctx.notes.append(f"frame {i} failed: {e!r}"[:300])
        end = time.perf_counter() - t0
        calls.append((due, start, end, ok, max(0.0, start - max(due, prev_end))))
        prev_end = end
        if seg:
            seg.after(i)
    if seg:
        seg.finish()
    ctx.record["calls"] = calls
    # the profiler, on from the window's start to the segment's end, slows
    # the host: predict.ms reads the calls after it
    ctx.record["unprofiled_from"] = seg.stop if seg else 0
    ctx.record["segment"] = seg.read() if seg else None
    ctx.state["results"] = results
    ctx.state["sched"] = sched


def after(ctx):
    """Nothing more to measure: free the program's state."""
    for k in ("engine", "det"):
        ctx.state.pop(k, None)
    if ctx.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(ctx):
    """The gaps of a sample of the window's frames, drawn from the seed
    before the window (a sampled frame that failed has no rows: the run
    is not correct anyway)."""
    sched, results = ctx.state["sched"], ctx.state["results"]
    served = [(i, sched[i][2], results[i]) for i in sorted(results)]
    return harness.check_served(ctx, ctx.state["weights"], served, ctx.state["frames"],
                                ctx.state["hw"], ctx.state["pad"])


def summary(ctx):
    """The earlier result line: counts, median latency and generator lag."""
    calls = ctx.record["calls"]
    lat = np.array([c[2] - c[0] for c in calls if c[3]]) * 1e3
    lag = np.array([c[4] for c in calls]) * 1e3
    service = np.array([c[2] - c[1] for c in calls if c[3]]) * 1e3
    return {"frames": len(calls), "failed": sum(not c[3] for c in calls),
            "service_p50_ms": float(np.median(service)) if len(service) else None,
            "service_p99_ms": float(np.percentile(service, 99)) if len(service) else None,
            "latency_p50_ms": float(np.median(lat)) if len(lat) else None,
            "latency_max_ms": float(lat.max()) if len(lat) else None,
            "generator_lag_p50_ms": float(np.median(lag)) if len(lag) else None,
            "generator_lag_max_ms": float(lag.max()) if len(lag) else None,
            "offered_per_s": len(calls) / ctx.seconds}


def counts(ctx):
    calls = ctx.record["calls"]
    return len(calls), sum(not c[3] for c in calls)
