"""Closed loop through the pipelined stream: an offline video pass that
never waits for its source.

Traffic keys: depth (calls in flight), frame_hw (a frame's valid pixels),
pool (distinct frames, padded to the engine's size on the host beforehand),
keep_every (results kept for the check: every keep_every-th, a number with
no factor in common with pool, so that the kept results run through every
frame of the pool; a stride that divides the pool keeps the same few
frames over the whole window), sample, trace_after_frames,
trace_frames, frames (the frames' look: benchmark/core/weights.py frames).

The window submits frames through run_stream as fast as the stream takes
them, until `--seconds` have passed, then drains; every frame whose rows
reached the host counts, over the time from the first submit to the last
result.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..core import harness, system
from ..core.roofline import frame_bound_s
from ..core.trace import Segment

LIMITS = "serve"  # the configuration's limits this loop's check is held to


def setup(ctx):
    t, cfg = ctx.traffic, ctx.cfg
    if math.gcd(int(t["keep_every"]), int(t["pool"])) != 1:
        raise ValueError(f"keep_every {t['keep_every']} shares a factor with pool {t['pool']}: "
                         "the check would see only some of the pool's frames")
    hw = tuple(t["frame_hw"])
    pad = harness.padded_hw(cfg, hw)
    w = harness.draw_weights(ctx)
    ctx.mark("weights")
    det = harness.build_detector(ctx, w)
    eng = system.engine(det, cfg, pad, ctx.device)
    ctx.mark("engine")
    frames = harness.frame_pool(ctx, t["pool"], hw, pad_to=pad)
    vhw = np.asarray(hw, np.float32)
    order = ctx.rng(1).permutation(t["pool"])
    warm = [(frames[i % len(frames)][None], vhw) for i in range(2 * t["depth"])]
    for _ in system.stream(eng, iter(warm), t["depth"]):
        pass
    ctx.mark("frames_and_warm")
    ctx.sync()
    ctx.state.update(weights=w, engine=eng, frames=frames, hw=hw, pad=pad, vhw=vhw,
                     order=order)
    ctx.record["flops_per_call"] = harness.flops(cfg, (1, *pad, 3))
    ctx.record["kernel_bound_s"] = frame_bound_s(cfg, pad)


def window(ctx):
    t = ctx.traffic
    eng, frames, vhw, order = (ctx.state[k] for k in ("engine", "frames", "vhw", "order"))
    seg = None
    if ctx.trace and ctx.device != "cpu":
        start = int(t.get("trace_after_frames", 200))
        seg = Segment(start, start + t["trace_frames"])
        seg.open()
    submitted = []

    def requests():
        i = 0
        while time.perf_counter() < deadline:
            if seg:
                seg.before(i)
            fi = int(order[i % len(order)])
            submitted.append(time.perf_counter())
            yield frames[fi][None], vhw
            if seg:
                seg.after(i)
            i += 1

    done, results = [], {}
    stride = max(1, int(t["keep_every"]))
    offset = int(ctx.rng(7).integers(stride))
    t0 = time.perf_counter()
    ctx.setup_end = t0
    deadline = t0 + ctx.seconds
    for out in system.stream(eng, requests(), t["depth"]):
        if len(done) % stride == offset:  # only these results stay alive
            results[len(done)] = out
        done.append(time.perf_counter())
    if seg:
        seg.finish()
    ctx.record["submitted"] = [s - t0 for s in submitted]
    ctx.record["done"] = [d - t0 for d in done]
    ctx.record["segment"] = seg.read() if seg else None
    if seg and seg.close_s and seg.close_s > 0:  # the calls the profiler did not slow
        done_ = ctx.record["done"]
        ctx.record["unprofiled_from"] = next(
            (i for i, x in enumerate(done_) if x > seg.close_s - t0), len(done_))
    ctx.state["results"] = results


def after(ctx):
    ctx.state.pop("engine", None)
    if ctx.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(ctx):
    """The gaps of a sample, drawn from the seed, of the results kept
    (every keep_every-th, from a seeded offset)."""
    results, order = ctx.state["results"], ctx.state["order"]
    picked = harness.sample(ctx, sorted(results), ctx.traffic["sample"])
    served = [(i, int(order[i % len(order)]), system.rows_of(results[i])) for i in picked]
    return harness.check_served(ctx, ctx.state["weights"], served, ctx.state["frames"],
                                ctx.state["hw"], ctx.state["pad"])


def summary(ctx):
    sub, done = ctx.record["submitted"], ctx.record["done"]
    lat = (np.asarray(done) - np.asarray(sub[:len(done)])) * 1e3
    return {"frames": len(done), "latency_p50_ms": float(np.median(lat)) if len(lat) else None,
            "latency_p99_ms": float(np.percentile(lat, 99)) if len(lat) else None}


def counts(ctx):
    return len(ctx.record["submitted"]), len(ctx.record["submitted"]) - len(ctx.record["done"])
