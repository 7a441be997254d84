"""One run of one cell: set-up, the measured window, the metrics, the check.

Order (the window is never disturbed by the check):
  set-up (weights, program, data, warm calls, FLOP count)  -> setup_s
  the window (--seconds; with --trace 1 a profiled segment inside it)
  the peak device memory read, the program's state freed
  the reference's check of what the window produced
  the metrics read from the run's record, the import guard
"""

from __future__ import annotations

import gc

import torch

from . import guard, harness, spec


def judge(loop, ctx, failed=0):
    """The loop's check of the run `ctx` held to the configuration's limits:
    (every number the check gave, {compared name: (value, limit)},
    correct)."""
    gaps = loop.check(ctx)
    limits = ctx.cfg["limits"][loop.LIMITS]
    compared = {k: (gaps[k] if gaps else float("inf"), limits[k]) for k in limits}
    correct = failed == 0 and all(v <= lim for v, lim in compared.values())
    return gaps or {}, compared, correct


def run_cell(name, seed, seconds, trace, t_start, device="cuda", cell=None):
    """Run cell `name` once; returns (result dict, summary dict, compared
    {name: (value, limit)}). `cell` overrides the parts read from the
    files (tests use small sizes, the readings the control)."""
    bench = spec.benchmark()
    cell = cell or spec.cell(name, bench)
    cfg, traffic = cell["config"], cell["traffic"]
    loop = spec.loop(traffic["loop"])
    ctx = harness.Context(name=name, cfg=cfg, traffic=traffic, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace), device=device,
                          t_start=t_start)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    loop.setup(ctx)
    # set-up's objects out of the collector's way: a full collection that
    # scans them would stall the window
    gc.collect()
    gc.freeze()
    loop.window(ctx)
    gc.unfreeze()
    ctx.record["setup_s"] = ctx.setup_end - t_start
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    attempted, failed = loop.counts(ctx)
    summary = loop.summary(ctx)
    loop.after(ctx)
    gaps, compared, correct = judge(loop, ctx, failed)
    summary["check"] = {k: v for k, v in gaps.items() if k not in compared}
    summary["setup_parts_s"] = ctx.parts

    metrics = {}
    for m in spec.metrics_of(name, trace, bench):
        value = spec.reader(m["name"]).read(ctx.record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    seg = ctx.record.get("segment")
    if trace and seg:
        from .trace import breakdown

        dev["busy_s"] = seg["busy_s"]
        dev["window_s"] = seg["window_s"]
        result["breakdown"] = breakdown(seg)
    summary["notes"] = ctx.notes[:5]
    found = guard.forbidden()
    if found:
        raise ImportError(f"modules of JAX or the JAX package are loaded: {found}")
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, summary, compared
