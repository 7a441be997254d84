"""Open loop over the predict API for Deformable DETR-R50: open_predict's
cameras, window, summary and counts, with the model's own set-up, check and
after-window measurement, as open_predict_fcos does for FCOS.

Traffic keys: open_predict's. Set-up draws the seeded weights
(benchmark/core/ddetr_weights.py), loads them into the port's zoo model (a
program without it fails there), builds the captured engine at the frame's
own size (mmdetection pads to a divisor of 1), draws the frame pool and
warms the predict API. After a --trace 1 window, one checked frame's 12
ms_deform_attn calls are recorded from an eager forward and replayed alone
as one CUDA graph (engine.msda_ms). The check recomputes the sampled frames
with the plain reference (benchmark/reference/deformable_detr.py) in
float32 and in bfloat16: a served row is matched in the pool of every
(query, class) box of the reference's last layer, and paired with its top
100 rows at the configuration's pairing IoU (compare.row_errors).
"""

from __future__ import annotations

import statistics

import torch

from ..core import compare, ddetr_program, ddetr_weights, harness, msda_roofline
from ..reference import deformable_detr as ddetr
from . import open_predict
from .open_predict import LIMITS, counts, summary, window  # noqa: F401 (the loop's parts)

MSDA_REPLAYS = 20


def setup(ctx):
    t, cfg = ctx.traffic, ctx.cfg
    hw = tuple(t["frame_hw"])
    w = ddetr_weights.draw(cfg, ctx.seed, ctx.device)
    ctx.mark("weights")
    det = ddetr_program.detector(w)
    eng = ddetr_program.engine(det, cfg, hw, ctx.device)
    ctx.mark("engine")
    frames = harness.frame_pool(ctx, t["pool"], hw)
    for i in range(3):  # the predict API's own first calls (pinned staging)
        det.predict_for_single_image_with_engine(eng, frames[i % len(frames)])
    ctx.mark("frames_and_warm")
    ctx.sync()
    ctx.state.update(weights=w, det=det, engine=eng, frames=frames, hw=hw, pad=hw)
    ctx.record["flops_per_call"] = flops(cfg, (1, *hw, 3))
    ctx.record["msda_bound_s"] = msda_roofline.frame_bound_s(cfg, hw)


def flops(cfg, shape):
    """Convolution and matmul FLOPs of the reference's forward on `shape`
    (B, H, W, 3) frames, counted by FlopCounterMode on the meta device (the
    deformable sampling's gathers count none)."""
    from torch.utils.flop_counter import FlopCounterMode

    w = {n: torch.empty(s, device="meta", dtype=torch.long if k == "count" else torch.float32)
         for n, s, k in ddetr.param_specs(cfg)}
    with FlopCounterMode(display=False) as fc:
        ddetr.forward(w, cfg, torch.empty(shape, device="meta"))
    return fc.get_total_flops()


def msda_ms(ctx, frame):
    """The median ms of one frame's ms_deform_attn calls, on their own
    inputs from an eager forward of the engine's program, replayed as one
    CUDA graph (CUDA events)."""
    eng = ctx.state["engine"]
    x = torch.zeros((1, *eng.input_resolution, 3), dtype=torch.uint8, device=ctx.device)
    x[0, :frame.shape[0], :frame.shape[1]] = torch.as_tensor(frame).to(ctx.device)
    vhw = torch.tensor([frame.shape[:2]], dtype=torch.float32, device=ctx.device)
    fn, calls = ddetr_program.msda_calls(eng, x, vhw)
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for args in calls:
                fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for args in calls:
                fn(*args)
        times = []
        for _ in range(MSDA_REPLAYS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def after(ctx):
    """After a traced window on the card, engine.msda_ms on the first
    checked frame; then open_predict's clean-up."""
    results = ctx.state.get("results")
    if ctx.trace and ctx.device != "cpu" and results:
        fi = ctx.state["sched"][min(results)][2]
        ctx.record["msda_ms"] = msda_ms(ctx, ctx.state["frames"][fi])
    open_predict.after(ctx)


def rows_of(ctx, w, frame, pool=True, **forward):
    """The reference's (rows, pool) on one frame; `forward`:
    deformable_detr.forward's dtype, quant, sample or refine."""
    x = torch.as_tensor(frame).to(ctx.device)[None]
    with torch.no_grad():
        cls, boxes, _ = ddetr.forward(w, ctx.cfg, x, **forward)
    return ddetr.decode(cls[0], boxes[0], frame.shape[:2], ctx.cfg, pool=pool)


def reference_rows(ctx, w, frame):
    """(final rows, pool) of the float32 reference on one frame, and the
    rows of the reference computed in bfloat16."""
    rows, pool = rows_of(ctx, w, frame)
    wb = {k: v.bfloat16() if v.is_floating_point() else v for k, v in w.items()}
    rounded, _ = rows_of(ctx, wb, frame, pool=False, dtype=torch.bfloat16)
    return rows, pool, compare.decoded_rows(rounded)


def check_served(ctx, served):
    """served [(request index, pool index, rows)]: the reference once per
    distinct frame; the bf16 reference's errors count once per served
    request, as the program's do."""
    harness.tf32_off()
    w, frames, (h, wd) = (ctx.state[k] for k in ("weights", "frames", "hw"))
    same = ctx.cfg["nms_threshold"]
    refs, program, rounded = {}, [], []
    for _, fi, rows in served:
        if fi not in refs:
            rows_, pool, r16 = reference_rows(ctx, w, frames[fi][:h, :wd])
            refs[fi] = rows_, pool, compare.row_errors(r16, pool, rows_, same)
        program.append(compare.row_errors(rows, refs[fi][1], refs[fi][0], same))
        rounded.append(refs[fi][2])
    return compare.served_gaps(program, rounded) if program else None


def check(ctx):
    """The gaps of a sample of the window's frames, drawn from the seed
    before the window."""
    sched, results = ctx.state["sched"], ctx.state["results"]
    return check_served(ctx, [(i, sched[i][2], results[i]) for i in sorted(results)])
