"""Open loop over the predict API for FCOS-R50-FPN: open_predict's cameras,
window, summary, counts and clean-up, with FCOS's own set-up and check.

Traffic keys: open_predict's. Set-up draws the seeded weights
(benchmark/core/fcos_weights.py), loads them into the port's zoo model (a
program without it fails there), builds the configuration's
captured engine at the frame size padded to 128, draws the frame pool and
warms the predict API. The check recomputes the sampled frames with the
plain reference (benchmark/reference/fcos.py) in float32 and in bfloat16,
as harness.check_served does for LFD.
"""

from __future__ import annotations

import torch

from ..core import compare, fcos_weights, harness, k5_roofline, programs, system
from ..reference import fcos
from .open_predict import LIMITS, after, counts, summary, window  # noqa: F401 (the loop's parts)


def padded_hw(cfg, hw):
    """A frame's size padded to a multiple of the largest stride, as the
    predict API pads it into the engine."""
    m = cfg["pad_to"]
    return tuple(-(-int(v) // m) * m for v in hw)


def setup(ctx):
    t, cfg = ctx.traffic, ctx.cfg
    hw = tuple(t["frame_hw"])
    pad = padded_hw(cfg, hw)
    w = fcos_weights.draw(cfg, ctx.seed, ctx.device, t.get("frames"))
    ctx.mark("weights")
    det = programs.fcos_detector(w)
    eng = system.engine(det, cfg, pad, ctx.device)
    ctx.mark("engine")
    frames = harness.frame_pool(ctx, t["pool"], hw)
    for i in range(3):  # the predict API's own first calls (pinned staging)
        system.predict(det, eng, frames[i % len(frames)])
    ctx.mark("frames_and_warm")
    ctx.sync()
    ctx.state.update(weights=w, det=det, engine=eng, frames=frames, hw=hw, pad=pad)
    ctx.record["flops_per_call"] = flops(cfg, (1, *pad, 3))
    ctx.record["k5_bound_s"] = k5_roofline.frame_bound_s(cfg, pad)


def flops(cfg, shape):
    """Convolution FLOPs of the reference's forward on `shape` (B, H, W, 3)
    frames, counted by FlopCounterMode on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    w = {n: torch.empty(s, device="meta", dtype=torch.long if k == "count" else torch.float32)
         for n, s, k in fcos.param_specs(cfg)}
    with FlopCounterMode(display=False) as fc:
        fcos.forward(w, cfg, torch.empty(shape, device="meta"))
    return fc.get_total_flops()


def padded_frame(ctx, frame, pad):
    """One frame zero-padded to `pad` on the device, (1, h, w, 3) uint8."""
    x = torch.zeros((1, *pad, 3), dtype=torch.uint8, device=ctx.device)
    x[0, :frame.shape[0], :frame.shape[1]] = torch.as_tensor(frame).to(ctx.device)
    return x


def rows_of(ctx, w, frame, pad, pool=0, **forward):
    """The reference's (rows, pool) on one frame (its valid extent the
    frame's own); `forward`: fcos.forward's dtype or quant."""
    info = fcos.level_info(ctx.cfg, pad, ctx.device)
    with torch.no_grad():
        c, r, m = fcos.forward(w, ctx.cfg, padded_frame(ctx, frame, pad), **forward)
        return fcos.decode(c[0], r[0], m[0], info, frame.shape[:2], ctx.cfg, pool=pool)


def reference_rows(ctx, w, frame, pad, pool_size=4000):
    """(final rows, candidate pool) of the float32 reference on one frame,
    and the rows of the reference computed in bfloat16 (weights and
    activations rounded, float32 accumulation)."""
    rows, pool = rows_of(ctx, w, frame, pad, pool_size)
    wb = {k: v.bfloat16() if v.is_floating_point() else v for k, v in w.items()}
    rounded, _ = rows_of(ctx, wb, frame, pad, dtype=torch.bfloat16)
    return rows, pool, compare.decoded_rows(rounded)


def check_served(ctx, served):
    """harness.check_served with FCOS's reference: served [(request index,
    pool index, rows)]; the bf16 reference's errors count once per served
    request, as the program's do."""
    harness.tf32_off()
    w, frames, (h, wd), pad = (ctx.state[k] for k in ("weights", "frames", "hw", "pad"))
    same = ctx.cfg["nms_threshold"]
    refs, program, rounded = {}, [], []
    for _, fi, rows in served:
        if fi not in refs:
            rows_, pool, r16 = reference_rows(ctx, w, frames[fi][:h, :wd], pad)
            refs[fi] = rows_, pool, compare.row_errors(r16, pool, rows_, same)
        program.append(compare.row_errors(rows, refs[fi][1], refs[fi][0], same))
        rounded.append(refs[fi][2])
    return compare.served_gaps(program, rounded) if program else None


def check(ctx):
    """The gaps of a sample of the window's frames, drawn from the seed
    before the window (a sampled frame that failed has no rows: the run
    is not correct anyway)."""
    sched, results = ctx.state["sched"], ctx.state["results"]
    return check_served(ctx, [(i, sched[i][2], results[i]) for i in sorted(results)])
