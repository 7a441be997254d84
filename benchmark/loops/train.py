"""Closed loop over the train step: batches resident on the device, one
step after another.

Traffic keys: batches (distinct seeded batches, rotated), boxes (the ground
truth's draw: max per image, empty_share of images with none, sides
log-uniform from min_side to max_side px (capped at 0.8 of the crop),
aspect range), checked_steps (the first steps the reference follows),
trace_steps, assign_calls.

Set-up builds the step with its net and optimizer state and drives it from
the seed through its first `checked_steps` steps, on the first batches,
through the window's own call; the window then goes on with the same
objects. After step 1 the optimizer's momentum buffers give the clipped
gradient as the optimizer got it (buffer - weight_decay * weights), and
after the last checked step the weights give the change; the reference
follows the same steps from the same weights and batches once the window
has closed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import compare, harness, system
from ..core.trace import Segment
from ..reference import train as ref_train

LIMITS = "train"  # the configuration's limits this loop's check is held to


def ground_truth(rng, n, hw, nmax, num_classes, spec):
    """(gt xywh (n, nmax, 4), labels (n, nmax), mask (n, nmax)) numpy."""
    gt = np.zeros((n, nmax, 4), np.float32)
    labels = np.zeros((n, nmax), np.int64)
    mask = np.zeros((n, nmax), bool)
    top = min(spec["max_side"], 0.8 * min(hw))
    for i in range(n):
        k = 0 if rng.random() < spec["empty_share"] else int(rng.integers(1, spec["max"] + 1))
        k = min(k, nmax)
        side = np.exp(rng.uniform(np.log(spec["min_side"]), np.log(top), k))
        aspect = rng.uniform(*spec["aspect"], k)
        w = np.minimum(side * aspect, hw[1])
        h = np.minimum(side / aspect, hw[0])
        x = rng.uniform(0, 1, k) * (hw[1] - w)
        y = rng.uniform(0, 1, k) * (hw[0] - h)
        gt[i, :k] = np.stack([x, y, w, h], -1)
        mask[i, :k] = True
        labels[i, :k] = rng.integers(0, num_classes, k)
    return gt, labels, mask


def batches(ctx):
    t, tr = ctx.traffic, ctx.cfg["train"]
    hw, b = tuple(tr["crop"]), tr["batch"]
    g = torch.Generator(device=ctx.device).manual_seed((int(ctx.seed) + 2) % 2 ** 63)
    frames = torch.randint(0, 256, (t["batches"], b, *hw, 3), generator=g, device=ctx.device,
                           dtype=torch.uint8)
    rng = ctx.rng(3)
    out = []
    for k in range(t["batches"]):
        gt, labels, mask = ground_truth(rng, b, hw, tr["nmax"], ctx.cfg["num_classes"], t["boxes"])
        out.append((frames[k], torch.as_tensor(gt, device=ctx.device),
                    torch.as_tensor(labels, device=ctx.device),
                    torch.as_tensor(mask, device=ctx.device)))
    return out


def setup(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    w = harness.draw_weights(ctx)
    w0 = {k: v.clone() for k, v in w.items()}
    ctx.mark("weights")
    det = harness.build_detector(ctx, w)
    net, opt, step = system.train_step(det, cfg, ctx.device)
    ctx.mark("train_step")
    data = batches(ctx)
    ctx.mark("batches")
    wd = cfg["train"]["optimizer"]["weight_decay"]
    losses, positives = [], []
    for it in range(t["checked_steps"]):
        m = step(*data[it], system.learning_rate(cfg, it), True)
        losses.append(m["loss"])
        positives.append(m["num_pos"])
        if it == 0:
            p0 = {k: w0[k] for k in system.parameters(net)}
            grad1 = {k: b - wd * p0[k] for k, b in system.momentum_buffers(net, opt).items()}
    ctx.sync()
    ctx.mark("checked_steps")
    change = {k: v - w0[k] for k, v in system.parameters(net).items()}
    ctx.state.update(weights=w0, det=det, net=net, step=step, data=data,
                     prog=dict(losses=[float(x) for x in losses], grad=grad1, change=change,
                               positives=[float(x) for x in positives]))
    tr = cfg["train"]
    ctx.record["flops_per_call"] = harness.flops(cfg, (tr["batch"], *tr["crop"], 3),
                                                 backward=True)
    ctx.record["items_per_call"] = tr["batch"]


def window(ctx):
    t = ctx.traffic
    step, data, cfg = ctx.state["step"], ctx.state["data"], ctx.cfg
    first = t["checked_steps"]
    seg = Segment(first + 3, first + 3 + t["trace_steps"]) if (
        ctx.trace and ctx.device != "cpu") else None
    if seg:
        seg.open()
    ends, losses = [], []
    t0 = time.perf_counter()
    ctx.setup_end = t0
    it = first
    while True:
        if seg:
            seg.before(it)
        m = step(*data[it % len(data)], system.learning_rate(cfg, it), True)
        ctx.sync()
        ends.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        if seg:
            seg.after(it)
        it += 1
        if ends[-1] >= ctx.seconds:
            break
    if seg:
        seg.finish()
    finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
    ctx.record["step_ends"] = ends
    ctx.record["step_ok"] = finite.tolist()
    ctx.record["segment"] = seg.read() if seg else None
    if seg and seg.close_s and seg.close_s > 0:  # the calls the profiler did not slow
        ctx.record["unprofiled_from"] = next(
            (i for i, x in enumerate(ends) if x > seg.close_s - t0), len(ends))


def after(ctx):
    """With --trace 1, the port's target assignment alone on the cell's
    batches (CUDA events); then the program's state is freed."""
    if ctx.trace and ctx.device != "cpu":
        assign = system.assignment(ctx.state["det"], ctx.cfg, ctx.device)
        data = ctx.state["data"]
        for b in data[:1]:
            assign(*b[1:])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        n = ctx.traffic["assign_calls"]
        start.record()
        for k in range(n):
            assign(*data[k % len(data)][1:])
        end.record()
        torch.cuda.synchronize()
        ctx.record["assign_ms"] = start.elapsed_time(end) / n
    for k in ("det", "net", "step"):
        ctx.state.pop(k, None)
    if ctx.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(ctx):
    """The reference's first steps from the same weights and batches, and
    its first step under bf16 autocast (grad_angle_gap's yardstick)."""
    harness.tf32_off()
    n = ctx.traffic["checked_steps"]
    batches_ = [(f, g, l, m) for f, g, l, m in ctx.state["data"][:n]]
    losses, grad, w, positives = ref_train.steps(ctx.state["weights"], ctx.cfg, batches_)
    change = {k: w[k] - ctx.state["weights"][k] for k in grad}
    rounded = ref_train.steps(ctx.state["weights"], ctx.cfg, batches_[:1], bf16=True)[1]
    p = ctx.state["prog"]
    gaps = compare.train_gaps(p["losses"], losses, p["grad"], grad, p["change"], change,
                              rounded)
    gaps["positives_gap"] = max(abs(a - b) / max(b, 1.0)
                                for a, b in zip(p["positives"], positives))
    return gaps


def summary(ctx):
    ends = ctx.record["step_ends"]
    return {"steps": len(ends), "step_ms_mean": 1e3 * ends[-1] / len(ends),
            "nonfinite_steps": sum(not ok for ok in ctx.record["step_ok"])}


def counts(ctx):
    ok = ctx.record["step_ok"]
    return len(ok), sum(not x for x in ok)
