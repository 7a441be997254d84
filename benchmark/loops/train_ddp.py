"""Closed loop over the data-parallel train step: one process a card, the
configuration's global batch split over the ranks, one step after another.

Traffic keys: world (ranks, one a card), and train's batches, boxes,
checked_steps and trace_steps.

Rank 0 is the runner's process. Its set-up starts ranks 1 .. world - 1 as
fresh processes (`python -m benchmark.loops.train_ddp RANK WORLD PORT SEED
DEVICE CELL`, from the checkout's root), and every rank joins the process
group (NCCL on the cards, gloo on the CPU, over tcp://127.0.0.1:PORT) and a
gloo group for the window's stop flag. Every rank then draws the same
seeded weights and global batches (train.batches), keeps its rows of each
(rank r: rows r*b .. (r+1)*b - 1, b = batch / world), builds the program's
step over the mesh (sync-BN, global loss normalizers, DDP's all-reduce) and
runs the first `checked_steps` steps. The window is train's: rank 0 times
its steps, and after each one broadcasts whether the window is over, so
that every rank ends it on the same step. After the window every rank
leaves the group at once, the other ranks exit and rank 0 waits for them.

The program's step over the mesh computes the one-card step on the global
batch, so the check is train's, against the unchanged reference
(benchmark/reference/train.py) on rank 0's global batches: the losses and
positives are the global batch's, rank 0's momentum buffers after step 1
give the global clipped gradient, its weights the change.
"""

from __future__ import annotations

import datetime
import json
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from ..core import harness, programs, system
from ..core.spec import ROOT
from ..core.trace import Segment
from . import train
from .train import LIMITS, check, counts, summary  # noqa: F401 (the loop's parts)

TIMEOUT_S = 300  # a collective or the group's start waits no longer for a rank


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(rank, device):
    """This rank's device: cuda:rank on the cards, the CPU elsewhere."""
    if device == "cpu":
        return "cpu"
    torch.cuda.set_device(rank)
    return f"cuda:{rank}"


def _join(ctx, rank, world, port):
    """This rank into the process group and the stop flag's gloo group."""
    backend = "gloo" if ctx.device == "cpu" else "nccl"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    ctx.state["flag_group"] = dist.new_group(backend="gloo") if backend != "gloo" \
        else dist.group.WORLD


def _prepare(ctx, rank, world):
    """Every rank: the weights, the step over the mesh, the global batches
    and this rank's rows of them, then the checked steps."""
    cfg, t = ctx.cfg, ctx.traffic
    w = harness.draw_weights(ctx)
    w0 = {k: v.clone() for k, v in w.items()}
    ctx.mark("weights")
    det = harness.build_detector(ctx, w)
    net, opt, step = programs.ddp_train_step(det, cfg, programs.mesh(ctx.device))
    ctx.mark("train_step")
    data = train.batches(ctx)
    b = cfg["train"]["batch"] // world
    local = [tuple(x[rank * b:(rank + 1) * b] for x in batch) for batch in data]
    ctx.mark("batches")
    wd = cfg["train"]["optimizer"]["weight_decay"]
    losses, positives = [], []
    for it in range(t["checked_steps"]):
        m = step(*local[it], system.learning_rate(cfg, it), True)
        losses.append(m["loss"])
        positives.append(m["num_pos"])
        if it == 0:
            p0 = {k: w0[k] for k in system.parameters(net)}
            grad1 = {k: v - wd * p0[k] for k, v in system.momentum_buffers(net, opt).items()}
    ctx.sync()
    ctx.mark("checked_steps")
    change = {k: v - w0[k] for k, v in system.parameters(net).items()}
    ctx.state.update(weights=w0, det=det, net=net, step=step, data=data, local=local,
                     prog=dict(losses=[float(x) for x in losses], grad=grad1, change=change,
                               positives=[float(x) for x in positives]))
    return b


def _over(ctx, stop):
    """Rank 0's word on whether the window is over, on every rank."""
    flag = torch.tensor([int(stop)])
    dist.broadcast(flag, 0, group=ctx.state["flag_group"])
    return bool(flag.item())


def setup(ctx):
    world = ctx.traffic["world"]
    port = _free_port()
    cell = json.dumps({"config": ctx.cfg, "traffic": ctx.traffic})
    ctx.state["ranks"] = [
        (subprocess.Popen([sys.executable, "-m", "benchmark.loops.train_ddp", str(r), str(world),
                           str(port), str(ctx.seed), ctx.device, cell], cwd=ROOT,
                          stdout=subprocess.DEVNULL, stderr=log), log)
        for r, log in ((r, tempfile.TemporaryFile()) for r in range(1, world))]
    ctx.device = _rank_device(0, ctx.device)
    _join(ctx, 0, world, port)
    ctx.mark("process_group")
    b = _prepare(ctx, 0, world)
    tr = ctx.cfg["train"]
    # one card's share of the global step: mfu is per card
    ctx.record["flops_per_call"] = harness.flops(ctx.cfg, (b, *tr["crop"], 3), backward=True)
    ctx.record["items_per_call"] = tr["batch"]


def window(ctx):
    t, cfg = ctx.traffic, ctx.cfg
    step, local = ctx.state["step"], ctx.state["local"]
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
        m = step(*local[it % len(local)], system.learning_rate(cfg, it), True)
        ctx.sync()
        ends.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        over = _over(ctx, ends[-1] >= ctx.seconds)
        if seg:
            seg.after(it)
        it += 1
        if over:
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
    """Every rank leaves the group at once (NCCL's shutdown waits for all of
    them), the other ranks exit and rank 0 waits for them; the program's
    state is freed."""
    dist.destroy_process_group()
    failed = []
    for proc, log in ctx.state.pop("ranks", []):
        try:
            rc = proc.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "none: killed"
        if rc != 0:
            log.seek(0)
            failed.append(f"exit {rc}: " + log.read()[-3000:].decode(errors="replace"))
        log.close()
    for k in ("det", "net", "step", "local"):
        ctx.state.pop(k, None)
    if ctx.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"a rank failed: {failed[0]}")


def _rank_main(argv):
    """Rank 1 .. world - 1: the set-up's steps and the window's, then out."""
    from benchmark.run import HOST_THREADS, environment

    rank, world, port, seed = (int(a) for a in argv[:4])
    environment()
    torch.set_num_threads(HOST_THREADS)
    cell = json.loads(argv[5])
    ctx = harness.Context(name="rank", cfg=cell["config"], traffic=cell["traffic"], seed=seed,
                          seconds=0.0, trace=False,
                          device=_rank_device(rank, argv[4]))
    _join(ctx, rank, world, port)
    _prepare(ctx, rank, world)
    step, local, cfg = ctx.state["step"], ctx.state["local"], ctx.cfg
    it = ctx.traffic["checked_steps"]
    while True:
        step(*local[it % len(local)], system.learning_rate(cfg, it), True)
        it += 1
        if _over(ctx, False):
            break
    ctx.sync()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
