"""What every loop shares: the run's context, the seeded weights and data,
the reference's FLOP count and the served-rows check."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from ..reference import lfd
from . import compare, system, weights


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    name: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0           # the process's start on the host clock
    setup_end: float = 0.0         # the first timed call's start
    record: dict = dataclasses.field(default_factory=dict)  # what metric readers read
    state: dict = dataclasses.field(default_factory=dict)   # the loop's own
    notes: list = dataclasses.field(default_factory=list)   # earlier lines of the result
    parts: dict = dataclasses.field(default_factory=dict)   # set-up's stages, seconds

    def mark(self, name):
        """Close set-up stage `name` (seconds since the process started)."""
        self.parts[name] = round(time.perf_counter() - self.t_start, 3)

    def rng(self, stream=0):
        """numpy Generator for the seed (any size of seed), per use `stream`."""
        return np.random.default_rng([int(self.seed) % 2 ** 64, stream])

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()


def padded_hw(cfg, hw):
    """A frame's size padded to a multiple of the largest stride, as the
    predict API pads it into the engine."""
    m = max(lfd.strides(cfg))
    return tuple(-(-int(v) // m) * m for v in hw)


def draw_weights(ctx):
    specs = lfd.param_specs(ctx.cfg)
    return weights.draw(specs, ctx.seed, ctx.device, dict(ctx.cfg["weights"], _config=ctx.cfg),
                        ctx.traffic.get("frames"))


def build_detector(ctx, w):
    return system.detector(ctx.cfg, w, lambda n: lfd.shared_names(ctx.cfg, n))


def frame_pool(ctx, n, hw, pad_to=None):
    """n distinct uint8 frames (n, h, w, 3) of the traffic's `frames` look
    (weights.frames) drawn on the device from the seed, on the host as
    numpy; with pad_to, zero-padded to that size."""
    g = weights.generator(ctx.seed + 1, ctx.device)
    frames = weights.frames(g, n, hw, ctx.device, ctx.traffic.get("frames"))
    if pad_to is not None and tuple(pad_to) != tuple(hw):
        out = torch.zeros((n, *pad_to, 3), dtype=torch.uint8, device=ctx.device)
        out[:, :hw[0], :hw[1]] = frames
        frames = out
    return frames.cpu().numpy()


def flops(cfg, shape, backward=False):
    """Convolution and matmul FLOPs of the reference's forward (and
    backward, with respect to the weights and activations) on `shape`
    (B, H, W, 3) frames, counted by FlopCounterMode on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    specs = lfd.param_specs(cfg)
    w = {n: torch.empty(s, device="meta", dtype=torch.long if k == "count" else torch.float32,
                        requires_grad=backward and k not in
                        ("count", "running_mean", "running_var"))
         for n, s, k in specs}
    x = torch.empty(shape, device="meta")
    with FlopCounterMode(display=False) as fc:
        c, r = lfd.forward(w, cfg, x, train=backward)
        if backward:
            (c.sum() + r.sum()).backward()
    return fc.get_total_flops()


def tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sample(ctx, finished, k):
    """k of the finished requests' indices, drawn from the seed (all when
    fewer)."""
    if len(finished) <= k:
        return list(finished)
    return sorted(ctx.rng(7).choice(finished, size=k, replace=False).tolist())


def reference_rows(ctx, w, frame, pad, pool_size=4000):
    """(final rows, candidate pool) of the float32 reference on one frame
    (zero-padded to `pad` as the program pads it, its valid extent the
    frame's own), and the rows of the reference computed in bfloat16."""
    x = torch.zeros((1, *pad, 3), dtype=torch.uint8, device=ctx.device)
    x[0, :frame.shape[0], :frame.shape[1]] = torch.as_tensor(frame).to(ctx.device)
    info = lfd.level_info(ctx.cfg, pad, ctx.device)
    with torch.no_grad():
        c, r = lfd.forward(w, ctx.cfg, x)
        rows, pool = lfd.decode(c[0], r[0], info, frame.shape[:2], ctx.cfg, pool=pool_size)
        wb = {k: v.bfloat16() if v.is_floating_point() else v for k, v in w.items()}
        c, r = lfd.forward(wb, ctx.cfg, x, dtype=torch.bfloat16)
        rounded, _ = lfd.decode(c[0], r[0], info, frame.shape[:2], ctx.cfg, pool=0)
    return rows, pool, compare.decoded_rows(rounded)


def check_served(ctx, w, served, frames, valid_hw, pad):
    """served: [(request index, pool index, rows)] of the sampled requests;
    frames[pool index] holds the frame's valid_hw pixels. Runs the reference
    once per distinct frame; the bf16 reference's errors count once per
    served request, as the program's do, so that a frame served twice
    weighs the same on both sides. Returns compare.served_gaps' numbers."""
    tf32_off()
    same = ctx.cfg["nms_threshold"]
    refs, program, rounded = {}, [], []
    for _, fi, rows in served:
        if fi not in refs:
            rows_, pool, r16 = reference_rows(ctx, w, frames[fi][:valid_hw[0], :valid_hw[1]],
                                              pad)
            refs[fi] = rows_, pool, compare.row_errors(r16, pool, rows_, same)
        program.append(compare.row_errors(rows, refs[fi][1], refs[fi][0], same))
        rounded.append(refs[fi][2])
    return compare.served_gaps(program, rounded) if program else None


def span(name, on):
    """A named host range in the profile of a traced segment, else nothing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()
