"""The Deformable DETR cell's readings on the card: the knee of its open
loop, and the numbers its check's limits are set from.

    python3 -m benchmark.tools.ddetr_tools --workload ddetr-r50-cams-800 \
        --variant sweep|program|control|nearest|no_refine|bf16_locations \
        --seeds 1,2,3 [--seconds 3] [--rates 40,50]

sweep: benchmark/tools/sweep.py with this cell's set-up (the first seed):
  the mean service time of back-to-back predict calls, then per rate
  (default: 0.7-1.05 of the closed-loop rate) frames, p50 and p95 latency
  from the due time, and the mean latency of the window's last tenth of
  frames against its first tenth.
program: the cell as it runs, a short window at its own load; one line of
  numbers per seed.
control: the reference computed in fp8 (each conv's and Linear's input and
  weight rounded to e4m3 under its own scale, compare.fp8) in the
  program's place: its rows of `sample` frames of the seed's pool, judged by
  the cell's check and limits.
nearest, no_refine, bf16_locations: the cell with a fault planted in the
  program (FAULTS): nearest-neighbour sampling in place of bilinear (each
  location moved to its pixel's centre), the decoder's reference boxes
  frozen at the proposals, the sampling locations rounded to bf16.
All seeds run in this one process.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.core import ddetr_program  # noqa: E402


def _level_sizes(shapes, like):
    """(L, 2) [w, h] of the levels, made on the device (a capture copies
    nothing from the host)."""
    return torch.stack([torch.stack([like.new_full((), float(w)), like.new_full((), float(h))])
                        for h, w in shapes])


def _wrap_sampling(setattr_, move):
    """ms_deform_attn with its locations passed through move(locations,
    spatial_shapes) first."""
    mod = ddetr_program.msda_ops()
    real = mod.ms_deform_attn

    def fn(value, shapes, starts, loc, weights):
        return real(value, shapes, starts, move(loc, shapes), weights)

    setattr_(mod, "ms_deform_attn", fn)


def nearest(setattr_):
    """Nearest-neighbour sampling: each location moved to the centre of the
    pixel it falls in, where the bilinear read is that pixel's value."""
    def move(loc, shapes):
        wh = _level_sizes(shapes, loc)[None, None, None, :, None, :]
        return (torch.floor(loc * wh) + 0.5) / wh
    _wrap_sampling(setattr_, move)


def bf16_locations(setattr_):
    """The sampling locations rounded to bfloat16."""
    _wrap_sampling(setattr_, lambda loc, shapes: loc.bfloat16().float())


def no_refine(setattr_):
    """A decoder whose reference boxes stay at the proposals."""
    setattr_(ddetr_program.net_class(), "_refine", lambda self, i, q, ref: ref)


FAULTS = {"nearest": nearest, "no_refine": no_refine, "bf16_locations": bf16_locations}


def control(ctx):
    """(every number, {compared: (value, limit)}, correct) of the fp8
    reference's rows on `sample` frames of the seed's pool in the
    program's place."""
    from benchmark.core import compare, ddetr_weights, harness
    from benchmark.loops import open_predict_ddetr as loop

    t, cfg = ctx.traffic, ctx.cfg
    hw = tuple(t["frame_hw"])
    w = ddetr_weights.draw(cfg, ctx.seed, ctx.device)
    frames = harness.frame_pool(ctx, t["pool"], hw)
    ctx.state.update(weights=w, frames=frames, hw=hw)
    harness.tf32_off()
    picks = sorted(ctx.rng(7).choice(len(frames), size=min(t["sample"], len(frames)),
                                     replace=False).tolist())
    served = []
    for i, fi in enumerate(picks):
        rows, _ = loop.rows_of(ctx, w, frames[fi], pool=False, quant=compare.fp8)
        served.append((i, fi, compare.decoded_rows(rows)))
    gaps = loop.check_served(ctx, served)
    limits = cfg["limits"][loop.LIMITS]
    compared = {k: (gaps[k], limits[k]) for k in limits}
    return gaps, compared, all(v <= lim for v, lim in compared.values())


def sweep(args):
    """benchmark/tools/sweep.py on the cell, with this loop's set-up in the
    place of open_predict's (the sweep calls open_predict.setup)."""
    from benchmark.loops import open_predict, open_predict_ddetr
    from benchmark.tools import sweep as open_sweep

    open_predict.setup = open_predict_ddetr.setup
    open_sweep.main(["--workload", args.workload, "--seed", args.seeds.split(",")[0],
                     "--seconds", str(args.seconds), "--rates", args.rates])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="ddetr-r50-cams-800")
    p.add_argument("--seeds", default="1")
    p.add_argument("--variant", default="program")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--rates", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from benchmark.run import environment

    environment()
    from benchmark.core import harness, runner, spec

    if args.variant == "sweep":
        return sweep(args)
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.variant == "control":
            ctx = harness.Context(name=args.workload, cfg=cell["config"],
                                  traffic=cell["traffic"], seed=seed, seconds=0, trace=False,
                                  device=args.device)
            numbers, _, correct = control(ctx)
        else:
            undo = []
            if args.variant in FAULTS:
                FAULTS[args.variant](
                    lambda obj, name, value: undo.append((obj, name, getattr(obj, name)))
                    or setattr(obj, name, value))
            try:
                result, summary, compared = runner.run_cell(args.workload, seed, args.seconds,
                                                            False, t0, device=args.device,
                                                            cell=copy.deepcopy(cell))
            finally:
                for obj, name, value in reversed(undo):
                    setattr(obj, name, value)
            numbers = dict({k: v for k, (v, _) in compared.items()}, **summary["check"])
            correct = result["correct"]
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          **numbers, "correct": correct,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
