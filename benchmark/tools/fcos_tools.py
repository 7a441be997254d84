"""The FCOS-R50-FPN cell's readings on the card: the knee of its open loop,
and the numbers its check's limits are set from.

    python3 -m benchmark.tools.fcos_tools --workload fcos-r50-cams-800 \
        --variant sweep|program|control|no_centerness --seeds 1,2,3 \
        [--seconds 3] [--rates 100,120]

sweep: benchmark/tools/sweep.py with this cell's set-up (the first seed):
  the mean service time of back-to-back predict calls, then per rate
  (default: 0.7-1.05 of the closed-loop rate) frames, p50 and p95 latency
  from the due time, and the mean latency of the window's last tenth of
  frames against its first tenth (a backlog that grows makes it far higher).
program: the cell as it runs, a short window at its own load; one line of
  numbers per seed.
control: the reference computed in fp8 (each conv's input and weight
  rounded to e4m3 under its own scale, compare.fp8) in the program's place:
  its rows of `sample` frames of the seed's pool, judged by the cell's check
  and limits (the program's own int8 path takes no FCOS).
no_centerness: the cell with an engine whose decode leaves out the
  centerness factor (FAULTS), the same window and check.
All seeds run in this one process.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.core import system  # noqa: E402


def _without_centerness(det):
    """A shallow copy of the detector (the same net) whose decode gets no
    score factors."""
    d = copy.copy(det)
    d._score_factors = lambda outputs: None
    return d


def no_centerness(setattr_):
    """An engine whose decode drops FCOS's centerness factor: scores are
    sigmoid(cls) alone."""
    real = system.engine
    setattr_(system, "engine", lambda det, *a, **k: real(_without_centerness(det), *a, **k))


FAULTS = {"no_centerness": no_centerness}


def control(ctx):
    """(every number, {compared: (value, limit)}, correct) of the fp8
    reference's rows on `sample` frames of the seed's pool in the
    program's place."""
    from benchmark.core import compare, fcos_weights, harness
    from benchmark.loops import open_predict_fcos as loop

    t, cfg = ctx.traffic, ctx.cfg
    hw = tuple(t["frame_hw"])
    pad = loop.padded_hw(cfg, hw)
    w = fcos_weights.draw(cfg, ctx.seed, ctx.device, t.get("frames"))
    frames = harness.frame_pool(ctx, t["pool"], hw)
    ctx.state.update(weights=w, frames=frames, hw=hw, pad=pad)
    harness.tf32_off()
    picks = sorted(ctx.rng(7).choice(len(frames), size=min(t["sample"], len(frames)),
                                     replace=False).tolist())
    served = []
    for i, fi in enumerate(picks):
        rows, _ = loop.rows_of(ctx, w, frames[fi], pad, quant=compare.fp8)
        served.append((i, fi, compare.decoded_rows(rows)))
    gaps = loop.check_served(ctx, served)
    limits = cfg["limits"][loop.LIMITS]
    compared = {k: (gaps[k], limits[k]) for k in limits}
    return gaps, compared, all(v <= lim for v, lim in compared.values())


def sweep(args):
    """benchmark/tools/sweep.py on the cell, with the FCOS loop's set-up in
    the place of open_predict's (the sweep calls open_predict.setup)."""
    from benchmark.loops import open_predict, open_predict_fcos
    from benchmark.tools import sweep as open_sweep

    open_predict.setup = open_predict_fcos.setup
    open_sweep.main(["--workload", args.workload, "--seed", args.seeds.split(",")[0],
                     "--seconds", str(args.seconds), "--rates", args.rates])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="fcos-r50-cams-800")
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
            result, summary, compared = runner.run_cell(args.workload, seed, args.seconds,
                                                        False, t0, device=args.device,
                                                        cell=copy.deepcopy(cell))
            for obj, name, value in reversed(undo):
                setattr(obj, name, value)
            numbers = dict({k: v for k, (v, _) in compared.items()}, **summary["check"])
            correct = result["correct"]
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          **numbers, "correct": correct,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
