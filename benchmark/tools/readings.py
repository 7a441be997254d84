"""Readings that the check's limits are set from, on the card, at a cell's
own size: the numbers the check compares, for the program on many seeds,
for the control and for planted faults on a few.

    python3 -m benchmark.tools.readings --workload <cell> --seeds 1,2,3 \
        --variant program|control|look|<fault> [--seconds 3]

program: the cell as it runs, a short window at its own load; one line of
  numbers per seed.
control, serve cells: the program's own lower-precision path switched on in
  place of the configured one, the int8 engine (K4) with its bf16 head,
  then the same window and check.
control, train cells: the reference computed in fp8 (each conv's input and
  weight rounded to e4m3, and the gradients coming back to e5m2, each under
  its own per-tensor scale) put in the program's place for the checked
  steps, judged by the train loop's own check and limits.
look, train cells: the program's checked steps (set-up only), the float32
  reference and the reference under bf16 autocast from the same weights and
  batches; the gaps of the program and of the bf16 reference against the
  float32 one, and of the program against the bf16 one.
a fault's name (benchmark/tools/faults.py): the cell with that fault
  planted underneath its window.
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

from benchmark.run import environment  # noqa: E402


def control_serve(cell):
    cell = copy.deepcopy(cell)
    cell["config"]["serve"].update(precision="int8", int8_head_dtype="bf16",
                                   kernel_convs=False, kernel_stem=False)
    return cell


def _train_context(name, cell, seed, device):
    from benchmark.core import harness

    return harness.Context(name=name, cfg=cell["config"], traffic=cell["traffic"], seed=seed,
                           seconds=0, trace=False, device=device)


def _steps(w, ref):
    """(losses, first gradient, change) of ref_train.steps' result from w."""
    return ref[0], ref[1], {k: ref[2][k] - w[k] for k in ref[1]}


def control_train(name, cell, seed, device):
    """The train cell's checked steps by the fp8 reference, from the cell's
    weights and batches for `seed`, in the program's place: the train loop's
    check and limits judge them as a run's. Returns (every number,
    {compared: (value, limit)}, correct)."""
    from benchmark.core import compare, harness, runner
    from benchmark.loops import train
    from benchmark.reference import train as ref_train

    ctx = _train_context(name, cell, seed, device)
    harness.tf32_off()
    w = harness.draw_weights(ctx)
    data = train.batches(ctx)[:cell["traffic"]["checked_steps"]]
    low = ref_train.steps(w, ctx.cfg, data, quant=compare.fp8)
    losses, grad, change = _steps(w, low)
    ctx.state.update(weights=w, data=data, prog=dict(losses=losses, grad=grad, change=change,
                                                     positives=low[3]))
    return runner.judge(train, ctx)


def train_look(name, cell, seed, device):
    """{program, bf16, program_vs_bf16: train_gaps} (see the module)."""
    from benchmark.core import compare, harness
    from benchmark.loops import train
    from benchmark.reference import train as ref_train

    ctx = _train_context(name, cell, seed, device)
    train.setup(ctx)
    train.after(ctx)
    harness.tf32_off()
    w, p = ctx.state["weights"], ctx.state["prog"]
    data = ctx.state["data"][:cell["traffic"]["checked_steps"]]
    ref = _steps(w, ref_train.steps(w, ctx.cfg, data))
    bf = _steps(w, ref_train.steps(w, ctx.cfg, data, bf16=True))
    prog = (p["losses"], p["grad"], p["change"])

    def gaps(a, b):
        return compare.train_gaps(a[0], b[0], a[1], b[1], a[2], b[2])

    return {"program": gaps(prog, ref), "bf16": gaps(bf, ref), "program_vs_bf16": gaps(prog, bf)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default="program",
                   help="program, control, or a fault of benchmark/tools/faults.py")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    environment()
    from benchmark.core import runner, spec
    from benchmark.tools import faults

    cell = spec.cell(args.workload)
    train = cell["traffic"]["loop"] == "train"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if train and args.variant == "look":
            gaps = train_look(args.workload, cell, seed, args.device)
        elif train and args.variant == "control":
            numbers, compared, correct = control_train(args.workload, cell, seed, args.device)
            gaps = dict(numbers, correct=correct)
        else:
            c = control_serve(cell) if args.variant == "control" else cell
            undo = []
            if args.variant in faults.FAULTS:
                faults.FAULTS[args.variant](
                    lambda obj, name, value: undo.append((obj, name, getattr(obj, name)))
                    or setattr(obj, name, value))
            result, summary, compared = runner.run_cell(args.workload, seed, args.seconds,
                                                        False, t0, device=args.device,
                                                        cell=copy.deepcopy(c))
            for obj, name, value in reversed(undo):
                setattr(obj, name, value)
            gaps = dict({k: v for k, (v, _) in compared.items()}, **summary["check"],
                        correct=result["correct"])
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          **gaps, "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
