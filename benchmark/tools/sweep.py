"""Find an open-loop cell's knee once: the highest total rate its server
sustains without a growing backlog.

    python3 -m benchmark.tools.sweep --workload <cell> --seed <n> \
        --rates 60,80,100 [--seconds 8]

One process builds the cell's engine and frames once, measures the mean
service time of back-to-back predict calls, then serves the cell's open
loop at each rate in turn and prints per rate: frames, p50 and p95 latency
from the due time, and the mean latency of the window's last tenth of
frames against its first tenth (a backlog that grows makes the last far
higher). The cell's traffic file then takes 0.8 of the knee as its rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.run import environment  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    environment()
    from benchmark.core import harness, readers, spec, system
    from benchmark.loops import open_predict

    cell = spec.cell(args.workload)
    ctx = harness.Context(name=args.workload, cfg=cell["config"], traffic=cell["traffic"],
                          seed=args.seed, seconds=args.seconds, trace=False)
    open_predict.setup(ctx)
    det, eng, frames = ctx.state["det"], ctx.state["engine"], ctx.state["frames"]
    n = 200
    t0 = time.perf_counter()
    for i in range(n):
        system.predict(det, eng, frames[i % len(frames)])
    service = (time.perf_counter() - t0) / n
    print(json.dumps({"workload": args.workload, "service_ms": 1e3 * service,
                      "closed_loop_per_s": 1.0 / service}), flush=True)
    rates = ([float(r) for r in args.rates.split(",")] if args.rates
             else [round(f / service, 1) for f in (0.7, 0.8, 0.9, 0.95, 1.0, 1.05)])
    for rate in rates:
        ctx.traffic = dict(cell["traffic"], rate_per_s=rate)
        open_predict.window(ctx)
        calls = ctx.record["calls"]
        lat = np.array([c[2] - c[0] for c in calls]) * 1e3
        k = max(1, len(lat) // 10)
        print(json.dumps({"rate_per_s": rate, "frames": len(calls),
                          "p50_ms": float(np.median(lat)), "p95_ms": readers.p95_ms(ctx.record),
                          "first_tenth_ms": float(lat[:k].mean()),
                          "last_tenth_ms": float(lat[-k:].mean())}), flush=True)


if __name__ == "__main__":
    main()
