"""Run one cell of lfdtpu_torch's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name from BENCHMARK.json (see benchmark/core/spec.py). The last line of
standard output is the result: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics), device
(with --trace 1 also the device's busy seconds and the traced window), with
--trace 1 a breakdown, and last the numbers the check compared, each with
its limit; the same numbers close standard error. The line before it holds
the run's counts and medians. Without a CUDA device the run fails and prints
no result; so does a run in which JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


HOST_THREADS = 2  # the host's share of a run: the loop, staging and copies


def environment():
    """Every cache inside the checkout, at fixed paths; no library may load
    JAX on its own; few host threads, so that a run's host work does not
    spread over the machine's cores and swing with their load."""
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    cache = ROOT / "build" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()

    import torch

    from benchmark.core import runner, spec

    torch.set_num_threads(HOST_THREADS)

    cell = spec.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, summary, compared = runner.run_cell(args.workload, args.seed, args.seconds,
                                                bool(args.trace), T_START, cell=cell)
    print(json.dumps({"summary": summary}))
    for k, (v, lim) in compared.items():
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
