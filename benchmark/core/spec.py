"""Where the benchmark's parts live, found by the names in BENCHMARK.json.

  BENCHMARK.json                    cells, metrics, configurations
  benchmark/configs/<config>.json   one configuration (its `file` entry)
  benchmark/traffic/<traffic>.json  one traffic mix; its "loop" names the
                                    general loop in benchmark/loops/
  benchmark/metrics/<metric>.py     one metric's reader: read(run) -> number
                                    or None (nothing to read in this run)

A later change adds a configuration, a mix or a metric by adding its file
and its entry; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def cell(name, bench=None, root=ROOT):
    """The cell `name`: its workload entry, its configuration and its
    traffic mix (dicts read from their files under the checkout `root`)."""
    root = Path(root)
    bench = bench or benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    return dict(workload=w, config=cfg, traffic=traffic)


def _listed(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def metrics_of(cell_name, trace, bench=None):
    """The metrics a run of the cell prints: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1."""
    bench = bench or benchmark()
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if _listed(m, cell_name)]


def reader(name, root=ROOT):
    """The module of benchmark/metrics/<name>.py (names may hold dots)."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(kind):
    """The general loop of a traffic mix's kind: benchmark/loops/<kind>.py."""
    return importlib.import_module(f"benchmark.loops.{kind}")
