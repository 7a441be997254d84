"""The harness on the CPU: parts found by name, the end-to-end metrics over
every frame of a window that holds a stall, the import guard, and a cell
driven end to end at a small size.

    python -m pytest -q benchmark/tests
"""

import copy
import json
import math
import shutil
import subprocess
import sys
import time

import pytest
import torch

import numpy as np

from benchmark.core import compare, guard, harness, readers, runner, spec
from benchmark.loops import open_predict, stream

torch.set_num_threads(2)


def test_added_config_mix_and_metric_are_found_by_name(tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as
    files and entries; the harness finds them without an edit."""
    root = tmp_path
    shutil.copytree(spec.BENCH / "configs", root / "benchmark" / "configs")
    shutil.copytree(spec.BENCH / "traffic", root / "benchmark" / "traffic")
    shutil.copytree(spec.BENCH / "metrics", root / "benchmark" / "metrics")
    bench = spec.benchmark()
    cfg = json.loads((spec.BENCH / "configs" / "widerface_lfd_l.json").read_text())
    cfg["name"] = "widerface_lfd_l_copy"
    (root / "benchmark" / "configs" / "widerface_lfd_l_copy.json").write_text(json.dumps(cfg))
    mix = dict(spec.cell("wfl-cams-1080p")["traffic"], streams=8, rate_per_s=50.0)
    (root / "benchmark" / "traffic" / "cams8_slow.json").write_text(json.dumps(mix))
    (root / "benchmark" / "metrics" / "frames.count.cams.py").write_text(
        "def read(run):\n    return len(run['calls']) if run.get('calls') else None\n")
    bench["configs"].append(dict(bench["configs"][0], name="widerface_lfd_l_copy",
                                 file="benchmark/configs/widerface_lfd_l_copy.json"))
    bench["workloads"].append({"name": "wfl-cams8", "config": "widerface_lfd_l_copy",
                               "traffic": "cams8_slow", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames.count.cams", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "predict API", "moves": "frame_p95_ms",
                               "workloads": ["wfl-cams8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("wfl-cams8", root=root)
    assert c["config"]["name"] == "widerface_lfd_l_copy"
    assert c["traffic"]["streams"] == 8
    names = [m["name"] for m in spec.metrics_of("wfl-cams8", True, spec.benchmark(root))]
    assert names == ["frames.count.cams"]
    assert spec.reader("frames.count.cams", root=root).read({"calls": [1, 2, 3]}) == 3
    assert spec.loop(c["traffic"]["loop"]) is open_predict


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    bench = spec.benchmark()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert hasattr(spec.reader(m["name"]), "read"), m["name"]
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert hasattr(spec.loop(c["traffic"]["loop"]), "check")
        assert {"precision", "mean", "std"} <= set(c["config"]["serve"])


def test_tail_and_rate_count_every_frame_of_a_window_with_a_stall():
    """100 frames due every 10 ms, served in 2 ms each, but a 300 ms stall
    at frame 50: the frames queued behind it are late from their due time,
    so the 95th percentile sees the stall; a failed frame reads inf."""
    calls, free = [], 0.0
    for i in range(100):
        due = 0.01 * i
        start = max(due, free) + (0.3 if i == 50 else 0.0)
        end = start + 0.002
        calls.append((due, start, end, True, 0.0))
        free = end
    lat = sorted(c[2] - c[0] for c in calls)
    p95 = readers.p95_ms({"calls": calls})
    assert p95 == pytest.approx(1e3 * lat[94])
    assert p95 > 100.0  # frames 50-80 waited behind the stall
    assert readers.predict_ms({"calls": calls}) == pytest.approx(2.0)
    calls[3] = calls[3][:3] + (False, 0.0)
    assert readers.p95_ms({"calls": calls[:10]}) == math.inf
    done = [0.5 + 0.01 * i for i in range(100)] + [3.0]  # a stall before the last
    rate = spec.reader("frames_per_s").read({"done": done})
    assert rate == pytest.approx(101 / 3.0)


def test_schedule_is_seeded_and_keeps_the_rate():
    t = spec.cell("wfl-cams-1080p")["traffic"]
    import numpy as np

    a = open_predict.schedule(t, np.random.default_rng([2 ** 40 + 3, 1]), 10.0)
    b = open_predict.schedule(t, np.random.default_rng([2 ** 40 + 3, 1]), 10.0)
    c = open_predict.schedule(t, np.random.default_rng([5, 1]), 10.0)
    assert a == b and a != c
    assert abs(len(a) - 10.0 * t["rate_per_s"]) <= t["streams"] + 1
    assert all(0 <= d < 10.0 for d, _, _ in a)


def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden(["lfdtpu_torch", "lfdtpu_torch.ops", "numpy"]) == []
    assert guard.forbidden(["lfdtpu.ops", "jax", "jaxlib.xla", "flax.linen", "jaxtyping"]) == [
        "flax.linen", "jax", "jaxlib.xla", "lfdtpu.ops"]


def test_a_run_loads_no_jax_and_fails_without_a_card():
    """run.py in a fresh process: without a CUDA device it exits non-zero
    and prints no result; the harness and the port load no JAX."""
    out = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload",
                          "wfl-cams-1080p", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run as r; r.environment(); "
            "from benchmark.core import runner, system, harness; from benchmark.loops import "
            "open_predict, stream, train; import lfdtpu_torch.deploy.serving, "
            "lfdtpu_torch.parallel; from benchmark.core.guard import forbidden; "
            "print(forbidden())" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_stream_refuses_a_stride_that_keeps_only_some_frames():
    """keep_every must share no factor with the pool: a stride of 16 over
    a pool of 32 keeps the results of two frames all through the window."""
    c = spec.cell("wfl-video-1080p")
    assert math.gcd(c["traffic"]["keep_every"], c["traffic"]["pool"]) == 1
    ctx = harness.Context(name="wfl-video-1080p", cfg=c["config"], seed=1, seconds=0,
                          trace=False, device="cpu",
                          traffic=dict(c["traffic"], keep_every=16, pool=32))
    with pytest.raises(ValueError, match="shares a factor"):
        stream.setup(ctx)


def _box(x, score):
    return {"boxes": torch.tensor([[x, 0.0, x + 9.0, 9.0]]), "scores": torch.tensor([score]),
            "labels": torch.tensor([0])}


def test_served_twice_weighs_the_same_on_both_sides(monkeypatch):
    """A frame served twice counts twice for the bf16 reference as for the
    program: a program whose rows are the bf16 reference's reads rows_gap 1,
    however the sample repeats frames of different difficulty."""
    final = {0: _box(0.0, 0.9), 1: _box(50.0, 0.9)}
    pool = {f: {k: torch.cat([v, _box(100.0 + f, 0.5)[k]]) for k, v in b.items()}
            for f, b in final.items()}
    # frame 0: the bf16 reference adds a row; frame 1: it serves the final row
    r16 = {0: compare.decoded_rows(pool[0]), 1: compare.decoded_rows(final[1])}
    monkeypatch.setattr(harness, "reference_rows",
                        lambda ctx, w, frame, pad: (final[int(frame[0, 0, 0])],
                                                    pool[int(frame[0, 0, 0])],
                                                    r16[int(frame[0, 0, 0])]))
    frames = np.stack([np.full((4, 4, 3), f, np.uint8) for f in (0, 1)])
    ctx = harness.Context(name="x", cfg={"nms_threshold": 0.4}, traffic={}, seed=1,
                          seconds=0, trace=False, device="cpu")
    served = [(0, 0, r16[0]), (1, 0, r16[0]), (2, 0, r16[0]), (3, 1, r16[1])]
    gaps = harness.check_served(ctx, None, served, frames, (4, 4), (4, 4))
    assert gaps["unmatched"] == gaps["unmatched_bf16"] > 0
    assert gaps["rows_gap"] == 1.0


def small(name):
    """The cell at a size a CPU test holds: full-width nets, small frames."""
    c = copy.deepcopy(spec.cell(name))
    t = c["traffic"]
    if t["loop"] == "open_predict":
        t.update(frame_hw=[250, 380], pool=3, rate_per_s=10.0, sample=2)
    elif t["loop"] == "stream":
        t.update(frame_hw=[250, 380], pool=3, sample=2, depth=2, keep_every=2)
    else:
        t.update(batches=3)
        # float32 here: bf16 autocast's rounding at 2 images of 96x96 is not
        # what the limits were read from (the card's 64 at 480x480)
        c["config"]["train"].update(batch=2, crop=[96, 96], nmax=8, mixed_precision=False)
    c["config"]["weights"]["calibration_hw"] = [128, 128]
    return c


@pytest.mark.parametrize("name", ["wfl-cams-1080p", "ttl-cams-2048", "wfl-train-480",
                                  "wfl-video-1080p"])
def test_a_cell_runs_end_to_end_and_is_correct(name):
    result, summary, compared = runner.run_cell(name, 2 ** 33 + 7, 1.0, False,
                                                time.perf_counter(), device="cpu",
                                                cell=small(name))
    assert result["correct"], compared
    assert list(result)[-1] == "compared"
    e2e = {m["name"] for m in spec.metrics_of(name, False)}
    assert set(result["metrics"]) == e2e
    assert result["attempted"] > 0 and result["failed"] == 0
