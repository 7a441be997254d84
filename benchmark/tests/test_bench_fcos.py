"""The FCOS-R50-FPN cell on the CPU at a small size: full-width nets, small
frames. It runs end to end and is correct; an engine whose decode drops the
centerness factor is not; the fp8 reference in the program's place reads
above the bf16 program; the reference imports nothing of the program, and
its FLOP count and K5's bound follow the shapes.

    python -m pytest -q benchmark/tests/test_bench_fcos.py
"""

import copy
import subprocess
import sys
import time

import pytest
import torch

from benchmark.core import harness, k5_roofline, spec
from benchmark.loops import open_predict_fcos
from benchmark.tools import fcos_tools

torch.set_num_threads(2)

NAME = "fcos-r50-cams-800"


def small():
    """The cell at a size a CPU test holds: 250x380 frames (256x384
    padded), the weights calibrated on such a frame."""
    c = copy.deepcopy(spec.cell(NAME))
    c["traffic"].update(frame_hw=[250, 380], pool=3, rate_per_s=4.0, sample=2)
    c["config"]["weights"].update(calibration_hw=[250, 380], candidates=400)
    return c


def run(monkeypatch=None, fault=None):
    from benchmark.core import runner

    if fault:
        fcos_tools.FAULTS[fault](monkeypatch.setattr)
    return runner.run_cell(NAME, 2 ** 33 + 9, 1.0, False, time.perf_counter(), device="cpu",
                           cell=small())


def test_the_cell_runs_end_to_end_and_is_correct():
    result, summary, compared = run()
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in spec.metrics_of(NAME, False)}
    assert set(result["metrics"]) == {"frame_p95_ms", "setup_s"}


def test_an_engine_without_the_centerness_is_not_correct(monkeypatch):
    result, _, compared = run(monkeypatch, "no_centerness")
    assert not result["correct"], compared
    assert compared["score_gap"][0] > compared["score_gap"][1]


def test_the_fp8_reference_reads_above_the_program():
    c = small()
    ctx = harness.Context(name=NAME, cfg=c["config"], traffic=c["traffic"], seed=2 ** 33 + 9,
                          seconds=0, trace=False, device="cpu")
    numbers, compared, correct = fcos_tools.control(ctx)
    assert numbers["score_gap"] > 3.0 and numbers["box_gap"] > 3.0, numbers


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.fcos, "
            "benchmark.core.fcos_weights, benchmark.core.k5_roofline; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'lfdtpu', 'lfdtpu_torch')))"
            % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_flops_and_the_k5_bound_follow_the_shapes():
    cfg = spec.cell(NAME)["config"]
    pad = open_predict_fcos.padded_hw(cfg, (800, 1333))
    assert pad == (896, 1408)
    gflop = open_predict_fcos.flops(cfg, (1, *pad, 3)) / 1e9
    assert 400 < gflop < 600, gflop
    launches = k5_roofline.frame_launches(cfg, pad)
    assert len(launches) == 40 and launches[0] == (1, 112, 176, 256)
    assert launches[-1] == (1, 7, 11, 256)
    assert k5_roofline.frame_bound_s(cfg, pad) == pytest.approx(
        sum(3 * h * w * 256 * 2 + 2048 for _, h, w, _ in launches) / 3.35e12)
    seg = {"calls": 2, "ops": {"void group_norm_stats_kernel<bf16>": 1e-4,
                               "void group_norm_relu_kernel<bf16>": 1e-4, "gemm": 5.0}}
    share = k5_roofline.share({"segment": seg, "k5_bound_s": 5e-5})
    assert share == pytest.approx(50.0)
    assert k5_roofline.share({"segment": None, "k5_bound_s": 5e-5}) is None
