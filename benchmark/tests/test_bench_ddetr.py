"""The Deformable DETR cell on the CPU at a small size: full-width nets,
small frames. It runs end to end and is correct; a program that samples
nearest neighbours or skips the box refinement is not; the bf16-locations
fault is planted (it moves the outputs); the bf16 reference in the
program's place reads about 1 and the fp8 one above the limits; the
reference imports nothing of the program, and its FLOP count, the sample
count and MSDA's bound follow the shapes.

    python -m pytest -q benchmark/tests/test_bench_ddetr.py
"""

import copy
import subprocess
import sys
import time

import pytest
import torch

from benchmark.core import harness, msda_roofline, spec
from benchmark.loops import open_predict_ddetr
from benchmark.tools import ddetr_tools

torch.set_num_threads(2)

NAME = "ddetr-r50-cams-800"
SEED = 2 ** 33 + 9


def small(hw=(150, 220)):
    """The cell at a size a CPU test holds."""
    c = copy.deepcopy(spec.cell(NAME))
    c["traffic"].update(frame_hw=list(hw), pool=3, rate_per_s=2.0, sample=2)
    return c


def run(monkeypatch=None, fault=None, cell=None):
    from benchmark.core import runner

    if fault:
        ddetr_tools.FAULTS[fault](monkeypatch.setattr)
    return runner.run_cell(NAME, SEED, 1.0, False, time.perf_counter(), device="cpu",
                           cell=cell or small())


def test_the_cell_runs_end_to_end_and_is_correct():
    result, summary, compared = run()
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in spec.metrics_of(NAME, False)}
    assert set(result["metrics"]) == {"frame_p95_ms", "setup_s"}
    assert {m["name"] for m in spec.metrics_of(NAME, True)} == {
        "engine.device_ms.detr", "mfu.detr", "engine.msda_samples_per_frame.detr",
        "engine.msda_ms.detr", "msda_roofline.detr"}


@pytest.mark.parametrize("fault", ["nearest", "no_refine"])
def test_each_fault_fails_a_limit(monkeypatch, fault):
    result, _, compared = run(monkeypatch, fault)
    assert not result["correct"], compared
    assert any(v > lim for v, lim in compared.values())


def test_the_bf16_locations_fault_moves_the_outputs(monkeypatch):
    """Planted where the program samples: the float32 engine's outputs
    move (on the card it reads within the program's gaps, PERF.md §4)."""
    from benchmark.core import ddetr_program, ddetr_weights

    c = small()
    cfg = dict(c["config"], serve=dict(c["config"]["serve"], precision="fp32"))
    det = ddetr_program.detector(ddetr_weights.draw(cfg, SEED, "cpu"))
    det.net.eval()
    hw = tuple(c["traffic"]["frame_hw"])
    ctx = harness.Context(name=NAME, cfg=cfg, traffic=c["traffic"], seed=SEED, seconds=0,
                          trace=False, device="cpu")
    frame = harness.frame_pool(ctx, 1, hw)
    clean = ddetr_program.engine(det, cfg, hw, "cpu").dense(frame)
    ddetr_tools.FAULTS["bf16_locations"](monkeypatch.setattr)
    moved = ddetr_program.engine(det, cfg, hw, "cpu").dense(frame)
    assert not torch.equal(moved[0], clean[0]) and not torch.equal(moved[1], clean[1])


def _control(quant=None, dtype=torch.float32):
    """The check of the reference's own rows (quant or dtype) in the
    program's place on the small cell's frames."""
    from benchmark.core import compare, ddetr_weights

    c = small()
    ctx = harness.Context(name=NAME, cfg=c["config"], traffic=c["traffic"], seed=SEED,
                          seconds=0, trace=False, device="cpu")
    hw = tuple(c["traffic"]["frame_hw"])
    w = ddetr_weights.draw(c["config"], SEED, "cpu")
    frames = harness.frame_pool(ctx, 2, hw)
    ctx.state.update(weights=w, frames=frames, hw=hw)
    if dtype != torch.float32:
        w = {k: v.to(dtype) if v.is_floating_point() else v for k, v in w.items()}
    served = [(i, i, compare.decoded_rows(open_predict_ddetr.rows_of(
        ctx, w, frames[i], pool=False, quant=quant, dtype=dtype)[0])) for i in range(2)]
    return open_predict_ddetr.check_served(ctx, served)


def test_the_bf16_reference_reads_one_and_the_fp8_one_above_the_limits():
    from benchmark.core import compare

    rounded = _control(dtype=torch.bfloat16)
    assert rounded["box_gap"] == pytest.approx(1.0) and rounded["rows_gap"] == 1.0, rounded
    fp8 = _control(quant=compare.fp8)
    limits = spec.cell(NAME)["config"]["limits"]["serve"]
    assert fp8["score_gap"] > limits["score_gap"], fp8


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.deformable_detr, "
            "benchmark.core.ddetr_weights, benchmark.core.msda_roofline; print(sorted(m for m "
            "in sys.modules if m.split('.')[0] in ('jax', 'lfdtpu', 'lfdtpu_torch')))"
            % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_flops_samples_and_the_msda_bound_follow_the_shapes():
    cfg = spec.cell(NAME)["config"]
    hw = (800, 1333)
    assert msda_roofline.level_shapes(hw) == [(100, 167), (50, 84), (25, 42), (13, 21)]
    assert msda_roofline.frame_samples(cfg, hw) == 17297664  # 6 x 22,223 x 128 + 6 x 300 x 128
    calls = msda_roofline.frame_calls(cfg, hw)
    t = cfg["transformer"]
    assert msda_roofline.call_bytes(*calls[0], t) == 22223 * 512 * 2 + 22223 * 128 * 12
    assert msda_roofline.call_bytes(*calls[-1], t) == 22223 * 512 + 300 * 128 * 12 + 300 * 512
    assert msda_roofline.frame_bound_s(cfg, hw) == pytest.approx(413.299e6 / 3.35e12, rel=1e-4)
    gflop = open_predict_ddetr.flops(cfg, (1, *hw, 3)) / 1e9
    assert 380 < gflop < 450, gflop
    bound = msda_roofline.frame_bound_s(cfg, hw)
    assert msda_roofline.share({"msda_bound_s": bound, "msda_ms": 1.0}) == \
        pytest.approx(100 * bound * 1e3)
    assert msda_roofline.share({"msda_bound_s": bound}) is None
