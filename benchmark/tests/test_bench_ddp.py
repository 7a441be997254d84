"""The four-card train cell's loop on the CPU at a small size: its ranks as
fresh processes over gloo, 2 images a rank at 96x96 (float32, as the
one-card train cell's CPU test), 2 and 4 ranks. The ranks' step computes the
one-card step on the global batch, so the unchanged train reference holds it
correct; every rank ends the window on the same step and exits. The cell
(`wfl-train-480-ddp4`: widerface_lfd_l under train_480_ddp4) is not in
BENCHMARK.json yet: its card runs spread too widely (PERF.md §7).

    python -m pytest -q benchmark/tests/test_bench_ddp.py
"""

import copy
import time

import pytest
import torch

from benchmark.core import spec
from benchmark.loops import train_ddp

torch.set_num_threads(2)

NAME = "wfl-train-480-ddp4"


def cell():
    """The cell's parts as spec.cell reads them from their files."""
    return dict(workload={"name": NAME, "config": "widerface_lfd_l",
                          "traffic": "train_480_ddp4", "chips": 4},
                config=spec.load_json(spec.BENCH / "configs" / "widerface_lfd_l.json"),
                traffic=spec.load_json(spec.BENCH / "traffic" / "train_480_ddp4.json"))


def small(world):
    c = copy.deepcopy(cell())
    c["traffic"].update(world=world, batches=3)
    c["config"]["train"].update(batch=2 * world, crop=[96, 96], nmax=8, mixed_precision=False)
    c["config"]["weights"]["calibration_hw"] = [128, 128]
    return c


@pytest.mark.parametrize("world", [2, 4])
def test_the_cell_runs_over_gloo_ranks_and_is_correct(world):
    from benchmark.core import runner

    result, summary, compared = runner.run_cell(NAME, 2 ** 33 + 13, 1.0, False,
                                                time.perf_counter(), device="cpu",
                                                cell=small(world))
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert compared["positives_gap"][0] == 0
    assert summary["steps"] == result["attempted"]


def test_the_cells_traffic_and_readers():
    c = cell()
    assert c["traffic"]["world"] == 4 and c["config"]["train"]["batch"] % 4 == 0
    assert spec.loop(c["traffic"]["loop"]) is train_ddp
    seg = {"calls": 2, "busy_s": 1.0, "window_s": 1.0,
           "ops": {"ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)": 0.004, "gemm": 0.5}}
    assert spec.reader("train.allreduce_ms.ddp4").read({"segment": seg}) == pytest.approx(2.0)
    assert spec.reader("train.allreduce_ms.ddp4").read({"segment": None}) is None
    run = {"step_ends": [0.1, 0.2, 0.3], "flops_per_call": 9.89e12}
    assert spec.reader("mfu.ddp4").read(run) == pytest.approx(10.0)  # a tenth of the peak
