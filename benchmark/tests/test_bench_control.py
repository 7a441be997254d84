"""The check's control comes out not correct, at a size a CPU test holds.

Serve cells: the program's own lower-precision path, the int8 engine (K4's
plain version on the CPU) with its bf16 head, in place of the configured
bf16 engine. Train cell: the reference computed in fp8 in the program's
place, judged by the train loop's own check and limits. The readings on the card at the cells' own sizes are in PERF.md
(`benchmark/tools/readings.py` makes them).

    python -m pytest -q benchmark/tests
"""

import copy
import time

import pytest
import torch

from benchmark.core import runner
from benchmark.tests.test_bench_harness import small
from benchmark.tools import readings

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["wfl-cams-1080p", "ttl-cams-2048"])
def test_the_int8_engine_in_the_programs_place_is_not_correct(name):
    cell = readings.control_serve(small(name))
    cell["traffic"].update(frame_hw=[320, 512], sample=3)
    result, _, compared = runner.run_cell(name, 2 ** 31 + 5, 1.0, False, time.perf_counter(),
                                          device="cpu", cell=cell)
    assert not result["correct"], compared


def test_the_fp8_reference_in_the_programs_place_is_not_correct():
    cell = copy.deepcopy(small("wfl-train-480"))
    cell["config"]["train"].update(batch=4, crop=[128, 128], nmax=12)
    _, compared, correct = readings.control_train("wfl-train-480", cell, 2 ** 31 + 7, "cpu")
    assert not correct, compared
