"""The check catches a broken timed path: the rest of a run driven on the
CPU at a small size (the look for a card skipped), with a fault planted
underneath the window, reads `correct` false. One test per fault the cell
can have: a served answer altered where the engine produces it (its boxes
moved, its scores lowered, only its first row kept, or its NMS switched
off); a train step that leaves its state unchanged; a train step over half
of its batch, the mean taken over the rest. (One chip: no exchange between
chips to leave out.) The row faults run on larger frames than the others:
at 250x380 a frame holds too few rows, and too few clusters for NMS, to
tell a lost row from rounding.

    python -m pytest -q benchmark/tests
"""

import time

import pytest
import torch

from benchmark.core import runner
from benchmark.tests.test_bench_harness import small
from benchmark.tools import faults

torch.set_num_threads(2)


def run(name, fault, monkeypatch, **traffic):
    faults.FAULTS[fault](monkeypatch.setattr)
    cell = small(name)
    cell["traffic"].update(traffic)
    result, _, compared = runner.run_cell(name, 2 ** 32 + 11, 1.0, False, time.perf_counter(),
                                          device="cpu", cell=cell)
    return result, compared


@pytest.mark.parametrize("fault", ["moved_boxes", "lowered_scores"])
@pytest.mark.parametrize("name", ["wfl-cams-1080p", "ttl-cams-2048", "wfl-video-1080p"])
def test_an_altered_answer_is_not_correct(name, fault, monkeypatch):
    result, compared = run(name, fault, monkeypatch)
    assert not result["correct"], compared


@pytest.mark.parametrize("fault", ["top_row", "nms_off"])
@pytest.mark.parametrize("name", ["wfl-cams-1080p", "ttl-cams-2048", "wfl-video-1080p"])
def test_a_wrong_row_set_is_not_correct(name, fault, monkeypatch):
    result, compared = run(name, fault, monkeypatch, frame_hw=[512, 768])
    assert not result["correct"], compared


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    result, compared = run("wfl-train-480", fault, monkeypatch)
    assert not result["correct"], compared
