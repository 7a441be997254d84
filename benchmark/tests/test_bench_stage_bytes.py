"""The reader of the program's staging counter: engine.stage_bytes_per_frame.cams
is the counter engine.stage_bytes over the predict spans of a traced run,
None where the program counts no such bytes (a program from before the
counter) or has no tracing module, and it is listed for the two LFD cams
cells.

    python -m pytest -q benchmark/tests/test_bench_stage_bytes.py
"""

import sys

import pytest

from benchmark.core import spans, spec

NAME = "engine.stage_bytes_per_frame.cams"


def _summary(counters, calls=4):
    entry = dict(calls=calls, top_level_calls=calls, host_ms=7.0, self_ms=3.5,
                 stream_ms=None, stream_self_ms=None)
    return {"spans": {"predict": entry, "engine.stage": dict(entry, host_ms=0.6)},
            "counters": counters, "dropped": 0}


@pytest.mark.parametrize("frame_bytes", [1080 * 1920 * 3, 2048 * 2048 * 3])
def test_reads_the_counter_over_the_predict_spans(monkeypatch, frame_bytes):
    monkeypatch.setattr(spans, "summary",
                        lambda: _summary({"engine.stage_bytes": 4 * frame_bytes,
                                          "predict.rows": 30}))
    assert spec.reader(NAME).read({}) == frame_bytes


def test_a_program_without_the_counter_gives_none(monkeypatch):
    monkeypatch.setattr(spans, "summary", lambda: _summary({"predict.rows": 30}))
    assert spec.reader(NAME).read({}) is None
    monkeypatch.setattr(spans, "summary", lambda: {"spans": {}, "counters": {}, "dropped": 0})
    assert spec.reader(NAME).read({}) is None
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "lfdtpu_torch.tracing", None)
    assert spec.reader(NAME).read({}) is None


def test_is_listed_for_the_lfd_cams_cells():
    m = {m["name"]: m for m in spec.benchmark()["per_layer"]}[NAME]
    assert m["workloads"] == ["wfl-cams-1080p", "ttl-cams-2048"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == \
        ("bytes", "lower", "program_counter", "predict API", "frame_p95_ms")
