"""The readers of the program's spans and counters (benchmark/core/spans.py)
on a made-up tracing summary: each reads its span's median, or None where
the program has no tracing module or the run traced no such span.

    python -m pytest -q benchmark/tests/test_bench_spans.py
"""

import sys

import pytest

from benchmark.core import spans, spec

# metric: (span or counter it reads, the value it reads from SUMMARY)
READS = {
    "predict.pad_ms.cams": ("predict.pad host", 1.25),
    "predict.stage_ms.cams": ("engine.stage host", 0.5),
    "predict.wait_ms.cams": ("predict.fetch host", 4.5),
    "predict.rows_ms.cams": ("predict.rows host", 0.125),
    "predict.rows_per_frame.cams": ("predict.rows / predict", 30 / 4),
    "engine.replay_ms.cams": ("engine.replay stream", 4.25),
    "stream.submit_ms.video": ("stream.submit host", 0.75),
    "stream.wait_ms.video": ("stream.fetch host", 3.5),
    "train.forward_ms.train": ("train.forward stream", 16.0),
    "train.loss_ms.train": ("train.loss stream self", 5.0),
    "train.assign_ms.train": ("train.assign stream", 42.0),
    "train.backward_ms.train": ("train.backward stream", 30.0),
    "train.update_ms.train": ("train.update stream", 4.0),
}


def _entry(host, stream=None, stream_self=None, calls=4):
    return dict(calls=calls, top_level_calls=calls, host_ms=host, self_ms=host / 2,
                stream_ms=stream, stream_self_ms=stream if stream_self is None else stream_self)


SUMMARY = {
    "spans": {
        "predict": _entry(7.0),
        "predict.pad": _entry(1.25),
        "engine.stage": _entry(0.5),
        "engine.replay": _entry(0.01, 4.25),
        "engine.clone": _entry(0.02),
        "predict.fetch": _entry(4.5),
        "predict.rows": _entry(0.125),
        "stream.submit": _entry(0.75),
        "stream.fetch": _entry(3.5),
        "train.forward": _entry(2.0, 16.0),
        "train.loss": _entry(3.0, 47.0, 5.0),
        "train.assign": _entry(2.0, 42.0),
        "train.backward": _entry(1.0, 30.0),
        "train.update": _entry(1.0, 4.0),
    },
    "counters": {"predict.rows": 30},
    "dropped": 0,
}


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_reads_its_span(monkeypatch, name):
    monkeypatch.setattr(spans, "summary", lambda: SUMMARY)
    assert spec.reader(name).read({}) == pytest.approx(READS[name][1])


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_gives_none_without_the_span(monkeypatch, name):
    monkeypatch.setattr(spans, "summary", lambda: {"spans": {}, "counters": {}, "dropped": 0})
    assert spec.reader(name).read({}) is None


def test_a_program_without_the_tracing_module_gives_none(monkeypatch):
    """An older checkout of the program (no lfdtpu_torch.tracing): every
    reader returns None and none raises."""
    monkeypatch.setitem(sys.modules, "lfdtpu_torch.tracing", None)
    assert spans.summary() is None
    for name in READS:
        assert spec.reader(name).read({}) is None


def test_a_tracing_module_that_fails_to_import_raises(monkeypatch):
    """Only a program without lfdtpu_torch.tracing reads as None; a module
    there whose own import fails stops the run."""
    def broken(name):
        raise ModuleNotFoundError("No module named 'missing_dependency'",
                                  name="missing_dependency")

    monkeypatch.setattr(spans.importlib, "import_module", broken)
    with pytest.raises(ModuleNotFoundError):
        spans.summary()


def test_the_new_metrics_are_listed_for_their_cells():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    cams = ["wfl-cams-1080p", "ttl-cams-2048"]
    for name in READS:
        m = per_layer[name]
        cells, moves, layer = {
            "cams": (cams, "frame_p95_ms", None),
            "video": (["wfl-video-1080p"], "frames_per_s", "serving"),
            "train": (["wfl-train-480"], "train_images_per_s", "train step"),
        }[name.rsplit(".", 1)[1]]
        assert m["workloads"] == cells and m["moves"] == moves
        assert m["source"] == ("program_counter" if "per_frame" in name else "program_span")
        if layer:
            assert m["layer"] == layer
