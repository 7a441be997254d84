# lfdtpu_torch/tracing.py on the CPU: spans and counters record exactly while
# a torch.profiler session records; inside one they nest, carry their
# parents and call numbers, give self times and counters, appear in the
# profile by name, and stay in a bounded buffer; outside one a span costs
# next to nothing. Then the program's own spans: the predict API over an
# eager engine, the stream, the train step, ProfilerHook's trace and the
# spatial collective. This file imports neither jax nor lfdtpu.
import json
import socket
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lfdtpu_torch import tracing, zoo

torch.set_num_threads(1)

HW = (64, 64)
OFF_US = 2.0  # most host µs a span may cost with no profiler session


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _raw(name):
    """The recorded spans of `name`, oldest first."""
    return [s for s in tracing._RECORDER.spans if s.name == name]


def test_nothing_recorded_outside_a_profiler_session(monkeypatch):
    ranges = []
    real = tracing._range
    monkeypatch.setattr(tracing, "_range", lambda *a: ranges.append(a) or real(*a))
    first = tracing.span("a")
    with first as s:
        with tracing.span("b", device="cpu"):
            tracing.count("n", 3)
    assert s.seq is None and tracing.span("c") is first  # one shared no-op object
    assert ranges == []
    got = tracing.summary()
    assert got == {"spans": {}, "counters": {}, "dropped": 0}
    with _profile() as prof:
        with tracing.span("in"):
            pass
    with tracing.span("after"):
        pass
    assert [r[0] for r in ranges] == ["in"]
    names = {e.name for e in prof.events()}
    assert "in" in names and "a" not in names and "after" not in names
    assert set(tracing.summary()["spans"]) == {"in"}


def test_spans_nest_with_parents_numbers_self_times_and_counters():
    with _profile():
        for _ in range(3):
            with tracing.span("call") as call:
                with tracing.span("call.a"):
                    time.sleep(0.002)
                with tracing.span("call.b", device="cpu") as b:
                    with tracing.span("call.b.inner"):
                        time.sleep(0.001)
                    tracing.count("items", 2)
                    time.sleep(0.001)
            with tracing.span("finish", seq=call.seq) as fin:
                time.sleep(0.001)
            assert b.seq == call.seq and fin.seq == call.seq
    calls = _raw("call")
    assert len({c.seq for c in calls}) == 3 and all(c.parent is None for c in calls)
    for c in calls:
        kids = [s for s in tracing._RECORDER.spans if s.parent == c.id]
        assert sorted(k.name for k in kids) == ["call.a", "call.b"]
        assert all(k.seq == c.seq for k in kids)
    inner = _raw("call.b.inner")
    assert [i.parent for i in inner] == [s.id for s in _raw("call.b")]
    got = tracing.summary()
    spans = got["spans"]
    assert got["counters"] == {"items": 6} and got["dropped"] == 0
    assert spans["call"]["calls"] == spans["call"]["top_level_calls"] == 3

    def ms(s):
        return (s.t1 - s.t0) / 1e6

    def med(values):
        return float(np.median(values))

    kid_ms = [sum(ms(k) for k in tracing._RECORDER.spans if k.parent == c.id) for c in calls]
    assert spans["call"]["host_ms"] == pytest.approx(med([ms(c) for c in calls]))
    assert spans["call"]["self_ms"] == pytest.approx(
        med([ms(c) - k for c, k in zip(calls, kid_ms)]))
    assert 0 <= spans["call"]["self_ms"] < 0.5 * spans["call"]["host_ms"]
    assert spans["call"]["stream_ms"] is None and spans["call.a"]["stream_ms"] is None
    b = _raw("call.b")
    assert spans["call.b"]["stream_ms"] == pytest.approx(med([ms(s) for s in b]))
    assert spans["call.b"]["stream_self_ms"] == spans["call.b"]["stream_ms"]  # no timed child
    assert spans["call.b"]["self_ms"] == pytest.approx(
        med([ms(s) - ms(i) for s, i in zip(b, inner)]))
    assert spans["finish"]["top_level_calls"] == 3 and spans["finish"]["host_ms"] >= 1.0


def test_spans_appear_by_name_in_the_profile():
    with _profile() as prof:
        with tracing.span("outer"):
            with tracing.span("outer.inner", device="cpu"):
                torch.ones(4).sum()
    events = {e.name: e for e in prof.events()}
    assert {"outer", "outer.inner"} <= set(events)
    inner, outer = events["outer.inner"], events["outer"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def test_a_counter_takes_a_function_called_only_while_recording():
    called = []

    def rows():
        called.append(1)
        return 5

    tracing.count("rows", rows)
    assert called == [] and tracing.summary()["counters"] == {}
    with _profile():
        tracing.count("rows", rows)
        tracing.count("rows", 2)
    assert called == [1] and tracing.summary()["counters"] == {"rows": 7}


def test_a_graph_capture_is_asked_for_once_per_top_level_span(monkeypatch):
    """The device is asked whether the thread captures a CUDA graph at a
    top-level span or counter only; inside a capture nothing records."""
    asked, capturing = [], [False]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: asked.append(1) or capturing[0])
    with _profile():
        with tracing.span("top"):
            with tracing.span("top.a"):
                with tracing.span("top.a.b"):
                    tracing.count("inner")
        assert len(asked) == 1
        tracing.count("outer")
        assert len(asked) == 2
        capturing[0] = True
        with tracing.span("captured") as s:
            with tracing.span("captured.inner") as inner:
                tracing.count("captured")
        assert s is inner is tracing._OFF
    got = tracing.summary()
    assert set(got["spans"]) == {"top", "top.a", "top.a.b"}
    assert got["counters"] == {"inner": 1, "outer": 1}


def test_nothing_records_while_paused_inside_a_recorded_span():
    with _profile():
        with tracing.span("outer") as outer:
            with tracing.paused():
                with tracing.span("paused") as s:
                    tracing.count("paused")
            with tracing.span("after"):
                pass
    assert s is tracing._OFF
    assert _children(outer) == ["after"]
    assert tracing.summary()["counters"] == {}
    assert tracing._RECORDER.stack() == []


def test_buffer_stays_bounded_and_counts_its_drops(monkeypatch):
    monkeypatch.setattr(tracing, "_RECORDER", tracing.Recorder(buffer=8))
    with _profile():
        for i in range(20):
            with tracing.span(f"s{i % 2}"):
                pass
    got = tracing.summary()
    assert got["dropped"] == 12
    assert sum(v["calls"] for v in got["spans"].values()) == 8
    assert [s.name for s in tracing._RECORDER.spans][-1] == "s1"


def test_a_span_off_costs_under_two_microseconds():
    n = 100_000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("x", None):
                pass
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
    assert best < OFF_US, best
    assert tracing.summary()["spans"] == {}


def _detector(seed=0):
    det = zoo.widerface_lfd("XS")
    det.init(torch.Generator().manual_seed(seed))
    return det


def _frame(seed=3):
    return np.random.RandomState(seed).randint(0, 256, (*HW, 3)).astype(np.uint8)


def _engine(det):
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    return compile_inference(det, HW, "fp32", preprocess=make_device_preprocess(
        (0.5,) * 3, (0.5,) * 3), classification_threshold=0.0, device="cpu")


def _children(span):
    return sorted(s.name for s in tracing._RECORDER.spans if s.parent == span.id)


def test_predict_through_an_eager_engine_gives_the_predict_tree():
    det = _detector()
    engine = _engine(det)
    ref = det.predict_for_single_image_with_engine(engine, _frame())
    with _profile():
        rows = [det.predict_for_single_image_with_engine(engine, _frame()) for _ in range(2)]
    assert rows[0] == ref and len(ref) > 0
    spans = tracing.summary()
    calls = _raw("predict")
    assert len(calls) == 2 and len({c.seq for c in calls}) == 2
    for c in calls:
        assert _children(c) == ["engine.run", "predict.fetch", "predict.pad", "predict.rows"]
    # the CPU runs K5's plain version: no launch to count; the valid
    # candidates that entered NMS come from the engine's outputs
    cand = int(engine(_frame()[None], HW)["candidates"][0])
    assert spans["counters"] == {"predict.rows": 2 * len(ref), "engine.gn_kernel": 0,
                                 "engine.nms_candidates": 2 * cand}
    s = spans["spans"]
    assert s["engine.run"]["stream_ms"] == pytest.approx(s["engine.run"]["host_ms"])
    assert s["predict"]["self_ms"] < 0.05 * s["predict"]["host_ms"]



def test_a_deformable_detr_call_records_its_spans_and_samples():
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    hw = (128, 160)  # levels 16x20, 8x10, 4x5, 2x3: 426 tokens, 300 of them selected
    det = zoo.deformable_detr_r50()
    det.net.eval()
    engine = compile_inference(det, hw, "fp32", preprocess=make_device_preprocess(
        (0.5,) * 3, (0.5,) * 3), device="cpu")
    frame = np.random.RandomState(4).randint(0, 256, (*hw, 3)).astype(np.uint8)
    with _profile():
        rows = det.predict_for_single_image_with_engine(engine, frame)
    summary = tracing.summary()
    assert len(rows) == 100
    run = _raw("engine.run")[0]
    assert _children(run) == ["detr.decoder", "detr.encoder", "detr.select"]
    for name in ("detr.encoder", "detr.select", "detr.decoder"):
        span = summary["spans"][name]
        assert span["calls"] == 1 and span["stream_ms"] == pytest.approx(span["host_ms"])
    # queries x 8 heads x 4 levels x 4 points: every token in each of the 6
    # encoder layers, the 300 queries in each of the 6 decoder layers; no
    # NMS, so no candidates
    assert summary["counters"] == {"predict.rows": 100, "engine.gn_kernel": 0,
                                   "engine.msda_samples": 6 * (426 + 300) * 128}

def test_stream_spans_carry_their_submits_numbers():
    from lfdtpu_torch.deploy import StreamingServer, run_stream

    engine = _engine(_detector())
    reqs = [(_frame(i)[None], np.asarray(HW, np.float32)) for i in range(5)]
    with _profile():
        out = list(run_stream(engine, iter(reqs), depth=3))
        srv = StreamingServer(engine, depth=2)
        out += [r for q in reqs if (r := srv.submit(*q)) is not None] + list(srv.drain())
    assert len(out) == 10
    submits, fetches = _raw("stream.submit"), _raw("stream.fetch")
    assert len(submits) == len(fetches) == 10
    assert [f.seq for f in fetches] == [s.seq for s in submits]
    assert all(f.parent is None for f in fetches)
    for s in submits:
        assert _children(s) == ["engine.run", "stream.prefetch"]


def _batch(n=2, seed=5):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, *HW, 3)).astype(np.uint8)
    gt = np.zeros((n, 4, 4), np.float32)
    gt[:, 0] = (8, 8, 24, 20)
    gt[:, 1] = (30, 28, 12, 16)
    mask = np.zeros((n, 4), bool)
    mask[:, :2] = True
    return images, gt, np.zeros((n, 4), np.int64), mask


def _train_step(det):
    from lfdtpu_torch.deploy import make_device_preprocess
    from lfdtpu_torch.execution import SGD
    from lfdtpu_torch.parallel import create_train_state, make_train_step

    state = create_train_state(det, SGD(momentum=0.9, weight_decay=1e-4), device="cpu")
    return make_train_step(det, state.optimizer, HW, clip_max_norm=10.0,
                           preprocess=make_device_preprocess((0.5,) * 3, (0.5,) * 3))


def test_train_step_gives_the_train_tree_with_assign_under_loss():
    step = _train_step(_detector())
    with _profile():
        for _ in range(2):
            m = step(*_batch(), 0.01, True)
    assert torch.isfinite(m["loss"])
    steps = _raw("train.step")
    assert len(steps) == 2
    for s in steps:
        assert _children(s) == ["train.backward", "train.forward", "train.input",
                                "train.loss", "train.update"]
    for loss in _raw("train.loss"):
        assert _children(loss) == ["train.assign"]
    got = tracing.summary()["spans"]
    loss, assign = got["train.loss"], got["train.assign"]
    assert loss["stream_ms"] == pytest.approx(loss["host_ms"])  # CPU: host time
    assert loss["stream_self_ms"] == pytest.approx(loss["self_ms"])
    assert 0 < loss["stream_self_ms"] < loss["stream_ms"] and assign["stream_ms"] > 0
    assert got["train.input"]["stream_ms"] is None
    assert got["train.step"]["self_ms"] < 0.05 * got["train.step"]["host_ms"]


@pytest.mark.parametrize("launches", [0, 1])
def test_train_step_counts_the_assign_kernel_per_step(monkeypatch, launches):
    """Counter train.assign_kernel: K6's launches inside train.assign, 0 on
    the CPU; a launch is simulated by an _assign that bumps the wrapper's
    count as K6's CUDA kernel does. The benchmark's reader gives it per
    train.step."""
    from benchmark.core import spec
    from lfdtpu_torch.ops import assign

    det = _detector()
    if launches:
        plain = det._assign

        def counted(*args):
            monkeypatch.setattr(assign.lfd_assign, "launches", assign.lfd_assign.launches + 1)
            return plain(*args)

        det._assign = counted
    step = _train_step(det)
    with _profile():
        for _ in range(3):
            step(*_batch(), 0.01, True)
    assert tracing.summary()["counters"]["train.assign_kernel"] == 3 * launches
    reader = spec.reader("train.assign_kernel_per_step.train")
    assert reader.read({}) == launches


def test_profiler_hook_trace_holds_the_train_step(tmp_path):
    from lfdtpu_torch.execution import ProfilerHook

    step = _train_step(_detector())
    hook = ProfilerHook(str(tmp_path), start_iter=1, num_iters=1)
    ex = types.SimpleNamespace(config_dict={})
    for it in range(3):
        ex.config_dict["train_iter"] = it
        hook.before_train_iter(ex)
        step(*_batch(seed=it), 0.01, True)
        hook.after_train_iter(ex)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("train.step") == 1 and "train.assign" in names
    assert tracing.summary()["spans"]["train.step"]["calls"] == 1


def test_spatial_all_gather_records_its_span_and_counter():
    import torch.distributed as dist

    from lfdtpu_torch.parallel.spatial import Strips

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        strips = Strips(types.SimpleNamespace(spatial=1, spatial_rank=0, spatial_group=None))
        t = torch.arange(12.0).reshape(1, 3, 4)
        assert torch.equal(strips.all_gather(t)[0], t)  # off: nothing recorded
        with _profile():
            got = strips.all_gather(t.bfloat16())
        assert torch.equal(got[0], t.bfloat16())
    finally:
        dist.destroy_process_group()
    summary = tracing.summary()
    assert summary["counters"] == {"spatial.collectives": 1}
    assert summary["spans"]["spatial.all_gather"]["calls"] == 1
    assert summary["spans"]["spatial.all_gather"]["stream_ms"] > 0
