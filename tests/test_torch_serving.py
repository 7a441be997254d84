# Pipelined streaming (lfdtpu_torch/deploy/serving.py) on the CPU: lfdtpu's
# four cases of tests/test_serving.py (results equal to the synchronous loop
# bit for bit and in order at depths 1, 3 and 10; lazy with a bounded number
# in flight; submit and drain; depth validation) on the port's engine of
# lfdtpu's tiny_lfd, then the port's stream against lfdtpu's run_stream on
# the same weights and frames, within the fp32 engine parity tolerances of
# tests/test_torch_engine.py (counts and labels equal, scores rel 1e-5,
# boxes 1e-3 px).
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.deploy import compile_inference as jax_compile
from lfdtpu.deploy import make_device_preprocess as jax_preprocess
from lfdtpu.deploy import run_stream as jax_run_stream
from lfdtpu_torch.deploy import (StreamingServer, compile_inference, make_device_preprocess,
                                 run_stream)
from tests.test_torch_int8 import _tiny_pair

torch.set_num_threads(1)

HALF = (0.5, 0.5, 0.5)


def _frames(n=6):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 255, (1, 64, 64, 3)).astype(np.uint8) for _ in range(n)]


def _engine_and_inputs(n=6):
    _, _, tdet = _tiny_pair()
    engine = compile_inference(tdet, (64, 64), "fp32", preprocess=make_device_preprocess(HALF, HALF),
                               classification_threshold=0.01, device="cpu")
    vhw = torch.tensor([64.0, 64.0])
    return engine, [(torch.as_tensor(im), vhw) for im in _frames(n)]


def _sync(engine, reqs):
    return [{k: v.numpy() for k, v in engine(*r).items()} for r in reqs]


def test_run_stream_matches_sync_in_order():
    engine, reqs = _engine_and_inputs()
    sync = _sync(engine, reqs)
    assert sum(int(s["count"][0]) for s in sync) > 0
    for depth in (1, 3, 10):  # degenerate, partial, deeper than the stream
        got = list(run_stream(engine, iter(reqs), depth=depth))
        assert len(got) == len(sync)
        for g, s in zip(got, sync):
            for k in s:
                np.testing.assert_array_equal(g[k], s[k])


def test_run_stream_is_lazy_and_bounds_in_flight():
    engine, reqs = _engine_and_inputs()
    calls = []

    def counting_engine(*args):
        calls.append(len(calls))
        return engine(*args)

    stream = run_stream(counting_engine, iter(reqs), depth=2)
    assert calls == []  # nothing dispatched before iteration starts
    next(stream)
    assert len(calls) == 2  # the first yield comes once the pipeline is full
    list(stream)
    assert len(calls) == len(reqs)


def test_streaming_server_submit_drain():
    engine, reqs = _engine_and_inputs()
    sync = _sync(engine, reqs)
    srv = StreamingServer(engine, depth=3)
    got = []
    for r in reqs:
        res = srv.submit(*r)
        if res is not None:
            got.append(res)
    assert len(got) == len(reqs) - 2  # depth - 1 still in flight
    got += list(srv.drain())
    assert len(got) == len(sync)
    for g, s in zip(got, sync):
        for k in s:
            np.testing.assert_array_equal(g[k], s[k])
    assert list(srv.drain()) == []  # idempotent once empty


def test_stream_depth_validation():
    with pytest.raises(ValueError):
        list(run_stream(lambda: None, [], depth=0))
    with pytest.raises(ValueError):
        StreamingServer(lambda: None, depth=0)


def test_run_stream_matches_lfdtpus():
    """The same weights and frames through lfdtpu's run_stream and the
    port's, both at depth 3."""
    jdet, variables, tdet = _tiny_pair()
    je = jax_compile(jdet, variables, (64, 64), "fp32", preprocess=jax_preprocess(HALF, HALF),
                     classification_threshold=0.01)
    te = compile_inference(tdet, (64, 64), "fp32", preprocess=make_device_preprocess(HALF, HALF),
                           classification_threshold=0.01, device="cpu")
    imgs = _frames()
    vhw = np.asarray([64.0, 60.0], np.float32)
    ref = list(jax_run_stream(je, ((jnp.asarray(im), jnp.asarray(vhw)) for im in imgs), depth=3))
    got = list(run_stream(te, ((im, vhw) for im in imgs), depth=3))
    assert len(got) == len(ref) == len(imgs)
    assert sum(int(r["count"][0]) for r in ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["count"], r["count"])
        np.testing.assert_array_equal(g["labels"], r["labels"])
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=1e-5, atol=1e-3)
