# The port's latency measurement (lfdtpu_torch/deploy/latency.py) and the
# engine's two forms, on the CPU:
#   - timing_inference: lfdtpu's result keys, positive times, the warmup
#     excluded, `distinct_inputs` frames on the engine's device rotated, the
#     engine's rows on the first frame as lfdtpu's engine gives them;
#   - inference_latency_evaluation: one engine per (precision, resolution)
#     cell at the resolution padded to the largest stride, the same cells as
#     lfdtpu's sweep;
#   - an engine on the CPU is eager; asking for a captured one raises; a
#     result survives the next call;
#   - K1's plain version run for a fixed number of rounds (what a CUDA-graph
#     capture records, where the loop cannot ask whether it has converged)
#     gives exactly the mask of the loop that stops when nothing changes.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.deploy import compile_inference as jax_compile
from lfdtpu.deploy import make_device_preprocess as jax_preprocess
from lfdtpu_torch.deploy import (compile, compile_inference, inference_latency_evaluation,
                                 latency, make_device_preprocess, timing_inference)
from lfdtpu_torch.ops import nms_kernel
from tests.test_torch_bridge import jax_and_port

torch.set_num_threads(1)

HW = (64, 96)
MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
KEYS = {"ms_per_image", "fps", "ms_mean", "ms_min", "ms_p25", "ms_p75", "ms_p95", "loops",
        "method"}


class _Recording:
    """An engine that records what it is called with."""

    def __init__(self, engine):
        self.engine, self.device, self.calls = engine, engine.device, []

    def __call__(self, images, valid_hw):
        self.calls.append((images, valid_hw))
        return self.engine(images, valid_hw)


def test_timing_inference_protocol_and_keys():
    jdet, variables, tdet = jax_and_port("WIDERFACE-S")
    engine = _Recording(compile_inference(
        tdet, HW, "fp32", preprocess=make_device_preprocess(MEAN, STD), batch_size=2,
        device="cpu", classification_threshold=0.01))
    images = np.random.RandomState(0).randint(0, 255, (2,) + HW + (3,)).astype(np.uint8)
    r = timing_inference(engine, images, (60, 90), warmup_loops=2, timing_loops=7,
                         distinct_inputs=3)
    assert set(r) == KEYS and r["method"] == "perf_counter_per_call" and r["loops"] == 7
    assert 0 < r["ms_min"] <= r["ms_p25"] <= r["ms_per_image"] <= r["ms_p75"] <= r["ms_p95"]
    assert r["ms_mean"] > 0 and abs(r["fps"] - 1000.0 / r["ms_per_image"]) < 1e-9
    # max(warmup, distinct) untimed calls, then the timed ones; three frames
    # rotate, all tensors on the engine's device, the first the caller's own
    assert len(engine.calls) == 3 + 7
    frames = {id(x): x for x, _ in engine.calls}
    assert len(frames) == 3
    assert all(x.dtype == torch.uint8 and x.device.type == "cpu" for x in frames.values())
    assert [id(x) for x, _ in engine.calls[:6]] == [id(x) for x, _ in engine.calls[:3]] * 2
    first, vhw = engine.calls[0]
    assert np.array_equal(first.numpy(), images) and vhw.tolist() == [60.0, 90.0]
    # the auto-sized run: at least 20 timed calls
    auto = timing_inference(engine.engine, images, (60, 90), warmup_loops=1,
                            distinct_inputs=1, target_s=0.01)
    assert 20 <= auto["loops"] <= 1000
    # and what is timed is the engine lfdtpu times: the same rows
    je = jax_compile(jdet, variables, HW, "fp32", batch_size=2,
                     preprocess=jax_preprocess(MEAN, STD), classification_threshold=0.01)
    ref = je(jnp.asarray(images), jnp.asarray([60, 90], jnp.float32))
    got = engine.engine(first, vhw)
    assert int(got["count"].sum()) > 0
    np.testing.assert_array_equal(got["count"].numpy(), np.asarray(ref["count"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]),
                               rtol=1e-5, atol=1e-6)


def test_latency_sweep_builds_one_engine_per_cell(monkeypatch):
    _, _, tdet = jax_and_port("WIDERFACE-XS")
    built = []

    def counting(detector, input_hw, **kw):
        engine = compile_inference(detector, input_hw, **kw)
        built.append((kw["precision"], engine.input_resolution, engine.batch_size,
                      engine.device.type, engine.captured))
        return engine

    monkeypatch.setattr(compile, "compile_inference", counting)
    res = inference_latency_evaluation(
        tdet, resolutions=((48, 64), (70, 100)), precisions=("fp32", "bf16"),
        preprocess=make_device_preprocess(MEAN, STD), warmup_loops=1, timing_loops=2,
        verbose=False, device="cpu")
    assert list(res) == [("fp32", (48, 64)), ("fp32", (70, 100)), ("bf16", (48, 64)),
                         ("bf16", (70, 100))]
    # padded to the largest stride (64 for WIDERFACE); eager on the CPU
    assert built == [(p, hw, 1, "cpu", False) for p in ("fp32", "bf16")
                     for hw in ((64, 64), (128, 128))]
    for r in res.values():
        assert set(r) == KEYS and r["ms_per_image"] > 0 and r["loops"] == 2
    assert latency.inference_latency_evaluation.__defaults__[:2] == (
        ((480, 640), (720, 1280), (1080, 1920), (2160, 3840)), ("fp32", "bf16"))


def test_cpu_engine_is_eager_and_a_captured_one_raises():
    _, _, tdet = jax_and_port("WIDERFACE-S")
    pre = make_device_preprocess(MEAN, STD)
    kw = dict(preprocess=pre, device="cpu", classification_threshold=0.01)
    engine = compile_inference(tdet, HW, "fp32", **kw)
    assert engine.captured is False and engine.captured_launches is None
    assert compile_inference(tdet, HW, "fp32", captured=False, **kw).captured is False
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        compile_inference(tdet, HW, "fp32", captured=True, **kw)
    rng = np.random.RandomState(1)
    a, b = (rng.randint(0, 255, (1,) + HW + (3,)).astype(np.uint8) for _ in range(2))
    out_a = engine(a, HW)
    kept = {k: v.clone() for k, v in out_a.items()}
    out_b = engine(b, HW)
    assert all(torch.equal(out_a[k], kept[k]) for k in kept)  # call 1 survives call 2
    assert not torch.equal(out_a["scores"], out_b["scores"])
    # the two halves are the whole
    halves = engine.decode(*engine.dense(a), HW)
    assert all(torch.equal(halves[k], kept[k]) for k in kept)


@pytest.mark.parametrize("case", ["chain", "all kept", "all suppressed", "random"])
def test_plain_nms_fixed_rounds_equal_the_converging_loop(case):
    B, K = 2, 130
    if case == "random":
        rng = np.random.RandomState(3)
        xy = rng.rand(B, K, 2) * 60
        boxes = torch.as_tensor(np.concatenate([xy, xy + rng.rand(B, K, 2) * 40 + 1], -1),
                                dtype=torch.float32)
        valid = torch.as_tensor(rng.rand(B, K) > 0.2)
    else:
        boxes, valid = nms_kernel.walk_cases(B, K)[case]
    loop = nms_kernel.nms_mask_sorted_plain(boxes, valid, 0.4)
    fixed = nms_kernel.nms_mask_sorted_plain(boxes, valid, 0.4, fixed_rounds=True)
    assert torch.equal(fixed, loop)
    if case == "chain":  # the deepest case: every round but the last changes the mask
        assert loop[0].tolist() == [i % 2 == 0 for i in range(K)]
