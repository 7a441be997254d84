# FCOS-R50-FPN as the port serves it, on the CPU at full width and 256x384
# frames, with seeded weights (the benchmark's draw, calibrated so that the
# decode has hundreds of candidates):
#   - zoo.fcos_r50_fpn builds mmdetection's fcos_r50_caffe_fpn_gn-head_1x
#     recipe, and chip_smoke builds through it;
#   - its dense outputs and rows equal the plain reference's
#     (benchmark/reference/fcos.py) at float32: the same operations on the
#     CPU, so bit for bit;
#   - an uncaptured compile_inference engine serves the rows of the eager
#     predict_for_single_image (the centerness reaches the engine's decode);
#     K5 takes the towers' 8 GroupNorm -> ReLU pairs, 40 calls a frame;
#   - the engine's decode halves take the three outputs;
#   - the counter engine.nms_candidates; int8 on a three-output net raises;
#   - an LFD engine's outputs are lfdtpu's, with the candidate count beside.
# It imports lfdtpu only inside the LFD test.
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.core import compare, fcos_weights
from benchmark.reference import fcos
from lfdtpu_torch import tracing, zoo
from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
from lfdtpu_torch.deploy.kernel_net import FusedGroupNormReLU, group_norm_calls
from lfdtpu_torch.ops.decode import detections_to_lists

torch.set_num_threads(1)

HW = (256, 384)
LOOK = {"blob_px": 64, "grain": 24}
with open(Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "fcos_r50_fpn.json") as f:
    CFG = json.load(f)
CFG["weights"].update(calibration_hw=list(HW), candidates=400)


@pytest.fixture(scope="module")
def weights():
    return fcos_weights.draw(CFG, 2 ** 33 + 21, "cpu", LOOK)


def _detector(w):
    det = zoo.fcos_r50_fpn()
    det.net.load_state_dict(w, strict=True)
    det.net.eval()
    return det


def _frames(seed, n=1):
    from benchmark.core.weights import frames, generator

    return frames(generator(seed, "cpu"), n, HW, "cpu", LOOK).numpy()


def _preprocess():
    s = CFG["serve"]
    return make_device_preprocess(s["mean"], s["std"])


def _engine(det, precision="fp32", **kw):
    return compile_inference(det, HW, precision, preprocess=_preprocess(), device="cpu", **kw)


def test_zoo_builds_the_published_recipe():
    import chip_smoke

    det = zoo.fcos_r50_fpn()
    assert zoo.ZOO["FCOS-R50-FPN"] is zoo.fcos_r50_fpn
    bb, neck, head = det.net._backbone, det.net._neck, det.net._head
    assert (bb.frozen_stages, bb.norm_eval, bb.out_indices) == (1, True, ((2, 3), (3, 5), (4, 2)))
    assert bb.layer2[0].conv1.stride == (2, 2) and bb.layer2[0].conv2.stride == (1, 1)  # caffe
    assert bb.num_output_channels_list == [512, 1024, 2048]
    assert neck.num_output_strides_list == [8, 16, 32, 64, 128] and neck.relu_before_extra
    assert not neck.extra_on_input and neck.fpn_out0.out_channels == 256
    gn = head._classification_path[1]
    assert (gn.num_groups, gn.num_channels, len(head._classification_path)) == (32, 256, 12)
    assert head._classification.out_channels == 80 and head._centerness.out_channels == 1
    assert (det.classification_threshold, det.nms_threshold, det.pre_nms_bbox_limit,
            det.post_nms_bbox_limit) == (0.05, 0.5, 1000, 100)
    assert type(det.classification_loss_func).__name__ == "FocalLoss"
    assert sum(p.numel() for p in det.net.parameters()) == 32295322
    smoke = chip_smoke.fcos_r50_fpn("cpu")
    assert {k: v.shape for k, v in smoke.net.state_dict().items()} == \
        {k: v.shape for k, v in det.net.state_dict().items()}
    assert {n for n, _, _ in fcos.param_specs(CFG)} == set(det.net.state_dict())


@pytest.mark.parametrize("seed", [1, 2])
def test_dense_outputs_and_rows_equal_the_plain_reference(weights, seed):
    det = _detector(weights)
    engine = _engine(det)
    x = _frames(seed)
    got = engine.dense(x)
    with torch.no_grad():
        ref = fcos.forward(weights, CFG, torch.as_tensor(x))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    vhw = (250, 380)  # the predict API pads the frame with zeros, as the reference here
    padded = np.zeros_like(x)
    padded[0, :vhw[0], :vhw[1]] = x[0, :vhw[0], :vhw[1]]
    rows = det.predict_for_single_image_with_engine(engine, x[0][:vhw[0], :vhw[1]])
    with torch.no_grad():
        ref = fcos.forward(weights, CFG, torch.as_tensor(padded))
    info = fcos.level_info(CFG, HW)
    want, _ = fcos.decode(ref[0][0], ref[1][0], ref[2][0], info, vhw, CFG, pool=0)
    # bit for bit, but the width and height, which the predict API takes
    # in float32 and the reference's rows in float64
    ref_rows = np.asarray(compare.decoded_rows(want))
    got_rows = np.asarray(rows)
    assert len(rows) > 10 and got_rows.shape == ref_rows.shape
    np.testing.assert_array_equal(got_rows[:, :4], ref_rows[:, :4])
    np.testing.assert_allclose(got_rows[:, 4:], ref_rows[:, 4:], rtol=0, atol=1e-4)


def test_an_uncaptured_engine_serves_the_eager_rows(weights):
    det = _detector(weights)
    engine = _engine(det)
    assert not engine.captured and engine.captured_launches is None
    # K5 on the towers' pairs: 4 a tower, at each of the 5 levels
    assert sum(isinstance(m, FusedGroupNormReLU) for m in engine.net.modules()) == 8
    assert group_norm_calls(det.net) == 40
    pre = _preprocess()
    norm = dict(mean=pre.mean.numpy(), std=pre.std.numpy())
    for seed in (3, 4):
        frame = _frames(seed)[0]
        eager = det.predict_for_single_image(
            frame, aug_pipeline=lambda s: {"image": (s["image"].astype(np.float32)
                                                     - norm["mean"]) / norm["std"]})
        served = det.predict_for_single_image_with_engine(engine, frame)
        # the same rows; the engine's channels_last convs and K5's plain
        # GroupNorm round the last places otherwise than the eager net's
        assert len(served) == len(eager) > 10
        s, e = np.asarray(served), np.asarray(eager)
        np.testing.assert_array_equal(s[:, 0], e[:, 0])
        np.testing.assert_allclose(s[:, 1], e[:, 1], rtol=1e-4)
        np.testing.assert_allclose(s[:, 2:], e[:, 2:], rtol=1e-4, atol=1e-3)


def test_the_engine_halves_take_the_centerness(weights):
    det = _detector(weights)
    engine = _engine(det)
    x = _frames(5)
    dense = engine.dense(x)
    assert len(dense) == 3 and dense[2].shape[-1] == 1
    whole, halves = engine(x, HW), engine.decode(*dense, HW)
    assert int(whole["count"][0]) > 0 and all(torch.equal(whole[k], halves[k]) for k in whole)
    plain = copy.copy(det)
    plain._score_factors = lambda outputs: None  # scores without the centerness
    without = plain.decode_batch(tuple(o.float() for o in dense), HW,
                                 torch.tensor([HW], dtype=torch.float32), engine.spec)
    assert not torch.equal(without["scores"], whole["scores"])


def test_the_counter_counts_the_candidates_that_enter_nms(weights):
    det = _detector(weights)
    engine = _engine(det)
    frames = _frames(6, 2)
    want = sum(int(engine(f[None], HW)["candidates"][0]) for f in frames)
    assert 0 < want <= 2 * det.decode_spec().nms_budget
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        rows = [det.predict_for_single_image_with_engine(engine, f) for f in frames]
    counters = tracing.summary()["counters"]
    tracing.reset()
    assert counters["engine.nms_candidates"] == want
    assert counters["predict.rows"] == sum(len(r) for r in rows)


def test_int8_refuses_a_three_output_net(weights):
    with pytest.raises(ValueError, match="two dense outputs"):
        _engine(_detector(weights), "int8")


def test_an_lfd_engine_gives_lfdtpu_s_outputs_and_the_candidate_count():
    from lfdtpu.deploy import compile_inference as jax_compile
    from lfdtpu.deploy import make_device_preprocess as jax_preprocess
    from tests.test_torch_int8 import _tiny_pair

    jdet, variables, tdet = _tiny_pair()
    half = (0.5, 0.5, 0.5)
    kw = dict(classification_threshold=0.01)
    engine = compile_inference(tdet, (64, 64), "fp32", preprocess=make_device_preprocess(
        half, half), device="cpu", **kw)
    jengine = jax_compile(jdet, variables, (64, 64), "fp32", preprocess=jax_preprocess(half, half),
                          **kw)
    img = np.random.RandomState(3).randint(0, 255, (1, 64, 64, 3)).astype(np.uint8)
    vhw = np.asarray([64, 64], np.float32)
    got = {k: v.numpy() for k, v in engine(img, vhw).items()}
    ref = {k: np.asarray(v) for k, v in jengine(img, vhw).items()}
    assert set(got) == set(ref) | {"candidates"}
    n = int(ref["count"][0])
    assert n > 0 and int(got["count"][0]) == n
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-4, atol=1e-6)
    assert got["candidates"].dtype == np.int32 and n <= int(got["candidates"][0]) <= 1000
    assert detections_to_lists({k: v[0] for k, v in got.items()}) == \
        tdet.predict_for_single_image_with_engine(engine, img[0])
