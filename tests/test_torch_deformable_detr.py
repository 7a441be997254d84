# Deformable DETR-R50 (two-stage, box refinement) as the port serves it, on
# the CPU at full width and 160x224 frames (747 tokens over the 4 levels, so
# the two-stage selection keeps 300 of them), with the benchmark's seeded
# weights (benchmark/core/ddetr_weights.py):
#   - ops/msda.py::ms_deform_attn is the bilinear formula written out, zero
#     off the map, exact on pixel centres; on CPU tensors the op
#     lfd::ms_deform_attn is its plain version bit for bit, its fake kernel
#     gives the output's shape and dtype, and the wrapper refuses bad
#     arguments before dispatch (K7 itself: tests/test_torch_cuda.py);
#   - zoo.deformable_detr_r50 builds mmdetection's recipe, its state_dict
#     named as the plain reference's weights;
#   - the eager float32 net selects the plain reference's 300 tokens and
#     gives its class logits and boxes (benchmark/reference/deformable_detr.py);
#   - a frame smaller than the engine's size is masked as the reference
#     masks it;
#   - an uncaptured compile_inference engine serves the reference's top 100
#     rows through the predict API; int8 and thresholds are refused.
# It imports neither jax nor lfdtpu.
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.core import compare, ddetr_weights
from benchmark.reference import deformable_detr as ref
from benchmark.reference.fcos import normalize
from lfdtpu_torch import zoo
from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
from lfdtpu_torch.ops import msda
from lfdtpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_plain, samples_taken

torch.set_num_threads(1)

HW = (160, 224)
TOKENS = 20 * 28 + 10 * 14 + 5 * 7 + 3 * 4  # 747
LOOK = {"blob_px": 64, "grain": 24}
with open(Path(__file__).resolve().parents[1] / "benchmark" / "configs"
          / "deformable_detr_r50.json") as f:
    CFG = json.load(f)
# Both sides run float32 on the CPU by different routes (grid_sample against
# a 4-tap gather, scaled_dot_product_attention against softmax(QK^T)V, a
# top-k against a stable sort), so they agree to float32 round-off carried
# through 6 encoder and 6 decoder layers: logits within 2e-4 of values up
# to about 9, boxes within 1e-5 of [0, 1] (over 5 seeds at most 1.3e-5 and
# 4.8e-7), pixels within 1e-5 of 224 wide, 3e-3.
LOGIT_ATOL, BOX_ATOL, PIXEL_ATOL = 2e-4, 1e-5, 3e-3


@pytest.fixture(scope="module")
def weights():
    return ddetr_weights.draw(CFG, 2 ** 33 + 25, "cpu")


def _detector(w):
    det = zoo.deformable_detr_r50()
    det.net.load_state_dict(w, strict=True)
    det.net.eval()
    return det


def _frames(seed, hw=HW):
    from benchmark.core.weights import frames, generator

    return frames(generator(seed, "cpu"), 1, hw, "cpu", LOOK)


def _preprocess():
    s = CFG["serve"]
    return make_device_preprocess(s["mean"], s["std"], bgr2rgb=s["bgr2rgb"])


def _bilinear_loop(value, shapes, starts, loc, weights):
    """ms_deform_attn written out a sample at a time, float64."""
    v, loc, weights = (t.double().numpy() for t in (value, loc, weights))
    B, _, nh, d = v.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    out = np.zeros((B, Q, nh, d))
    for b, q, h, lvl, p in np.ndindex(B, Q, nh, L, P):
        H, W = shapes[lvl]
        x = loc[b, q, h, lvl, p, 0] * W - 0.5
        y = loc[b, q, h, lvl, p, 1] * H - 0.5
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        for yi in (y0, y0 + 1):
            for xi in (x0, x0 + 1):
                if 0 <= xi < W and 0 <= yi < H:
                    area = (1 - abs(x - xi)) * (1 - abs(y - yi))
                    out[b, q, h] += (weights[b, q, h, lvl, p] * area
                                     * v[b, starts[lvl] + yi * W + xi, h])
    return out.reshape(B, Q, nh * d)


@pytest.mark.parametrize("where", ["anywhere", "pixel_centres"])
def test_ms_deform_attn_is_the_bilinear_formula(where):
    g = torch.Generator().manual_seed(3)
    shapes, starts = [(5, 7), (3, 4)], [0, 35]
    B, Q, nh, d, L, P = 2, 6, 2, 4, 2, 3
    value = torch.randn(B, 47, nh, d, generator=g)
    weights = torch.rand(B, Q, nh, L, P, generator=g)
    if where == "anywhere":  # a third of the samples off the map, some partly
        loc = torch.rand(B, Q, nh, L, P, 2, generator=g) * 1.6 - 0.3
    else:
        sizes = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
        cells = torch.floor(torch.rand(B, Q, nh, L, P, 2, generator=g) * sizes[:, None])
        loc = (cells + 0.5) / sizes[:, None]
    got = ms_deform_attn(value, shapes, starts, loc, weights)  # through lfd::ms_deform_attn
    want = _bilinear_loop(value, shapes, starts, loc, weights)
    assert got.shape == (B, Q, nh * d) and got.dtype == torch.float32
    assert torch.equal(got, ms_deform_attn_plain(value, shapes, starts, loc, weights))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if where == "anywhere":
        off = ((loc < -0.5 / 7) | (loc > 1 + 0.5 / 7)).any(-1).all(-1).all(-1)  # (B, Q, nh)
        assert off.any()
        zeros = torch.zeros_like(value)
        blank = ms_deform_attn(zeros, shapes, starts, loc, weights)
        assert torch.equal(blank, torch.zeros_like(blank))


def _msda_case(dtype=torch.float32, seed=4):
    """A small call: two levels, a third of the samples off the map."""
    g = torch.Generator().manual_seed(seed)
    shapes, starts = [(5, 7), (3, 4)], [0, 35]
    B, Q, nh, d, L, P = 2, 6, 2, 32, 2, 3
    value = torch.randn(B, 47, nh, d, generator=g).to(dtype)
    loc = torch.rand(B, Q, nh, L, P, 2, generator=g) * 1.6 - 0.3
    weights = torch.rand(B, Q, nh, L, P, generator=g)
    return value, shapes, starts, loc, weights


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_op_on_cpu_tensors_is_the_plain_version(dtype):
    value, shapes, starts, loc, weights = _msda_case(dtype)
    flat = [v for hw in shapes for v in hw]
    got = torch.ops.lfd.ms_deform_attn(value, flat, starts, loc, weights)
    want = ms_deform_attn_plain(value, shapes, starts, loc, weights)
    assert got.dtype == dtype and got.is_contiguous() and torch.equal(got, want)
    torch.library.opcheck(torch.ops.lfd.ms_deform_attn.default, (value, flat, starts, loc, weights))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_fake_kernel_gives_the_output_shape_and_dtype(dtype):
    value, shapes, starts, loc, weights = (
        t.to("meta") if isinstance(t, torch.Tensor) else t for t in _msda_case(dtype))
    out = ms_deform_attn(value, shapes, starts, loc, weights)
    assert out.device.type == "meta" and out.shape == (2, 6, 64) and out.dtype == dtype


@pytest.mark.parametrize("bad", ["value not 4-d", "locations' heads", "locations' levels",
                                 "weights' shape", "bf16 locations", "float64 weights",
                                 "a start short", "a level past the map"])
def test_the_wrapper_refuses_bad_arguments_before_dispatch(monkeypatch, bad):
    value, shapes, starts, loc, weights = _msda_case()
    if bad == "value not 4-d":
        value = value.flatten(2)
    elif bad == "locations' heads":
        loc = loc[:, :, :1]
    elif bad == "locations' levels":
        shapes, starts = shapes[:1], starts[:1]
    elif bad == "weights' shape":
        weights = weights[..., :2]
    elif bad == "bf16 locations":
        loc = loc.bfloat16()
    elif bad == "float64 weights":
        weights = weights.double()
    elif bad == "a start short":
        starts = starts[:1]
    else:
        starts = [0, 36]  # the second level's 12 tokens would end past the 47

    def dispatched(*args):
        raise AssertionError("the op was called")

    monkeypatch.setattr(msda, "ms_deform_attn_plain", dispatched)
    before = samples_taken()
    with pytest.raises(ValueError, match="ms_deform_attn"):
        ms_deform_attn(value, shapes, starts, loc, weights)
    assert samples_taken() == before


def test_k7_counts_on_the_wrapper_while_the_attribute_is_replaced(monkeypatch):
    """K7's CUDA kernel ticks ms_deform_attn.launches on the wrapper itself,
    also while the module's attribute is a recorder of the calls (the
    benchmark's engine.msda_ms replays them so): run here on CPU tensors
    with the launch and the device checks stubbed out."""
    import contextlib

    value, shapes, starts, loc, weights = _msda_case()
    launched = []
    monkeypatch.setattr(msda.kernel_lib, "check_cuda", lambda *args: None)
    monkeypatch.setattr(msda.kernel_lib, "stream_of", lambda t: None)
    monkeypatch.setattr(msda.kernel_lib, "launch", lambda name, *args: launched.append(name))
    monkeypatch.setattr(msda.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    wrapper = msda.ms_deform_attn
    monkeypatch.setattr(msda, "ms_deform_attn", lambda *args: wrapper(*args))
    before = wrapper.launches
    out = msda._msda_cuda(value, [v for hw in shapes for v in hw], starts, loc, weights)
    assert launched == ["lfd_ms_deform_attn"] and wrapper.launches == before + 1
    assert out.shape == (2, 6, 64) and out.dtype == value.dtype
    msda._msda_cuda(value, [v for hw in shapes for v in hw], starts, loc[:, :0], weights[:, :0])
    assert wrapper.launches == before + 1  # no queries: no launch


def test_zoo_builds_the_published_recipe():
    det = zoo.deformable_detr_r50()
    assert zoo.ZOO["Deformable-DETR-R50"] is zoo.deformable_detr_r50
    net = det.net
    bb, neck = net._backbone, net._neck
    assert (bb.frozen_stages, bb.norm_eval, bb.out_indices) == (1, True, ((2, 3), (3, 5), (4, 2)))
    assert bb.layer2[0].conv1.stride == (1, 1) and bb.layer2[0].conv2.stride == (2, 2)  # pytorch
    assert neck.num_output_strides_list == [8, 16, 32, 64]
    assert neck.extra0[0].in_channels == 2048 and neck.extra0[0].stride == (2, 2)
    assert len(neck.lateral0) == 2 and neck.lateral0[1].num_groups == 32  # no activation
    assert (len(net.encoder), len(net.decoder), net.num_queries) == (6, 6, 300)
    attn = net.encoder[0].attn
    assert (attn.heads, attn.levels, attn.points) == (8, 4, 4)
    assert attn.sampling_offsets.out_features == 256 and attn.attention_weights.out_features == 128
    assert net.encoder[0].ffn.layers[0].out_features == 1024
    assert len(net.cls_branches) == len(net.reg_branches) == 7
    assert net.cls_branches[0].out_features == 80 and det.max_per_img == 100
    # 23.5 M in the backbone, 17.7 M in the neck and the transformer (the
    # paper's 40 M, two-stage with box refinement)
    assert sum(p.numel() for p in net.parameters()) == 41213836
    assert {n for n, _, _ in ref.param_specs(CFG)} == set(net.state_dict())


def _selected(net, monkeypatch):
    """Record the tokens the net's two-stage selection keeps."""
    kept, real = [], net._select

    def record(*args):
        out = real(*args)
        kept.append(out[0])
        return out

    monkeypatch.setattr(net, "_select", record)
    return kept


@pytest.mark.parametrize("seed", [1, 2])
def test_eager_forward_equals_the_plain_reference(weights, seed, monkeypatch):
    det = _detector(weights)
    x = _frames(seed)
    vhw = torch.tensor([HW], dtype=torch.float32)
    kept = _selected(det.net, monkeypatch)
    before = samples_taken()
    with torch.no_grad():
        cls, boxes = det.net(normalize(x, CFG).permute(0, 2, 3, 1), vhw)
        samples = samples_taken() - before
        rcls, rboxes, rtop = ref.forward(weights, CFG, x)
    # 6 encoder layers with every token a query, 6 decoder layers with 300
    assert samples == 6 * (TOKENS + 300) * 8 * 4 * 4 and rtop.shape == (1, 300)
    # the same 300 tokens; two whose float32 logits differ by round-off may
    # come in either order, and the decoder is equivariant to the queries'
    # order, so each side's queries are compared in the order of their tokens
    order, rorder = kept[0][0].argsort(), rtop[0].argsort()
    assert torch.equal(kept[0][0][order], rtop[0][rorder])
    assert cls.shape == (1, 300, 80) and boxes.shape == (1, 300, 4)
    torch.testing.assert_close(cls[0, order], rcls[0, rorder], rtol=0, atol=LOGIT_ATOL)
    torch.testing.assert_close(boxes[0, order], rboxes[0, rorder], rtol=0, atol=BOX_ATOL)
    # the refinement moves the boxes off the proposals, and the queries score apart
    assert cls.std() > 0.5 and boxes[..., 2:].std() > 0.01


def _engine(det, precision="fp32"):
    return compile_inference(det, HW, precision, preprocess=_preprocess(), device="cpu",
                             captured=False)


def test_a_smaller_frame_is_masked_as_the_reference_masks_it(weights):
    det = _detector(weights)
    engine = _engine(det)
    small = (130, 190)
    frame = _frames(4, small)
    padded = torch.zeros((1, *HW, 3), dtype=torch.uint8)
    padded[0, :small[0], :small[1]] = frame[0]
    vhw = torch.tensor([small], dtype=torch.float32)
    cls, boxes = engine.dense(padded.numpy(), vhw)
    with torch.no_grad():
        rcls, rboxes, _ = ref.forward(weights, CFG, padded, valid_hw=vhw)
        whole, _, _ = ref.forward(weights, CFG, padded)
    torch.testing.assert_close(cls, rcls, rtol=0, atol=LOGIT_ATOL)
    torch.testing.assert_close(boxes, rboxes, rtol=0, atol=BOX_ATOL)
    assert (whole - rcls).abs().max() > 0.1  # the mask matters


def test_an_uncaptured_engine_serves_the_reference_rows(weights):
    det = _detector(weights)
    engine = _engine(det)
    assert not engine.captured and engine.captured_launches is None
    for seed, hw in ((5, HW), (6, (150, 200))):
        frame = _frames(seed, hw)
        rows = det.predict_for_single_image_with_engine(engine, frame[0].numpy())
        padded = torch.zeros((1, *HW, 3), dtype=torch.uint8)
        padded[0, :hw[0], :hw[1]] = frame[0]
        with torch.no_grad():
            rcls, rboxes, _ = ref.forward(weights, CFG, padded,
                                          valid_hw=torch.tensor([hw], dtype=torch.float32))
        want, _ = ref.decode(rcls[0], rboxes[0], hw, CFG, pool=False)
        got, want = np.asarray(rows), np.asarray(compare.decoded_rows(want))
        assert got.shape == want.shape == (100, 6)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4)
        np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0, atol=PIXEL_ATOL)
        assert got[:, 2].min() >= 0 and (got[:, 2] + got[:, 4] - 1).max() <= hw[1]


def test_the_engine_refuses_int8_and_thresholds(weights):
    det = _detector(weights)
    with pytest.raises(ValueError, match="query set"):
        _engine(det, "int8")
    with pytest.raises(ValueError, match="no threshold"):
        compile_inference(det, HW, "fp32", classification_threshold=0.05, device="cpu")
