# The hand-written kernels as torch.library custom ops (lfd::nms_mask_sorted,
# lfd::stem_conv, lfd::pair_conv3x3, lfd::int8_conv, lfd::group_norm_relu,
# and the plain NMS as lfd::nms_mask_sorted_plain) on the CPU, where each
# op's CPU kernel is its plain version: torch.library.opcheck at small shapes
# (the schema, the fake tensor each op's register_fake gives, and dispatch;
# K5's in tests/test_torch_group_norm.py), and the exported program of an
# engine, which calls one torch.ops.lfd node for each kernel its switches
# (and, for K5, its head) turn on, as often as the engine launches it a frame.
import numpy as np
import pytest
import torch

from lfdtpu_torch import zoo
from lfdtpu_torch.deploy import compile_inference, load_engine, make_device_preprocess
from lfdtpu_torch.deploy.engine_io import export_engine, lfd_ops, save_engine
from lfdtpu_torch.deploy.kernel_net import eligible_faster_block, group_norm_calls
from lfdtpu_torch.ops import conv_kernels, int8_conv, nms_kernel
from lfdtpu_torch.ops.int8_conv import pack_int8_weight, packed_width, quantize_weights

torch.set_num_threads(1)

HALF = (0.5, 0.5, 0.5)


def _nms_args(seed=0, B=2, K=40):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(B, K, 2, generator=g) * 50
    wh = torch.rand(B, K, 2, generator=g) * 20 + 1
    boxes = torch.cat([xy, xy + wh], -1)
    valid = torch.rand(B, K, generator=g) > 0.2
    return boxes, valid, 0.4


@pytest.mark.parametrize("op", ["nms_mask_sorted", "nms_mask_sorted_plain"])
def test_opcheck_k1(op):
    args = _nms_args()
    torch.library.opcheck(getattr(torch.ops.lfd, op).default, args)
    assert torch.equal(getattr(torch.ops.lfd, op)(*args),
                       nms_kernel.nms_mask_sorted_plain(*args))


def test_opcheck_k2():
    g = torch.Generator().manual_seed(1)
    frame = torch.randint(0, 256, (2, 9, 10, 3), dtype=torch.uint8, generator=g)
    args = (frame, torch.randn(3, 3, 3, 64, generator=g), torch.tensor([120.0, 110.0, 100.0]),
            torch.tensor([60.0, 55.0, 70.0]), torch.rand(64, generator=g) + 0.5,
            torch.randn(64, generator=g), True)
    torch.library.opcheck(torch.ops.lfd.stem_conv.default, args)
    out = conv_kernels.stem_conv(*args)
    assert out.shape == (2, 5, 5, 64) and out.dtype == torch.bfloat16
    assert torch.equal(out, conv_kernels.stem_conv_plain(*args))


@pytest.mark.parametrize("residual", [False, True])
def test_opcheck_k3(residual):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 6, 5, 64, generator=g).to(torch.bfloat16)
    res = torch.randn(1, 6, 5, 64, generator=g).to(torch.bfloat16) if residual else None
    args = (x, (torch.randn(3, 3, 64, 64, generator=g) * 0.05).to(torch.bfloat16),
            torch.rand(64, generator=g) + 0.5, torch.randn(64, generator=g), res, True)
    torch.library.opcheck(torch.ops.lfd.pair_conv3x3.default, args)
    assert torch.equal(conv_kernels.pair_conv3x3(*args), conv_kernels.pair_conv3x3_plain(*args))


@pytest.mark.parametrize("cin,cout,k,stride,mode", [
    (3, 32, 3, 2, "int8"), (32, 32, 1, 1, "float"), (32, 32, 3, 1, "int8 residual"),
    (32, 64, 3, 2, "float residual")])
def test_opcheck_k4(cin, cout, k, stride, mode):
    g = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (1, 9, 11, cin), dtype=torch.int8, generator=g)
    q, _ = quantize_weights(torch.randn(cout, cin, k, k, generator=g))
    wpack = pack_int8_weight(q)
    assert wpack.shape == (cout, packed_width(cin, k))
    ho, wo = int8_conv.out_hw(9, 11, k, stride)
    kw = dict(relu=True, out_scale=0.05 if "int8" in mode else None)
    if mode == "int8 residual":
        kw.update(residual=torch.randint(-127, 128, (1, ho, wo, cout), dtype=torch.int8,
                                         generator=g), residual_scale=0.03)
    elif mode == "float residual":
        kw["residual"] = torch.randn(1, ho, wo, cout, generator=g)
    mult, bias = torch.rand(cout, generator=g) * 1e-3, torch.randn(cout, generator=g)
    args = (x, wpack, mult, bias, k, stride, kw["relu"], kw["out_scale"], kw.get("residual"),
            kw.get("residual_scale"))
    torch.library.opcheck(torch.ops.lfd.int8_conv.default, args)
    out = int8_conv.int8_conv(x, wpack, mult, bias, k, stride, **kw)
    assert out.shape == (1, ho, wo, cout)
    assert out.dtype == (torch.int8 if kw["out_scale"] else torch.float32)
    assert torch.equal(out, int8_conv.int8_conv_plain(x, wpack, mult, bias, k, stride, **kw))


def _engine(precision, size="L", **kw):
    det = zoo.widerface_lfd(size)
    det.init(torch.Generator().manual_seed(0))
    return det, compile_inference(det, (64, 64), precision, device="cpu",
                                  preprocess=make_device_preprocess(HALF, HALF),
                                  classification_threshold=0.01, **kw)


@pytest.mark.parametrize("variant", ["fp32", "bf16_kernels", "plain_nms", "int8"])
def test_engine_program_calls_each_switched_kernel(variant):
    switches = {"fp32": ("fp32", {}),
                "bf16_kernels": ("bf16", dict(kernel_convs=True, kernel_stem=True)),
                "plain_nms": ("fp32", dict(nms_use_kernel=False)),
                "int8": ("int8", {})}[variant]
    det, engine = _engine(switches[0], **switches[1])
    ops = lfd_ops(export_engine(engine))
    want = {"lfd::nms_mask_sorted": 1, "lfd::group_norm_relu": group_norm_calls(det.net)}
    assert want["lfd::group_norm_relu"] == 10  # every engine: 5 levels x 2 head layers
    if variant == "bf16_kernels":
        want["lfd::stem_conv"] = 1
        want["lfd::pair_conv3x3"] = 2 * sum(map(eligible_faster_block, det.net.modules()))
        assert want["lfd::pair_conv3x3"] > 0
    if variant == "plain_nms":
        del want["lfd::nms_mask_sorted"]
        want["lfd::nms_mask_sorted_plain"] = 1
    if variant == "int8":
        want["lfd::int8_conv"] = len(engine.int8_chain.units)
    assert ops == dict(sorted(want.items()))


def test_plain_nms_engine_round_trips(tmp_path):
    """An engine built with nms_use_kernel=False exports (lfdtpu serializes
    its nms_use_pallas=False engine): the plain NMS is an op of its own, and
    the loaded engine gives the built one's detections bit for bit."""
    _, engine = _engine("fp32", size="XS", nms_use_kernel=False)
    path = str(tmp_path / "plain.lfde")
    save_engine(engine, path)
    loaded = load_engine(path, device="cpu")
    img = np.random.RandomState(4).randint(0, 255, (1, 64, 64, 3)).astype(np.uint8)
    ref, got = engine(img, (64, 64)), loaded(img, (64, 64))
    assert int(ref["count"][0]) > 0
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
