# K5 (lfd::group_norm_relu, lfdtpu_torch/ops/group_norm.py) and its dispatch
# (deploy/kernel_net.py::attach_kernels) on the CPU, where the op's CPU
# kernel is its plain version:
#   - the plain version and the op equal nn.GroupNorm then nn.ReLU bit for
#     bit, in bf16 and float32, on NHWC maps of the heads' widths;
#   - opcheck (schema, fake tensor, dispatch);
#   - attach_kernels puts K5 in place of exactly the eligible GroupNorm ->
#     ReLU pairs of the head Sequentials, and the net's outputs stay equal;
#     the training net, a mesh engine split over rows (spatial > 1) and
#     GroupNorms K5 does not take stay on ATen;
#   - an engine calls K5 10 times a frame for WIDERFACE-L and 16 for
#     TT100K-L, the counter engine.gn_kernel says so under a profiler, and
#     the benchmark's reader engine.gn_kernel_per_frame.cams reads it.
# The kernel itself is held to the plain version on the card
# (tests/test_torch_cuda.py). This file imports neither jax nor lfdtpu.
import copy

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from lfdtpu_torch import tracing, zoo
from lfdtpu_torch.deploy import (cast_variables, compile_inference, kernel_net,
                                 make_device_preprocess)
from lfdtpu_torch.deploy.kernel_net import FusedGroupNormReLU
from lfdtpu_torch.ops import group_norm
from lfdtpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

HALF = (0.5, 0.5, 0.5)
HW = (64, 96)


def _map(n, h, w, c, dtype, seed=0, offset=0.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, h, w, c, generator=g) * 2 + offset).to(dtype)


def _affine(c, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,w,c,groups", [(1, 17, 30, 128, 16), (2, 9, 13, 128, 16),
                                            (1, 8, 11, 256, 32), (2, 5, 7, 64, 8)])
def test_plain_version_and_op_equal_the_modules(dtype, n, h, w, c, groups):
    x = _map(n, h, w, c, dtype, offset=3.0)
    norm = nn.GroupNorm(groups, c, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(_affine(c)[0])
        norm.bias.copy_(_affine(c)[1])
    norm = norm.to(dtype)
    ref = torch.relu(norm(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    wb = (norm.weight.detach().float(), norm.bias.detach().float())
    plain = group_norm.group_norm_relu_plain(x, *wb, groups, 1e-5)
    op = group_norm.group_norm_relu(x, *wb, groups, 1e-5)
    assert plain.dtype == dtype and plain.is_contiguous()
    assert torch.equal(plain, ref) and torch.equal(op, ref)
    assert group_norm.group_norm_relu.launches == 0  # the CPU runs the plain version


def test_opcheck_k5():
    x = _map(2, 5, 7, 64, torch.float32)
    torch.library.opcheck(torch.ops.lfd.group_norm_relu.default, (x, *_affine(64), 8, 1e-5))


@pytest.mark.parametrize("c,groups,dtype,ok", [
    (128, 16, torch.bfloat16, True), (256, 32, torch.float32, True), (64, 8, torch.float32, True),
    (24, 3, torch.bfloat16, True), (128, 32, torch.bfloat16, False),  # 4 channels a group
    (20, 4, torch.float32, False), (128, 16, torch.float16, False),
    (128, 16, torch.float64, False), (16384, 16, torch.float32, False)])
def test_eligible_shapes(c, groups, dtype, ok):
    assert group_norm.eligible(c, groups, dtype) is ok


@pytest.mark.parametrize("n,hw,sms,want", [
    (1, 272 * 480, 132, 255), (1, 512 * 512, 132, 512), (1, 17 * 30, 132, 1),
    (1, 34 * 60, 132, 4), (4, 512 * 512, 132, 132), (1024, 64 * 64, 132, 1),
    (1, 1, 132, 1)])
def test_slabs_spread_a_map_over_the_sms(n, hw, sms, want):
    assert group_norm.slabs(n, hw, sms) == want


@pytest.mark.parametrize("n,hw,c,want", [
    # FCOS-R50-FPN's towers at 896x1408: P3 to P7 at 256 channels
    (1, 112 * 176, 256, 77), (1, 56 * 88, 256, 20), (1, 28 * 44, 256, 5), (1, 14 * 22, 256, 2),
    (1, 7 * 11, 256, 1), (1, 512 * 512, 1024, 528),
    # up to 128 channels the floor is MIN_SLAB_PIXELS, as LFD's heads have it
    (1, 272 * 480, 128, 255), (1, 272 * 480, 64, 255), (1, 17 * 30, 8, 1)])
def test_slabs_of_a_wider_map_keep_a_thread_s_loads(n, hw, c, want):
    assert group_norm.slabs(n, hw, 132, c) == want


def _detector(name):
    det = {"widerface-L": lambda: zoo.widerface_lfd("L"),
           "tt100k-L": lambda: zoo.tt100k_lfd("L")}[name]()
    det.init(torch.Generator().manual_seed(0))
    return det


def _types(net):
    return [type(m) for m in net.modules()]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attach_routes_exactly_the_head_pairs(dtype):
    det = _detector("widerface-L")
    net = cast_variables(det.net, dtype).to(memory_format=torch.channels_last).eval()
    fused = copy.deepcopy(net)
    kernel_net.attach_kernels(fused)
    norms = [name for name, m in net.named_modules() if isinstance(m, nn.GroupNorm)]
    routed = [name for name, m in fused.named_modules() if isinstance(m, FusedGroupNormReLU)]
    # the shared merge path's two layers: one object under every level's name
    assert routed == norms == ["_head.head0_merge_path.1", "_head.head0_merge_path.4"]
    assert nn.GroupNorm not in _types(fused)
    for name in routed:  # the ReLU after each is an Identity, and the names stay
        seq, i = name.rsplit(".", 1)
        assert isinstance(fused.get_submodule(seq)[int(i) + 1], nn.Identity)
    assert [n for n, _ in fused.named_modules()] == [n for n, _ in net.named_modules()]
    assert fused._head.head0_merge_path is fused._head.head4_merge_path
    x = _map(1, *HW, 3, dtype)
    with torch.inference_mode():
        for a, b in zip(net(x), fused(x)):
            assert torch.equal(a, b)


def test_attach_leaves_what_k5_does_not_take():
    seq = nn.Sequential(nn.GroupNorm(4, 20), nn.ReLU(),           # 5 channels a group
                        nn.GroupNorm(2, 16), nn.Sigmoid(),        # no ReLU after it
                        nn.GroupNorm(2, 16, affine=False), nn.ReLU(),
                        nn.GroupNorm(2, 16).half(), nn.ReLU(),    # float16
                        nn.GroupNorm(2, 16), nn.ReLU())           # taken
    kernel_net.attach_kernels(seq)
    assert [type(m).__name__ for m in seq] == [
        "GroupNorm", "ReLU", "GroupNorm", "Sigmoid", "GroupNorm", "ReLU", "GroupNorm", "ReLU",
        "FusedGroupNormReLU", "Identity"]
    seq2 = nn.Sequential(nn.GroupNorm(2, 16), nn.ReLU())
    kernel_net.attach_kernels(seq2, group_norms=False)
    assert [type(m).__name__ for m in seq2] == ["GroupNorm", "ReLU"]


def _count_calls(monkeypatch):
    """Count the dispatch's K5 calls, and tick the wrapper's launch counter
    as the CUDA kernel does (the CPU runs the plain version)."""
    calls = []
    real = kernel_net.group_norm_relu

    def counted(*args):
        calls.append(1)
        group_norm.group_norm_relu.launches += 1
        return real(*args)

    monkeypatch.setattr(kernel_net, "group_norm_relu", counted)
    monkeypatch.setattr(group_norm.group_norm_relu, "launches", 0)
    return calls


def _engine(det, precision="bf16", **kw):
    return compile_inference(det, HW, precision, device="cpu",
                             preprocess=make_device_preprocess(HALF, HALF),
                             classification_threshold=0.01, **kw)


@pytest.mark.parametrize("name,precision,want", [
    ("widerface-L", "bf16", 10), ("widerface-L", "int8", 10), ("tt100k-L", "bf16", 16),
    ("tt100k-L", "fp32", 16)])
def test_an_engine_frame_calls_k5_per_head_layer_and_level(monkeypatch, name, precision, want):
    """WIDERFACE-L: 5 levels x the merged path's 2 layers; TT100K-L: 4 levels
    x 2 paths x 2 layers; the int8 engine's float head too. The training
    net (the detector's) keeps its GroupNorms."""
    det = _detector(name)
    before = _types(det.net)
    assert kernel_net.group_norm_calls(det.net) == want
    calls = _count_calls(monkeypatch)
    engine = _engine(det, precision)
    assert _types(det.net) == before and FusedGroupNormReLU not in before
    frame = np.random.RandomState(4).randint(0, 255, (1, *HW, 3)).astype(np.uint8)
    calls.clear()
    engine(frame, HW)
    assert len(calls) == want


def test_a_mesh_engine_split_over_rows_keeps_its_group_norms(monkeypatch):
    """compile_inference over a mesh with a spatial axis hands
    spatial_parallel a net whose GroupNorms are nn.GroupNorm (its swap takes
    the moments across ranks); a mesh without one routes them to K5."""
    from lfdtpu_torch.deploy import compile as compile_mod

    handed = []
    monkeypatch.setattr(compile_mod, "spatial_parallel",
                        lambda net, mesh, height: handed.append(net) or net)
    det = _detector("widerface-L")
    dev = torch.device("cpu")
    compile_inference(det, HW, "bf16", mesh=Mesh(size=1, rank=0, device=dev, spatial=2),
                      preprocess=make_device_preprocess(HALF, HALF))
    (net,) = handed
    assert nn.GroupNorm in _types(net) and FusedGroupNormReLU not in _types(net)
    engine = compile_inference(det, HW, "bf16", mesh=Mesh(size=2, rank=0, device=dev),
                               batch_size=2, preprocess=make_device_preprocess(HALF, HALF))
    assert len(handed) == 1
    assert nn.GroupNorm not in _types(engine.net) and FusedGroupNormReLU in _types(engine.net)


@pytest.mark.parametrize("name,want", [("widerface-L", 10), ("tt100k-L", 16)])
def test_the_counter_and_its_reader_give_k5_launches_per_frame(monkeypatch, name, want):
    from benchmark.core import spec

    det = _detector(name)
    engine = _engine(det)
    _count_calls(monkeypatch)
    frame = np.random.RandomState(5).randint(0, 255, (*HW, 3)).astype(np.uint8)
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                det.predict_for_single_image_with_engine(engine, frame)
        assert tracing.summary()["counters"]["engine.gn_kernel"] == 3 * want
        assert spec.reader("engine.gn_kernel_per_frame.cams").read({}) == want
    finally:
        tracing.reset()

